// Per-edge messages of the edge-conditioned conv, without the scatter, in
// float32 on Hopper's tensor cores (wgmma, sm_90a), exact to float32 through
// split bf16 operands.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/pallas_mp.py:fused_edge_messages
// and computes the same function, float32 in and float32 out:
//
//   W_e[i, o] = sum_k h[e, k] w3[k, i*c_out + o] + b3[i*c_out + o]
//   out[e, o] = sum_i x_src[e, i] W_e[i, o]
//
// Factored form.  With W~_k = w3[k] seen as [c_in, c_out], W~_K = b3 and
// h~[e, K] = 1, a 64-edge tile X = x_src[e0 .. e0 + 63] gives
//
//   out = sum_{k <= K} h~[:, k] * (X @ W~_k)        (a row scaling per k)
//
// so the tensor cores see only X and W~_k, never a rounding of h W3; the
// weighting by h~ and the sum over k run on the CUDA cores in float32.
//
// This is the float32 B1 (fused_edge_conv_f32_wgmma.cu) without its gather
// and its scatter, and it runs on B1's pieces (f32_wgmma.cuh): X and every
// W~_k split exactly into three bf16 parts (split3), per k one float32
// accumulator summing the six products of order >= 2^-16 smallest first,
// over depth c_in; W~'s parts laid out once per call by a first launch as
// the stage image (stage_image, by output; ops/pallas_mp.py:stage_image is
// its plain version), streamed by one producer thread (cp.async.bulk onto
// mbarriers) into a 4-stage ring (ring_init, produce) and, up to a c_in of
// 128, walked in runs of four stages, two products in flight, all waited
// for by a run's end (Walk: ptxas serializes every wgmma of a loop that
// carries one in flight across its back edge); past it in stages of 32
// deep (DeepWalk).
//
// Widths.  c_in, c_out and K 1..256: c_out (rounded up to 8) is cut into
// B1's column chunks (Chunks: one chunk up to 64 columns, past that chunks
// of at most 64, or 32 where c_in is 65..128), and a tile walks the K+1
// stages once per chunk; each pass writes its columns of [E, c_out]
// straight out.  The layout is chosen by c_in and K:
//  - c_in up to 128: X's parts live in registers across the passes, 12
//    registers per 16 of c_in (96 at 128), an accumulator N / 2; two
//    consumer warpgroups per block.
//  - c_in past 128: X's parts would take 192 registers at 256.  They are
//    split once per tile into shared memory (put_split8, 96 KB at 256,
//    fenced before the first product) and the walk is DeepWalk, each W~_k
//    of a chunk in c_in / 32 stages of 32 deep (12 KB at N 64); one
//    consumer warpgroup per block (two would need 192 KB for A alone), as
//    the float32 B1 past 128.
//  - K up to 128: each consumer keeps two h tiles [64][(K+1)|1] (the
//    current one and the next one, copied by cp.async meanwhile).  Past
//    128 a tile takes 66 KB, so each consumer keeps one, refilled once
//    the tile's walk is done (while the next tile's X is loaded).
// Shared memory (Layout): at most 225 KB up to widths and K of 128 (a
// 24 KB stage, two consumers, two h tiles each); K 256 at c_in 48 and
// c_out 200 192 KB (stages of 16 KB, two consumers, one h tile each), at
// c_in 65..128 225 KB; K 128 at c_in = c_out = 256 209 KB (A 96 KB, a 48 KB
// ring, two h tiles of one consumer); K = c_in = c_out = 256 208 KB (one
// h tile).  One block per SM.
//
// What B5 keeps beside B1's design.
//  - X's rows are contiguous (no gather): each thread loads its fragment's
//    values (past 128: 8 consecutive values of a row) straight from x_src
//    once per tile; rows past E are zeros.
//  - Up to a c_in of 128 two consumer warpgroups per block, a 64-edge tile
//    each, share every stage: half the L2 reads of one warpgroup per
//    block.  Nine warps put three on one of the SM's four register files,
//    so a thread holds at most 168 registers: past a depth of 64 (X's
//    parts alone 60-96) ptxas spills, up to 504 bytes a thread at c_in =
//    c_out = 128.  A block of one consumer, as B1's (one warpgroup and the
//    producer warp: 255 registers, no spills), ran slower there in a trial
//    on the card, so every depth up to 128 keeps two.
//  - The grid is persistent (as many blocks as fit, each walking groups of
//    one tile per consumer), so the ring streams on from one tile to the
//    next.
//  - h is staged per tile in shared memory (column K all ones).
//  - No scatter: each output is written once, straight to [E, c_out]; no
//    atomics, so two launches give the same bits.  A ragged last tile
//    leaves its h rows past E as they were: no sum runs across rows.
//
// Bound.  Per edge 2 (K+1) c_in c_out operations against (K + c_in +
// c_out) 4 bytes: far above the ridge, so operations bound it.  Float32
// FMAs at 67 TFLOP/s, or six bf16 passes at 989 TFLOP/s: the tensor cores'
// bound is the lesser, 6 / 989 of the work's flops per second against 1 /
// 67.  At E 258 048: 0.354 ms at K 48, width 48; 6.62 ms at K = c_in =
// c_out = 128; 52.7 ms at 256 (26.5 at K 128).  What stands in the way: a
// fixed cost per k of each tile (the ring's barriers, issuing and waiting
// for the products, the weighting), which a run of products hides only in
// part (past a c_in of 128 not at all: DeepWalk waits for each stage's
// products); each tile's x is loaded before its products start.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_messages_wgmma.so
//        fused_edge_messages_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_wgmma.cuh"

namespace {

using namespace f32_wgmma;

constexpr int kMaxK = 256;
constexpr int kMaxC = 256;
constexpr int kTile = 64;  // edges per consumer warpgroup's tile

// Consumer warpgroups per block, and the block's threads (+ a producer
// warp), of the instance of depth steps S: two with X's parts in
// registers, one past a c_in of 128 (S = kDeepA, A's parts in shared
// memory).
template <int S>
constexpr int kConsumers = S == kDeepA ? 1 : 2;
template <int S>
constexpr int kThreads = kConsumers<S> * kWarpgroup + 32;

// Byte offsets of the shared memory: the 2 kRing mbarriers, the ring of
// stages ([3][n][sd] bf16 each, n a chunk's columns, sd the stage's
// depth), past a c_in of 128 X's parts [3][64][dp] bf16, then each
// consumer's hbufs h tiles [64][hstride] (float32, column K all ones; an
// odd stride, so the 8 rows a warp reads at once sit in 8 banks): two up
// to a K of 128 (the current tile's and the next one's, on its way), one
// past it.  The header gives the totals.
struct Layout {
  Chunks ch;
  int consumers, hbufs, hstride;
  long stage, ring, a, hs, total;
  __host__ __device__ Layout(int K, int c_in, int c_out) : ch(c_out, c_in) {
    consumers = ch.deep ? 1 : 2;
    hbufs = K <= kWalkDepth ? 2 : 1;
    hstride = (K + 1) | 1;
    stage = 3 * 2L * ch.n * ch.sd;
    ring = 128;
    a = ring + kRing * stage;
    hs = a + (ch.deep ? 3 * 2L * kTile * ch.dp : 0);
    total = hs + 4L * hbufs * consumers * kTile * hstride;
  }
};

// N = a chunk's columns of c_out (Chunks), S = c_in rounded up to 16, over
// 16, or kDeepA past a c_in of 128.
template <int N, int S>
__global__ void __launch_bounds__(kThreads<S>, 1)
messages_wgmma(const float* __restrict__ h, const float* __restrict__ x_src,
               const bf16* __restrict__ image, float* __restrict__ out,
               long num_edges, int K, int c_in, int c_out) {
  constexpr bool kDeep = S == kDeepA;
  constexpr int kCons = kConsumers<S>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(K, c_in, c_out);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const long tiles = (num_edges + kTile - 1) / kTile;
  const long groups = (tiles + kCons - 1) / kCons;
  const int wg = threadIdx.x / kWarpgroup;
  const int chunks = L.ch.chunks;
  const int stages = chunks * (K + 1) * L.ch.slices;

  if (threadIdx.x == 0) ring_init(full, empty, 4 * kCons);
  __syncthreads();

  // ---- producer: the chunks x (K + 1) x slices stages of every group of
  // tiles ----
  if (wg == kCons) {
    if (threadIdx.x % 32 == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(image);
      uint32_t j = 0;
      for (long g = blockIdx.x; g < groups; g += gridDim.x)
        produce(full, empty, ring, src, static_cast<uint32_t>(L.stage),
                stages - 1, j);
    }
    return;
  }

  // ---- consumers ----
  const int t = threadIdx.x % kWarpgroup;
  const int lane = t % 32;
  const int r0 = a_row(0);  // this thread's rows: r0 and r0 + 8
  const int hstride = L.hstride;
  const bool two = L.hbufs == 2;
  float* hbuf = reinterpret_cast<float*>(smem + L.hs) +
                L.hbufs * wg * kTile * hstride;  // this warpgroup's h tiles
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  for (int s = t; s < L.hbufs * kTile; s += kWarpgroup)
    hbuf[s * hstride + K] = 1.f;
  const uint64_t d0 = desc(ring, L.ch.sd);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = dstage / 3;
  uint32_t j = 0;  // the ring's step, counted as the producer counts it
  int buf = 0;     // the h tile of this warpgroup's current tile

  // the first edge of this warpgroup's tile of group g, and its edges (0
  // past the end)
  auto first = [&](long g) { return (g * kCons + wg) * kTile; };
  auto edges = [&](long g) {
    const long e0 = first(g);
    return e0 < num_edges ? static_cast<int>(min(static_cast<long>(kTile),
                                                 num_edges - e0))
                          : 0;
  };
  if (blockIdx.x < groups && edges(blockIdx.x) > 0)
    prefetch_h(hbuf, h, first(blockIdx.x), K, hstride, edges(blockIdx.x));

  for (long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long e0 = first(g);
    const int n = edges(g);
    if (n == 0) {  // no tile for this warpgroup: pass the stages on
      for (int s = 0; s < stages; ++s, ++j) {
        mbar_wait(full + slot(j), parity(j));
        if (lane == 0) mbar_arrive(empty + slot(j));
      }
      continue;
    }

    // X's parts: x_src's rows e0 .. at this thread's fragment rows and
    // columns (past a c_in of 128: all of X's, split into shared memory;
    // the last tile's products are complete, as is every thread's walk)
    uint32_t xa[3][kDeep ? 1 : S][4];
    if constexpr (kDeep) {
      const int per = L.ch.dp / 8;
      for (int p = t; p < kTile * per; p += kWarpgroup) {
        const int s = p / per, d = 8 * (p - s * per);
        const float* xr = x_src + (e0 + s) * c_in;
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = s < n && d + u < c_in ? xr[d + u] : 0.f;
        put_split8(a_sm, L.ch.dp, s, d, v);
      }
      fence_async_smem();
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = a_row(2 * u), col = 16 * s + a_col(2 * u);
          float a = 0.f, b = 0.f;
          if (row < n) {
            const float* xr = x_src + (e0 + row) * c_in;
            if (col < c_in) a = xr[col];
            if (col + 1 < c_in) b = xr[col + 1];
          }
          split3(a, b, xa[0][s][u], xa[1][s][u], xa[2][s][u]);
        }
    }
    cp_async_wait_all();
    warpgroup_sync(wg);  // the tile's h (and X's parts) have landed, and
                         // every thread is done with the other h tile
    const float* hs = hbuf + buf * kTile * hstride;
    const long next = g + gridDim.x;
    const bool more = next < groups && edges(next) > 0;
    if (two) {
      if (more)
        prefetch_h(hbuf + (buf ^ 1) * kTile * hstride, h, first(next), K,
                   hstride, edges(next));
      buf ^= 1;
    }

    // ---- per chunk c: m = sum_k h~[:, k] P_k, P_k = X @ W~_k at the
    // chunk's columns, written to out's columns c N .. ----
    float m[N / 2];
    auto weight = [&](const float (&p)[N / 2], int k) {
      const float ha = hs[r0 * hstride + k];
      const float hb = hs[(r0 + 8) * hstride + k];
#pragma unroll
      for (int v = 0; v < N / 2; ++v)
        m[v] = fmaf((v & 2) ? hb : ha, p[v], m[v]);
    };
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int v = 0; v < N / 2; ++v) m[v] = 0.f;
      if constexpr (kDeep) {
        const uint32_t dapart = static_cast<uint32_t>(2 * kTile * L.ch.dp >> 4);
        const DeepWalk<N, decltype(weight)> walk{
            desc(a_sm, L.ch.dp), dapart, L.ch.slices, full, empty, d0,
            dstage, dpart, lane, weight};
        walk.all(K + 1, j);
      } else {
        const Walk<N, S, decltype(weight)> walk{xa, full, empty, d0, dstage,
                                                dpart, lane, weight};
        walk.all(K, j);
      }
#pragma unroll
      for (int v = 0; v < N / 2; ++v) {
        const int row = acc_row(v), col = c * N + acc_col(v);
        if (row < n && col < c_out) out[(e0 + row) * c_out + col] = m[v];
      }
    }
    // one h tile (past a K of 128), or A's parts in shared memory: the next
    // tile's may replace them once every thread is done with this one's
    if (kDeep || !two) {
      warpgroup_sync(wg);
      if (!two && more)
        prefetch_h(hbuf, h, first(next), K, hstride, edges(next));
    }
  }
}

// Blocks of the instance (N, S) one SM holds at once (-1 if refused).
template <int N, int S>
int blocks(const Layout& L) {
  return blocks_on_sm(messages_wgmma<N, S>, kThreads<S>,
                      static_cast<size_t>(L.total));
}

template <int N, int S>
cudaError_t launch(const float* h, const float* x_src, const float* w3,
                   const float* b3, bf16* image, float* out, long num_edges,
                   int K, int c_in, int c_out, cudaStream_t stream) {
  const Layout L(K, c_in, c_out);
  const size_t smem = static_cast<size_t>(L.total);
  const int per_sm = blocks<N, S>(L);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = launch_image(w3, b3, image, K, c_in, c_out, L.ch, true, stream);
  if (err != cudaSuccess) return err;
  const long tiles = (num_edges + kTile - 1) / kTile;
  const long groups = (tiles + kConsumers<S> - 1) / kConsumers<S>;
  const long most = static_cast<long>(sms) * per_sm;
  const long grid = groups < most ? groups : most;
  messages_wgmma<N, S><<<static_cast<unsigned>(grid), kThreads<S>, smem,
                         stream>>>(h, x_src, image, out, num_edges, K, c_in,
                                   c_out);
  return cudaGetLastError();
}

bool takes(int K, int c_in, int c_out) {
  return K >= 1 && K <= kMaxK && c_in >= 1 && c_in <= kMaxC && c_out >= 1 &&
         c_out <= kMaxC;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_messages_wgmma_smem_bytes(int K, int c_in, int c_out) {
  return Layout(K, c_in, c_out).total;
}

// Blocks one SM holds at once at these widths (-1 if they are not taken).
int fused_edge_messages_wgmma_blocks_per_sm(int K, int c_in, int c_out) {
  if (!takes(K, c_in, c_out)) return -1;
  const Layout L(K, c_in, c_out);
  return with_wide_shape(c_out, c_in, [&](auto n, auto s) {
    return blocks<decltype(n)::value, decltype(s)::value>(L);
  }, -1);
}

// Lays w3 and b3 out as the stage image on `stream`, alone (the forward
// does it first): image bfloat16 [chunks][K+1][slices][3][n][sd]
// (Chunks(c_out, c_in): c_in padded to dp = slices x sd, to 16 up to 128,
// past it to 32 in stages of 32) in the K-major operand layout of
// wgmma_tile.cuh; ops/pallas_mp.py:stage_image gives the same bits.
int fused_edge_messages_wgmma_stage_image(const void* w3, const void* b3,
                                          void* image, int K, int c_in,
                                          int c_out, void* stream) {
  if (!takes(K, c_in, c_out)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_image(
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<bf16*>(image), K, c_in, c_out, Chunks(c_out, c_in), true,
      static_cast<cudaStream_t>(stream)));
}

// Launches the stage image's kernel, then the messages kernel, on `stream`.
// Pointers are device pointers to contiguous arrays: h [E, K], x_src [E,
// c_in], w3 [K, c_in*c_out], b3 [c_in*c_out] and out [E, c_out] float32;
// image bfloat16 scratch [chunks][K+1][slices][3][n][sd], 16-byte aligned.
// K, c_in and c_out 1..256.  Returns the cudaError_t of the launches (0 on
// success).
int fused_edge_messages_wgmma_forward(const void* h, const void* x_src,
                                      const void* w3, const void* b3,
                                      void* image, void* out, int num_edges,
                                      int K, int c_in, int c_out,
                                      void* stream) {
  if (num_edges < 1 || !takes(K, c_in, c_out) ||
      reinterpret_cast<uintptr_t>(image) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_wide_shape(c_out, c_in, [&](auto n, auto st) {
    return launch<decltype(n)::value, decltype(st)::value>(
        static_cast<const float*>(h), static_cast<const float*>(x_src),
        static_cast<const float*>(w3), static_cast<const float*>(b3),
        static_cast<bf16*>(image), static_cast<float*>(out), num_edges, K,
        c_in, c_out, s);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
