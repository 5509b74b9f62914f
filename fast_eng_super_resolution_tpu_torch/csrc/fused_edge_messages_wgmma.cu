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
// Float32-exact products.  X and every W~_k are split exactly into three
// bf16 parts (v = v1 + v2 + v3: each remainder is exact in float32 and
// 8 + 8 + 8 significant bits cover float32's 24, as ops/pallas_mp.py:
// split3 splits).  For each k one float32 accumulator sums the six products
// of order >= 2^-16, the smallest first: X3 W1, X2 W2, X1 W3, X2 W1, X1 W2,
// X1 W1 (each product of bf16 values is exact; what is left out is below
// float32's rounding).
// Each such sum runs over depth c_in <= 64; the long sum over k stays in
// float32 FMAs, so the tensor cores' own accumulation never runs long.
//
// Design.
//  - X's three parts are the same for all K + 1 products of a tile: they
//    live in the warpgroup's registers as wgmma's A fragments (RS form,
//    messages_wgmma.cuh), loaded once per tile straight from x_src (rows
//    are contiguous: no gather); rows past E are zeros.  Only B, the stage
//    W~_k, is read from shared memory.
//  - A first launch (stage_image) lays W~'s parts out once per call as
//    K + 1 stages in a scratch image, each the exact shared-memory image of
//    the three K-major B operands ([c_out rounded up to 8] rows x [c_in
//    rounded up to 16] depth, zero padded).  One producer thread streams
//    the stages by bulk copy (cp.async.bulk, 1-D TMA) into a ring of
//    shared-memory stages, each completing on its "full" mbarrier;
//    consumers release a stage on its "empty" mbarrier.  Every tile reads
//    the same image, so it stays in L2.
//  - Two consumer warpgroups per block, a 64-edge tile each, share every
//    stage: half the L2 reads of one warpgroup per block.  The grid is
//    persistent (as many blocks as fit, each walking pairs of tiles), so
//    the ring streams on from one tile to the next.
//  - Two products in flight: k goes in runs of kRun; while P_{k+1}'s six
//    products run, the warpgroup weights P_k by h~[:, k] into the tile's
//    float32 sum.  All are waited for by the run's end: ptxas serializes
//    every wgmma of a loop that carries one in flight across its back edge.
//  - h is staged per tile in shared memory (column K all ones), the next
//    tile's copied by cp.async while the current tile's products run.
//  - Each output is written once, straight to [E, c_out]: no atomics, so
//    two launches give the same bits.
//
// Bound.  Per edge 2 (K+1) c_in c_out operations against (K + c_in +
// c_out) 4 bytes: far above the ridge, so operations bound it.  Float32
// FMAs at 67 TFLOP/s, or six bf16 passes at 989 TFLOP/s: the tensor cores'
// bound is the lesser, 6 / 989 of the work's flops per second against 1 /
// 67.  At K 48, width 48, E 258 048: 0.354 ms.  What stands in the way: a
// fixed cost per k of each tile (the ring's barriers, issuing and waiting
// for the products, the weighting), which a run of products hides only in
// part; each tile's x is loaded before its products start.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_messages_wgmma.so
//        fused_edge_messages_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "messages_wgmma.cuh"

namespace {

using namespace messages_wgmma;

constexpr int kMaxK = 128;
constexpr int kMaxC = 64;
constexpr int kTile = 64;       // edges per consumer warpgroup's tile
constexpr int kConsumers = 2;   // consumer warpgroups per block
constexpr int kThreads = kConsumers * kWarpgroup + 32;  // + the producer warp
constexpr int kRing = 4;        // stages in flight (a power of 2)
constexpr int kRun = 4;         // products per run (Walk::run)

// Byte offsets of the shared memory: the 2 kRing mbarriers, the ring of
// stages, then each consumer's two h tiles [64][hstride] (float32, column K
// all ones; an odd stride, so the 8 rows a warp reads at once sit in 8
// banks): the current tile's and the next one's, on its way.  At most
// 225 KB (K 128, c_in = c_out = 64).
struct Layout {
  int np, dp, hstride;
  long part, stage, ring, hs, total;
  __host__ __device__ Layout(int K, int c_in, int c_out) {
    np = round_up(c_out, 8);
    dp = round_up(c_in, 16);
    hstride = (K + 1) | 1;
    part = 2L * np * dp;
    stage = 3 * part;
    ring = 128;
    hs = ring + kRing * stage;
    total = hs + 4L * 2 * kConsumers * kTile * hstride;
  }
};

// Ring step j's stage and the parity of its phase on the stage's barriers
// (kRing a power of 2, so j may wrap).
__device__ __forceinline__ uint32_t slot(uint32_t j) { return j % kRing; }
__device__ __forceinline__ uint32_t parity(uint32_t j) {
  return (j / kRing) & 1;
}

// The three bf16 parts of the pair (a, b): hi + mid + lo == (a, b) exactly.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  union Pair {
    __nv_bfloat162 v;
    uint32_t u;
  } p1, p2, p3;
  p1.v = __floats2bfloat162_rn(a, b);
  const float2 f1 = __bfloat1622float2(p1.v);
  const float ra = a - f1.x, rb = b - f1.y;
  p2.v = __floats2bfloat162_rn(ra, rb);
  const float2 f2 = __bfloat1622float2(p2.v);
  p3.v = __floats2bfloat162_rn(ra - f2.x, rb - f2.y);
  hi = p1.u;
  mid = p2.u;
  lo = p3.u;
}

// The X part and the W part of product q (0..5), smallest first.
__device__ __forceinline__ constexpr int x_part(int q) {
  return q == 0 ? 2 : (q == 1 || q == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int w_part(int q) {
  return q == 2 ? 2 : (q == 1 || q == 4) ? 1 : 0;
}

// acc = sum of the six products of X's parts (registers xa[part][step]) and
// one stage's W parts (descriptor db; part p at db + p dpart, a k16 step at
// + 16), over the S k16 steps, as one committed group.
template <int N, int S>
__device__ __forceinline__ void issue(float (&acc)[N / 2],
                                      const uint32_t (&xa)[3][S][4],
                                      uint64_t db, uint32_t dpart) {
  fence_operand(acc);
  fence();
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int s = 0; s < S; ++s)
      MmaRs<N>::run(acc, xa[x_part(q)][s],
                    db + static_cast<uint64_t>(w_part(q) * dpart + 16 * s),
                    q + s > 0);
  commit();
  fence_operand(acc);
}

// m += h~[row, k] * p for this thread's two rows r0 and r0 + 8.
template <int N>
__device__ __forceinline__ void weight(float (&m)[N / 2],
                                       const float (&p)[N / 2],
                                       const float* hs, int hstride, int r0,
                                       int k) {
  const float ha = hs[r0 * hstride + k];
  const float hb = hs[(r0 + 8) * hstride + k];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) m[j] = fmaf((j & 2) ? hb : ha, p[j], m[j]);
}

// Starts the copy of tile e0's h rows (n of them; rows past n zeros) into
// the h tile hs, columns 0..K-1, by cp.async: nothing waits for it here.
__device__ __forceinline__ void prefetch_h(float* hs, const float* h, long e0,
                                           int n, int K, int hstride) {
  const float* src = h + e0 * K;
  const int t = threadIdx.x % kWarpgroup;
  int s = t / K, k = t - s * K;
  for (int q = t; q < kTile * K; q += kWarpgroup) {
    cp_async4(hs + s * hstride + k, s < n ? src + q : h, s < n ? 4 : 0);
    k += kWarpgroup;
    while (k >= K) {
      k -= K;
      ++s;
    }
  }
  cp_async_commit();
}

// A consumer warpgroup's walk over the ring: its tile's X parts (xa), its
// sum m, the ring's barriers and descriptors, its h tile and rows.
template <int N, int S>
struct Walk {
  const uint32_t (&xa)[3][S][4];
  float (&m)[N / 2];
  uint64_t* full;
  uint64_t* empty;
  uint64_t d0;
  uint32_t dstage, dpart;
  const float* hs;
  int hstride, r0, lane;

  // Issues P for ring step j into acc, once its stage has landed.
  __device__ __forceinline__ void start(float (&acc)[N / 2],
                                        uint32_t j) const {
    mbar_wait(full + slot(j), parity(j));
    issue<N, S>(acc, xa, d0 + slot(j) * dstage, dpart);
  }

  // P (ring step j, h column k) is in acc and complete: release the stage,
  // m += h~[:, k] P.
  __device__ __forceinline__ void finish(float (&acc)[N / 2], uint32_t j,
                                         int k) const {
    fence_operand(acc);
    if (lane == 0) mbar_arrive(empty + slot(j));
    weight<N>(m, acc, hs, hstride, r0, k);
  }

  // cur's products (step j, column k) are in flight: weights them and the
  // U - 1 steps after them, each next product issued (into the other
  // accumulator) before the current one is weighted.  All are waited for
  // by the end.
  template <int U>
  __device__ __forceinline__ void run(float (&cur)[N / 2],
                                      float (&nxt)[N / 2], uint32_t j,
                                      int k) const {
    if constexpr (U > 1) {
      start(nxt, j + 1);
      wait_one();
      finish(cur, j, k);
      run<U - 1>(nxt, cur, j + 1, k + 1);
    } else {
      wait_all();
      finish(cur, j, k);
    }
  }
};

// The stages of W~ = [w3; b3] as [K+1, c_in, c_out]: stage k holds W~_k's
// three bf16 parts, each the K-major B operand [np rows (o), dp deep (i)]
// of wgmma_tile.cuh (kmajor), zero padded.  ops/pallas_mp.py:stage_image is
// its plain version (the same bits).
__global__ void stage_image(const float* __restrict__ w3,
                            const float* __restrict__ b3,
                            bf16* __restrict__ image, int K, int c_in,
                            int c_out, int np, int dp) {
  const int per = np * dp;
  const long total = static_cast<long>(K + 1) * per;
  for (long q = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(q / per), r = static_cast<int>(q % per);
    const int i = r / np, o = r - i * np;  // o fastest: w3's rows coalesce
    float v = 0.f;
    if (o < c_out && i < c_in)
      v = k < K ? w3[static_cast<long>(k) * c_in * c_out + i * c_out + o]
                : b3[i * c_out + o];
    const bf16 v1 = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(v1);
    const bf16 v2 = __float2bfloat16_rn(r1);
    const bf16 v3 = __float2bfloat16_rn(r1 - __bfloat162float(v2));
    bf16* st = image + static_cast<long>(k) * 3 * per + kmajor(o, i, dp);
    st[0] = v1;
    st[per] = v2;
    st[2 * per] = v3;
  }
}

// N = c_out rounded up to 8, S = c_in rounded up to 16, over 16.
template <int N, int S>
__global__ void __launch_bounds__(kThreads, 1)
messages_wgmma(const float* __restrict__ h, const float* __restrict__ x_src,
               const bf16* __restrict__ image, float* __restrict__ out,
               long num_edges, int K, int c_in, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(K, c_in, c_out);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const long tiles = (num_edges + kTile - 1) / kTile;
  const long pairs = (tiles + kConsumers - 1) / kConsumers;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    for (int r = 0; r < kRing; ++r) {
      mbar_init(full + r, 1);
      mbar_init(empty + r, 4 * kConsumers);  // lane 0 of every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  // ---- producer: stage k of every pair of tiles, in order ----
  if (wg == kConsumers) {
    if (threadIdx.x % 32 == 0) {
      const uint32_t bytes = static_cast<uint32_t>(L.stage);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(image);
      uint32_t j = 0;
      for (long pr = blockIdx.x; pr < pairs; pr += gridDim.x)
        for (int k = 0; k <= K; ++k, ++j) {
          const uint32_t r = slot(j);
          mbar_wait(empty + r, parity(j) ^ 1);
          mbar_expect_tx(full + r, bytes);
          bulk_load(ring + r * L.stage, src + k * L.stage, bytes, full + r);
        }
    }
    return;
  }

  // ---- consumers ----
  const int t = threadIdx.x % kWarpgroup;
  const int lane = t % 32;
  const int r0 = a_row(0);  // this thread's rows: r0 and r0 + 8
  float* hbuf = reinterpret_cast<float*>(smem + L.hs) +
                2 * wg * kTile * L.hstride;  // two h tiles
  for (int s = t; s < 2 * kTile; s += kWarpgroup) hbuf[s * L.hstride + K] = 1.f;
  const uint64_t d0 = desc(ring, L.dp);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = static_cast<uint32_t>(L.part >> 4);
  uint32_t j = 0;  // the ring's step, counted as the producer counts it
  int buf = 0;     // the h tile of this warpgroup's current tile

  // the tile of pair pr, its first edge and its edges (0 past the end)
  auto edges = [&](long pr) {
    const long e0 = (pr * kConsumers + wg) * kTile;
    return e0 < num_edges ? static_cast<int>(min(static_cast<long>(kTile),
                                                 num_edges - e0))
                          : 0;
  };
  if (blockIdx.x < pairs && edges(blockIdx.x) > 0)
    prefetch_h(hbuf, h, (blockIdx.x * kConsumers + wg) * kTile,
               edges(blockIdx.x), K, L.hstride);

  for (long pr = blockIdx.x; pr < pairs; pr += gridDim.x) {
    const long e0 = (pr * kConsumers + wg) * kTile;
    const int n = edges(pr);
    if (n == 0) {  // no tile for this warpgroup: pass the stages on
      for (int k = 0; k <= K; ++k, ++j) {
        mbar_wait(full + slot(j), parity(j));
        if (lane == 0) mbar_arrive(empty + slot(j));
      }
      continue;
    }

    uint32_t xa[3][S][4];
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
    cp_async_wait_all();
    warpgroup_sync(wg);  // the tile's h has landed, and every thread is done
                         // with the other h tile
    const float* hs = hbuf + buf * kTile * L.hstride;
    const long next = pr + gridDim.x;
    if (next < pairs && edges(next) > 0)
      prefetch_h(hbuf + (buf ^ 1) * kTile * L.hstride, h,
                 (next * kConsumers + wg) * kTile, edges(next), K, L.hstride);
    buf ^= 1;

    // ---- m = sum_k h~[:, k] P_k, P_k = X @ W~_k, in runs of kRun k (the
    // rest one by one): within a run P_{k+1}'s products run while P_k is
    // weighted, and every product is waited for by the run's end (ptxas
    // serializes every wgmma of a loop that carries one in flight across
    // its back edge).
    float m[N / 2], pa[N / 2], pb[N / 2];
#pragma unroll
    for (int v = 0; v < N / 2; ++v) m[v] = 0.f;
    const Walk<N, S> w{xa, m, full, empty, d0, dstage, dpart, hs, L.hstride,
                       r0, lane};
    int k = 0;
    for (; k + kRun <= K + 1; k += kRun, j += kRun) {
      w.start(pa, j);
      w.template run<kRun>(pa, pb, j, k);
    }
    for (; k <= K; ++k, ++j) {
      w.start(pa, j);
      w.template run<1>(pa, pb, j, k);
    }

#pragma unroll
    for (int v = 0; v < N / 2; ++v) {
      const int row = acc_row(v), col = acc_col(v);
      if (row < n && col < c_out) out[(e0 + row) * c_out + col] = m[v];
    }
  }
}

template <int N, int S>
int blocks_on_sm(const Layout& L) {
  int per_sm = -1;
  auto kernel = messages_wgmma<N, S>;
  if (allow_smem(kernel, static_cast<size_t>(L.total)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, static_cast<size_t>(L.total)) !=
          cudaSuccess)
    return -1;
  return per_sm;
}

// f(integral_constant N, integral_constant S) for the kernel instance of
// these widths; `otherwise` outside 1..64.
template <typename F, typename R>
R with_shape(int c_in, int c_out, F&& f, R otherwise) {
  if (c_in < 1 || c_in > kMaxC) return otherwise;
  return with_width(round_up(c_out, 8), [&](auto n) {
    switch (round_up(c_in, 16) / 16) {
      case 1: return f(n, std::integral_constant<int, 1>());
      case 2: return f(n, std::integral_constant<int, 2>());
      case 3: return f(n, std::integral_constant<int, 3>());
      default: return f(n, std::integral_constant<int, 4>());
    }
  }, otherwise);
}

cudaError_t launch_image(const float* w3, const float* b3, bf16* image,
                         int K, int c_in, int c_out, cudaStream_t stream) {
  const Layout L(K, c_in, c_out);
  const long cells = static_cast<long>(K + 1) * L.np * L.dp;
  stage_image<<<static_cast<unsigned>((cells + 255) / 256), 256, 0, stream>>>(
      w3, b3, image, K, c_in, c_out, L.np, L.dp);
  return cudaGetLastError();
}

template <int N, int S>
cudaError_t launch(const float* h, const float* x_src, const float* w3,
                   const float* b3, bf16* image, float* out, long num_edges,
                   int K, int c_in, int c_out, cudaStream_t stream) {
  const Layout L(K, c_in, c_out);
  const int per_sm = blocks_on_sm<N, S>(L);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = launch_image(w3, b3, image, K, c_in, c_out, stream);
  if (err != cudaSuccess) return err;
  const long tiles = (num_edges + kTile - 1) / kTile;
  const long pairs = (tiles + kConsumers - 1) / kConsumers;
  const long grid = pairs < static_cast<long>(sms) * per_sm
                        ? pairs : static_cast<long>(sms) * per_sm;
  messages_wgmma<N, S><<<static_cast<unsigned>(grid), kThreads,
                         static_cast<size_t>(L.total), stream>>>(
      h, x_src, image, out, num_edges, K, c_in, c_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_messages_wgmma_smem_bytes(int K, int c_in, int c_out) {
  return Layout(K, c_in, c_out).total;
}

// Blocks one SM holds at once at these widths (-1 if they are not taken).
int fused_edge_messages_wgmma_blocks_per_sm(int K, int c_in, int c_out) {
  if (K < 1 || K > kMaxK) return -1;
  const Layout L(K, c_in, c_out);
  return with_shape(c_in, c_out, [&](auto n, auto s) {
    return blocks_on_sm<decltype(n)::value, decltype(s)::value>(L);
  }, -1);
}

// Lays w3 and b3 out as the stage image on `stream`, alone (the forward
// does it first): image bfloat16 [K+1][3][np][dp] (np = c_out rounded up
// to 8, dp = c_in rounded up to 16) in the K-major operand layout of
// wgmma_tile.cuh; ops/pallas_mp.py:stage_image gives the same bits.
int fused_edge_messages_wgmma_stage_image(const void* w3, const void* b3,
                                          void* image, int K, int c_in,
                                          int c_out, void* stream) {
  if (K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxC || c_out < 1 ||
      c_out > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_image(
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<bf16*>(image), K, c_in, c_out,
      static_cast<cudaStream_t>(stream)));
}

// Launches the stage image's kernel, then the messages kernel, on `stream`.
// Pointers are device pointers to contiguous arrays: h [E, K], x_src [E,
// c_in], w3 [K, c_in*c_out], b3 [c_in*c_out] and out [E, c_out] float32;
// image bfloat16 scratch [K+1][3][np][dp], 16-byte aligned.  1 <= K <= 128, 1 <= c_in, c_out <= 64.  Returns the
// cudaError_t of the launches (0 on success).
int fused_edge_messages_wgmma_forward(const void* h, const void* x_src,
                                      const void* w3, const void* b3,
                                      void* image, void* out, int num_edges,
                                      int K, int c_in, int c_out,
                                      void* stream) {
  if (num_edges < 1 || K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxC ||
      c_out < 1 || c_out > kMaxC ||
      reinterpret_cast<uintptr_t>(image) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_shape(c_in, c_out, [&](auto n, auto st) {
    return launch<decltype(n)::value, decltype(st)::value>(
        static_cast<const float*>(h), static_cast<const float*>(x_src),
        static_cast<const float*>(w3), static_cast<const float*>(b3),
        static_cast<bf16*>(image), static_cast<float*>(out), num_edges, K,
        c_in, c_out, s);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
