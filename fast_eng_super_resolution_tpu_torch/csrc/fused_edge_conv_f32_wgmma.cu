// Fused edge-conditioned conv layer, forward, in float32 on Hopper's tensor
// cores (wgmma, sm_90a), exact to float32 through split bf16 operands.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_edge_conv_jit
// for float32 operands (the JAX function's default GEMM type, which runs on
// the TPU's matrix unit at Precision.HIGHEST, itself multi-pass bf16;
// fused_edge_conv_wgmma.cu is the bfloat16 instance) and computes the same
// function.  Slots are the receiver-sorted edges, grouped host-side into
// num_blocks blocks of `blk` slots, block b holding the edges whose
// receivers lie in rows [64 b, 64 b + 64):
//
//   W_e[i, o]  = sum_k h[e, k] w3[k, i*c_out + o] + b3[i*c_out + o]
//   msg_e[o]   = sum_i x[senders_perm[e], i] W_e[i, o]
//   out[r, o]  = sum_{e in block(r)} S[r, e] msg_e[o]
//
// with S dense ([num_blocks*64, blk] f32) or given by its CompactS generators
// (S[64 b + r, e] = (slot_rows[e] == r) row_weight[64 b + r], padding -1).
//
// Factored form, as the bfloat16 instance: with W~_k = w3[k] as [c_in,
// c_out], W~_K = b3 and h~[e, K] = 1, a 64-slot tile X = x[senders_perm] of
// the tile's slots gives
//
//   msg = sum_{k <= K} h~[:, k] * (X @ W~_k),
//
// so the tensor cores see only X and W~_k, never a rounding of h W3; the
// weighting by h~, the long sum over k and the scatter run on the CUDA cores
// in float32.  b3 is not rounded: it is stage K, split like w3.
//
// Float32-exact products (f32_wgmma.cuh).  X and every W~_k are split
// exactly into three bf16 parts; per k one float32 accumulator sums the six
// products of order >= 2^-16, smallest first, each over depth c_in <= 128.
//
// Widths.  c_in and c_out 1..256, K 1..256.  The c_out columns (rounded up
// to 8) are cut into column chunks (f32_wgmma.cuh Chunks: one chunk up to
// 64 columns; past that chunks of at most 64, or 32 where c_in is 65..128),
// and the tile walks the K+1 stages once per chunk.
//  - Up to c_in and c_out of 128 one block walks every chunk, X's parts
//    kept in registers across the passes.  X's parts take 12 registers per
//    16 of c_in (96 at 128), each accumulator N / 2: at c_in = c_out = 128
//    four passes of N = 32 keep a thread under 255 registers where one
//    pass of N = 128 (two accumulators of 64 and a sum of 64 beside X's 96)
//    would not, and keep a stage at 24 KB.
//  - Past 128 (c_in or c_out) each chunk is a block of its own (grid z),
//    which writes its columns of the output: the tile's messages and the
//    part's row sums then take one chunk's columns (16 KB each at
//    N 64), not c_out's (64 KB each at 256).
//  - Past a c_in of 128 X's parts would take 192 registers at 256: they are
//    split once per tile into shared memory (96 KB at 256) and the walk is
//    f32_wgmma.cuh's DeepWalk, each W~_k of a chunk in c_in / 32 stages of
//    32 deep (12 KB at N 64).  h is then read from device memory (L1), one
//    k ahead of the weighting, not staged: at K 256 its tile (64 KB) and
//    X's parts would not fit beside the ring.  177 KB at K = c_in = c_out =
//    256, one block per SM.

// Design.
//  - A block is one consumer warpgroup and one producer warp, and owns one
//    part of one receiver block's slot walk: grid (num_blocks, parts), the
//    parts from the wrapper's planner (ops/fused_conv.py:conv_parts).
//    Each chunk's pass sums its columns of the tile's messages in registers
//    and leaves them in shared memory for the scatter.
//  - X's three parts are the same for the K + 1 products of a tile: they
//    live in the warpgroup's registers as wgmma's A fragments (register-A,
//    messages_wgmma.cuh), gathered once per tile through senders_perm and
//    split there.  Only B, the stage W~_k, is read from shared memory.
//  - W~'s parts come from a stage image laid out once per call by a first
//    launch and streamed by the producer thread (cp.async.bulk onto
//    mbarriers) into a 4-stage ring.  The other way, a split on load into
//    K-major shared memory, would read each w3 row from L2 once per tile
//    and spend three conversions and two subtractions per element on the
//    consumers' CUDA cores for every tile; the image pays them once per
//    call and the copies cost the consumers no instructions.
//  - Two products in flight: k goes in runs of 4 stages; while P_{k+1}'s
//    six products run, the warpgroup weights P_k by h~[:, k] into the
//    tile's float32 sum.  All are waited for by the run's end: ptxas
//    serializes every wgmma of a loop that carries one in flight across
//    its back edge.
//  - h is staged per tile in shared memory (column K all ones), the next
//    tile's copied by cp.async while the current tile's messages scatter
//    and the next tile's X is gathered.  One h tile, not two: at K 128 and
//    width 48 that keeps a block under half the SM's shared memory, and two
//    blocks per SM (the launch bounds hold the registers to what two need,
//    kMinBlocks) hide each other's per-stage latencies better than a second
//    h tile would.
//  - The scatter is a segmented sum in CompactS form: each slot feeds one
//    row and the slots are receiver-sorted, so a thread owning an output
//    column adds each run of one row's messages into the row, in slot
//    order; the dense form keeps the 64 x 64 S product.  Tiles of padding
//    only are skipped in CompactS form (the producer skips them too).
//  - Each part writes its own [64, c_out] partial (straight into the
//    output when there is one part); the wrapper sums the partials in a
//    fixed order.  No atomics: two launches give the same bits.
//
// Bound.  Per real slot 2 (K+1) c_in c_out operations against (K + c_in) 4
// + 8 bytes: operations bound it.  Float32 FMAs at 67 TFLOP/s, or six bf16
// passes at 989 TFLOP/s: the tensor cores' bound is the lesser, 6 / 989 of
// the work's flops per second against 1 / 67.  What stands in the way: the
// per-stage cost of the ring's barriers, of issuing and waiting for the
// products and of the weighting, which a run hides only in part; the
// gather of X before each tile's products; the scatter.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_f32_wgmma.so
//        fused_edge_conv_f32_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_wgmma.cuh"

namespace {

using namespace f32_wgmma;

constexpr int kRows = 64;   // receiver rows per block (rows_blk)
constexpr int kTile = 64;   // slots per tile
constexpr int kMaxDim = 256;
constexpr int kMaxK = 256;
constexpr int kThreads = kWarpgroup + 32;  // consumers + the producer warp

// Byte offsets of the shared memory: the 2 kRing mbarriers, the ring of
// stages ([3][n][sd] bf16 each, n a chunk's columns, sd the stage's depth),
// past a c_in of 128 X's parts [3][64][dp] bf16, else the h tile
// [64][hstride] f32 (column K all ones; an odd stride, so that the 8 rows a
// warp reads at once fall in 8 banks), the tile's messages [64][np+1] (np =
// the block's chunks x n), the part's row sums [64][cols] (the block's
// columns) and the tile's slot_rows.  Up to widths of 128 one block takes
// every chunk (`per_block`): at width 48 93 KB at K 48, 114 KB at K 128 (two
// blocks per SM); 165 KB at K 128, c_in = c_out = 64; 193 KB at K 128, c_in
// = c_out = 128 (225 KB at K 256).  Past 128 a block takes one chunk.
struct Layout {
  Chunks ch;
  int per_block, np, cols, dp, hstride;
  long stage, ring, a, hs, m, acc, srow, total;
  __host__ __device__ Layout(int K, int c_in, int c_out) : ch(c_out, c_in) {
    per_block = c_in > 128 || c_out > 128 ? 1 : ch.chunks;
    np = per_block * ch.n;
    cols = np < c_out ? np : c_out;
    dp = ch.dp;
    hstride = (K + 1) | 1;
    stage = 3 * 2L * ch.n * ch.sd;
    ring = 128;
    a = ring + kRing * stage;
    hs = a + (ch.deep ? 3 * 2L * kTile * dp : 0);
    m = hs + (ch.deep ? 0 : 4L * kTile * hstride);
    acc = m + 4L * kTile * (np + 1);
    srow = acc + 4L * kRows * cols;
    total = srow + 4L * kTile;
  }
};

// Blocks per SM the launch bounds hold the registers to: two (at most 168
// registers a thread, so that two blocks' ten warps fit the register files
// of the SM's four sub-partitions) where ptxas fits the instance into them
// with no more than a few bytes of spills, else one (N * S >= 192: c_out
// past 56 with c_in past 32, or c_out past 40 with c_in past 48; or c_in
// past 64).
template <int N, int S>
constexpr int kMinBlocks = N * S < 192 && S <= 4 ? 2 : 1;

// N = a chunk's columns of c_out (f32_wgmma.cuh Chunks), S = c_in rounded
// up to 16, over 16, or kDeepA past a c_in of 128 (X's parts in shared
// memory).  Block (b, part, z) walks part `part` of receiver block b's
// tiles for chunks z per_block .. z per_block + per_block - 1.
template <int N, int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks<N, S>)
conv_fwd_f32_wgmma(const float* __restrict__ h, const float* __restrict__ x,
                   const int* __restrict__ senders_perm,
                   const bf16* __restrict__ image,
                   const int* __restrict__ slot_rows,
                   const float* __restrict__ row_weight,
                   const float* __restrict__ s_dense, float* __restrict__ out,
                   int blk, int K, int c_in, int c_out, int n_nodes) {
  constexpr bool kDeep = S == kDeepA;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(K, c_in, c_out);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const int b = blockIdx.x, part = blockIdx.y, parts = gridDim.y;
  const int tiles = blk / kTile;
  const int t_lo = part * tiles / parts, t_hi = (part + 1) * tiles / parts;
  const long row_base = static_cast<long>(b) * kRows;
  const long blk0 = static_cast<long>(b) * blk;
  const bool compact = s_dense == nullptr;
  const int lane = threadIdx.x % 32;
  // the block's chunks, its first output column and its columns
  const int chunks = L.per_block, c0 = blockIdx.z * L.np;
  const int cols = c_out - c0 < L.cols ? c_out - c0 : L.cols;

  // the first tile from t on (t_hi if none) that holds a real slot (every
  // tile in the dense form): each warp finds it by itself, so that the
  // producer and the consumers walk the same tiles
  auto next_real = [&](int t) {
    if (!compact) return t;
    for (; t < t_hi; ++t) {
      const int* sr = slot_rows + blk0 + static_cast<long>(t) * kTile;
      if (__any_sync(0xffffffffu, sr[lane] >= 0 || sr[lane + 32] >= 0)) break;
    }
    return t;
  };

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  // ---- producer: the block's chunks x (K + 1) x slices stages of every
  // real tile of the part ----
  const int stages = chunks * (K + 1) * L.ch.slices;
  if (threadIdx.x >= kWarpgroup) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(image) +
                               static_cast<long>(blockIdx.z) * stages * L.stage;
    uint32_t j = 0;
    for (int t = next_real(t_lo); t < t_hi; t = next_real(t + 1)) {
      if (lane == 0)
        produce(full, empty, ring, src, static_cast<uint32_t>(L.stage),
                stages - 1, j);
      __syncwarp();
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x;
  const int r0 = a_row(0);  // this thread's rows: r0 and r0 + 8
  const int hstride = L.hstride, mstride = L.np + 1;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  float* m_sm = reinterpret_cast<float*>(smem + L.m);
  float* acc_sm = reinterpret_cast<float*>(smem + L.acc);
  int* srow = reinterpret_cast<int*>(smem + L.srow);
  if constexpr (!kDeep)
    for (int s = tid; s < kTile; s += kWarpgroup) hs[s * hstride + K] = 1.f;
  for (int e = tid; e < kRows * cols; e += kWarpgroup) acc_sm[e] = 0.f;
  const uint64_t d0 = desc(ring, L.ch.sd);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = dstage / 3;
  uint32_t j = 0;  // the ring's step, counted as the producer counts it

  int t = next_real(t_lo);
  if constexpr (!kDeep)
    if (t < t_hi)
      prefetch_h(hs, h, blk0 + static_cast<long>(t) * kTile, K, hstride);
  while (t < t_hi) {
    const long tile = blk0 + static_cast<long>(t) * kTile;
    // X's parts: x[senders_perm] at this thread's fragment rows and columns
    // (past a c_in of 128: all of X's, split into shared memory)
    uint32_t xa[3][kDeep ? 1 : S][4];
    if constexpr (kDeep) {
      const int per = L.dp / 8;
      for (int p = tid; p < kTile * per; p += kWarpgroup) {
        const int s = p / per, d = 8 * (p - s * per);
        const int src = senders_perm[tile + s];
        const float* xr = x + static_cast<long>(src) * c_in;
        const bool real = src >= 0 && src < n_nodes;
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = real && d + u < c_in ? xr[d + u] : 0.f;
        put_split8(a_sm, L.dp, s, d, v);
      }
      fence_async_smem();
    } else {
      int src[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        src[u] = senders_perm[tile + r0 + 8 * u];
        if (src[u] < 0 || src[u] >= n_nodes) src[u] = -1;
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = u & 1, col = 16 * s + a_col(2 * u);
          float va = 0.f, vb = 0.f;
          if (src[row] >= 0) {
            const float* xr = x + static_cast<long>(src[row]) * c_in;
            if (col < c_in) va = xr[col];
            if (col + 1 < c_in) vb = xr[col + 1];
          }
          split3(va, vb, xa[0][s][u], xa[1][s][u], xa[2][s][u]);
        }
    }
    cp_async_wait_all();
    warpgroup_sync(0);  // the tile's h (X's parts) has landed, and every
                        // thread is done with the last tile's scatter
    if (compact && tid < kTile) srow[tid] = slot_rows[tile + tid];
    const int next = next_real(t + 1);

    // ---- per chunk c: msg = sum_k h~[:, k] P_k, P_k = X @ W~_k at the
    // chunk's columns, into the messages' columns c N .. ----
    float msg[N / 2];
    // past a c_in of 128: h~[:, k] from device memory, the next k's loaded
    // while this one's products run (h~[:, K] = 1)
    const float* ha_row = h + (tile + r0) * K;
    const float* hb_row = ha_row + 8L * K;
    float hna = 0.f, hnb = 0.f;
    auto weight = [&](const float (&p)[N / 2], int k) {
      float ha, hb;
      if constexpr (kDeep) {
        ha = hna;
        hb = hnb;
        const bool more = k + 1 < K;
        hna = more ? __ldg(ha_row + k + 1) : 1.f;
        hnb = more ? __ldg(hb_row + k + 1) : 1.f;
      } else {
        ha = hs[r0 * hstride + k];
        hb = hs[(r0 + 8) * hstride + k];
      }
#pragma unroll
      for (int v = 0; v < N / 2; ++v) msg[v] = fmaf((v & 2) ? hb : ha, p[v], msg[v]);
    };
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int v = 0; v < N / 2; ++v) msg[v] = 0.f;
      if constexpr (kDeep) {
        hna = __ldg(ha_row);
        hnb = __ldg(hb_row);
        const DeepWalk<N, decltype(weight)> walk{
            desc(a_sm, L.dp), static_cast<uint32_t>(2 * kTile * L.dp >> 4),
            L.ch.slices, full, empty, d0, dstage, dpart, lane, weight};
        walk.all(K + 1, j);
      } else {
        const Walk<N, S, decltype(weight)> walk{xa, full, empty, d0, dstage,
                                                dpart, lane, weight};
        walk.all(K, j);
      }
#pragma unroll
      for (int v = 0; v < N / 2; ++v)
        m_sm[acc_row(v) * mstride + c * N + acc_col(v)] = msg[v];
    }

    // ---- scatter the tile's messages into the part's row sums, while the
    // next tile's h lands (every thread is done with this one's) ----
    warpgroup_sync(0);
    if constexpr (!kDeep)
      if (next < t_hi)
        prefetch_h(hs, h, blk0 + static_cast<long>(next) * kTile, K, hstride);
    if (compact) {
      for (int o = tid; o < cols; o += kWarpgroup) {
        int cur = -1;
        float run = 0.f;
        for (int s = 0; s < kTile; ++s) {
          const int r = srow[s];
          if (r != cur) {
            if (cur >= 0) acc_sm[cur * cols + o] += run;
            cur = r;
            run = 0.f;
          }
          if (r >= 0) run += m_sm[s * mstride + o];
        }
        if (cur >= 0) acc_sm[cur * cols + o] += run;
      }
    } else {
      const float* s_tile = s_dense + row_base * blk + static_cast<long>(t) * kTile;
      for (int e = tid; e < kRows * cols; e += kWarpgroup) {
        const int r = e / cols, o = e - r * cols;
        float v = 0.f;
        for (int s = 0; s < kTile; ++s)
          v = fmaf(s_tile[static_cast<long>(r) * blk + s], m_sm[s * mstride + o], v);
        acc_sm[e] += v;
      }
    }
    t = next;
  }
  warpgroup_sync(0);

  // ---- the block's columns of the part's partial (the output itself when
  // parts == 1) ----
  float* dst = out + (static_cast<long>(part) * gridDim.x * kRows + row_base) * c_out + c0;
  for (int e = tid; e < kRows * cols; e += kWarpgroup) {
    const int r = e / cols;
    const float v = acc_sm[e];
    dst[r * c_out + e - r * cols] = compact ? row_weight[row_base + r] * v : v;
  }
}

template <int N, int S>
cudaError_t launch(const float* h, const float* x, const int* senders_perm,
                   const float* w3, const float* b3, const int* slot_rows,
                   const float* row_weight, const float* s_dense, bf16* image,
                   float* out, int num_blocks, int blk, int K, int c_in,
                   int c_out, int n_nodes, int parts, cudaStream_t stream) {
  const Layout L(K, c_in, c_out);
  const size_t smem = static_cast<size_t>(L.total);
  auto kernel = conv_fwd_f32_wgmma<N, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = launch_image(w3, b3, image, K, c_in, c_out, L.ch, true, stream);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(num_blocks, parts, L.ch.chunks / L.per_block), kThreads, smem,
           stream>>>(h, x, senders_perm, image, slot_rows, row_weight, s_dense,
                     out, blk, K, c_in, c_out, n_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_conv_f32_wgmma_smem_bytes(int K, int c_in, int c_out) {
  return Layout(K, c_in, c_out).total;
}

// Blocks one SM holds at once at these widths (-1 if they are not taken).
int fused_edge_conv_f32_wgmma_blocks_per_sm(int K, int c_in, int c_out) {
  if (K < 1 || K > kMaxK) return -1;
  const Layout L(K, c_in, c_out);
  return with_wide_shape(c_out, c_in, [&](auto n, auto s) {
    return blocks_on_sm(conv_fwd_f32_wgmma<decltype(n)::value, decltype(s)::value>,
                        kThreads, static_cast<size_t>(L.total));
  }, -1);
}

// Launches the float32 forward on `stream`: the stage image of w3 and b3,
// then the layer.  Pointers are device pointers; h, x, w3, b3, row_weight,
// s_dense and out float32; senders_perm and slot_rows int32; image bfloat16
// scratch [chunks][K+1][slices][3][n][sd] (f32_wgmma.cuh Chunks(c_out,
// c_in): c_in padded to dp = slices x sd, to 16 up to 128, past it to 32 in
// stages of 32), 16-byte aligned.  Exactly one of s_dense and
// (slot_rows, row_weight) is non-null.  out is [num_blocks*64, c_out] when
// parts == 1, else the partials [parts, num_blocks*64, c_out].  Returns the
// cudaError_t of the launches (0 on success).
int fused_edge_conv_f32_wgmma_forward(
    const void* h, const void* x, const void* senders_perm, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* image, void* out, int num_blocks, int blk,
    int K, int c_in, int c_out, int n_nodes, int parts, void* stream) {
  if (K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      parts < 1 || parts > blk / kTile ||
      reinterpret_cast<uintptr_t>(image) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_wide_shape(c_out, c_in, [&](auto n, auto s) {
    return launch<decltype(n)::value, decltype(s)::value>(
        static_cast<const float*>(h), static_cast<const float*>(x),
        static_cast<const int*>(senders_perm), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
        static_cast<const float*>(row_weight),
        static_cast<const float*>(s_dense), static_cast<bf16*>(image),
        static_cast<float*>(out), num_blocks, blk, K, c_in, c_out, n_nodes,
        parts, st);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
