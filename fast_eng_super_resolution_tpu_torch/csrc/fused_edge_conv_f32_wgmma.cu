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
// Widths.  c_in and c_out 1..128, K 1..128, one design: the c_out columns
// (rounded up to 8) are cut into column chunks (f32_wgmma.cuh Chunks: one
// chunk up to 64 columns; past that chunks of at most 64, or 32 where c_in
// is past 64), and the tile walks the K+1 stages once per chunk with X's
// parts kept in registers across the passes.  X's parts take 12 registers
// per 16 of c_in (96 at 128), each accumulator N / 2: at c_in = c_out = 128
// four passes of N = 32 keep a thread under 255 registers where one pass of
// N = 128 (two accumulators of 64 and a sum of 64 beside X's 96) would not,
// and keep a stage at 24 KB.
//
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
constexpr int kMaxDim = 128;
constexpr int kMaxK = 128;
constexpr int kThreads = kWarpgroup + 32;  // consumers + the producer warp

// Byte offsets of the shared memory: the 2 kRing mbarriers, the ring of
// stages ([3][n][dp] bf16 each, n a chunk's columns), the h tile
// [64][hstride] f32 (column K all ones; an odd stride, so that the 8 rows a
// warp reads at once fall in 8 banks), the tile's messages [64][np+1] (np =
// chunks x n), the part's row sums [64][c_out] and the tile's slot_rows.
// At width 48: 93 KB at K 48, 114 KB at K 128 (two blocks per SM); 165 KB
// at K 128, c_in = c_out = 64; 193 KB at K 128, c_in = c_out = 128.
struct Layout {
  Chunks ch;
  int np, dp, hstride;
  long stage, ring, hs, m, acc, srow, total;
  __host__ __device__ Layout(int K, int c_in, int c_out) : ch(c_out, c_in) {
    np = ch.chunks * ch.n;
    dp = round_up(c_in, 16);
    hstride = (K + 1) | 1;
    stage = 3 * 2L * ch.n * dp;
    ring = 128;
    hs = ring + kRing * stage;
    m = hs + 4L * kTile * hstride;
    acc = m + 4L * kTile * (np + 1);
    srow = acc + 4L * kRows * c_out;
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
// up to 16, over 16.
template <int N, int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks<N, S>)
conv_fwd_f32_wgmma(const float* __restrict__ h, const float* __restrict__ x,
                   const int* __restrict__ senders_perm,
                   const bf16* __restrict__ image,
                   const int* __restrict__ slot_rows,
                   const float* __restrict__ row_weight,
                   const float* __restrict__ s_dense, float* __restrict__ out,
                   int blk, int K, int c_in, int c_out, int n_nodes) {
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

  // ---- producer: the chunks x (K + 1) stages of every real tile of the
  // part ----
  const int chunks = L.ch.chunks;
  if (threadIdx.x >= kWarpgroup) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(image);
    uint32_t j = 0;
    for (int t = next_real(t_lo); t < t_hi; t = next_real(t + 1)) {
      if (lane == 0)
        produce(full, empty, ring, src, static_cast<uint32_t>(L.stage),
                chunks * (K + 1) - 1, j);
      __syncwarp();
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x;
  const int r0 = a_row(0);  // this thread's rows: r0 and r0 + 8
  const int hstride = L.hstride, mstride = L.np + 1;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* m_sm = reinterpret_cast<float*>(smem + L.m);
  float* acc_sm = reinterpret_cast<float*>(smem + L.acc);
  int* srow = reinterpret_cast<int*>(smem + L.srow);
  for (int s = tid; s < kTile; s += kWarpgroup) hs[s * hstride + K] = 1.f;
  for (int e = tid; e < kRows * c_out; e += kWarpgroup) acc_sm[e] = 0.f;
  const uint64_t d0 = desc(ring, L.dp);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = dstage / 3;
  uint32_t j = 0;  // the ring's step, counted as the producer counts it

  int t = next_real(t_lo);
  if (t < t_hi) prefetch_h(hs, h, blk0 + static_cast<long>(t) * kTile, K, hstride);
  while (t < t_hi) {
    const long tile = blk0 + static_cast<long>(t) * kTile;
    // X's parts: x[senders_perm] at this thread's fragment rows and columns
    uint32_t xa[3][S][4];
    {
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
    warpgroup_sync(0);  // the tile's h has landed, and every thread is done
                        // with the last tile's scatter
    if (compact && tid < kTile) srow[tid] = slot_rows[tile + tid];
    const int next = next_real(t + 1);

    // ---- per chunk c: msg = sum_k h~[:, k] P_k, P_k = X @ W~_k at the
    // chunk's columns, into the messages' columns c N .. ----
    float msg[N / 2];
    auto weight = [&](const float (&p)[N / 2], int k) {
      const float ha = hs[r0 * hstride + k];
      const float hb = hs[(r0 + 8) * hstride + k];
#pragma unroll
      for (int v = 0; v < N / 2; ++v) msg[v] = fmaf((v & 2) ? hb : ha, p[v], msg[v]);
    };
    const Walk<N, S, decltype(weight)> walk{xa, full, empty, d0, dstage, dpart,
                                            lane, weight};
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int v = 0; v < N / 2; ++v) msg[v] = 0.f;
      walk.all(K, j);
#pragma unroll
      for (int v = 0; v < N / 2; ++v)
        m_sm[acc_row(v) * mstride + c * N + acc_col(v)] = msg[v];
    }

    // ---- scatter the tile's messages into the part's row sums, while the
    // next tile's h lands (every thread is done with this one's) ----
    warpgroup_sync(0);
    if (next < t_hi)
      prefetch_h(hs, h, blk0 + static_cast<long>(next) * kTile, K, hstride);
    if (compact) {
      for (int o = tid; o < c_out; o += kWarpgroup) {
        int cur = -1;
        float run = 0.f;
        for (int s = 0; s < kTile; ++s) {
          const int r = srow[s];
          if (r != cur) {
            if (cur >= 0) acc_sm[cur * c_out + o] += run;
            cur = r;
            run = 0.f;
          }
          if (r >= 0) run += m_sm[s * mstride + o];
        }
        if (cur >= 0) acc_sm[cur * c_out + o] += run;
      }
    } else {
      const float* s_tile = s_dense + row_base * blk + static_cast<long>(t) * kTile;
      for (int e = tid; e < kRows * c_out; e += kWarpgroup) {
        const int r = e / c_out, o = e - r * c_out;
        float v = 0.f;
        for (int s = 0; s < kTile; ++s)
          v = fmaf(s_tile[static_cast<long>(r) * blk + s], m_sm[s * mstride + o], v);
        acc_sm[e] += v;
      }
    }
    t = next;
  }
  warpgroup_sync(0);

  // ---- the part's partial (the output itself when parts == 1) ----
  float* dst = out + (static_cast<long>(part) * gridDim.x * kRows + row_base) * c_out;
  for (int e = tid; e < kRows * c_out; e += kWarpgroup) {
    const float v = acc_sm[e];
    dst[e] = compact ? row_weight[row_base + e / c_out] * v : v;
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
  kernel<<<dim3(num_blocks, parts), kThreads, smem, stream>>>(
      h, x, senders_perm, image, slot_rows, row_weight, s_dense, out, blk, K,
      c_in, c_out, n_nodes);
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
  return with_shape(c_out, c_in, [&](auto n, auto s) {
    return blocks_on_sm(conv_fwd_f32_wgmma<decltype(n)::value, decltype(s)::value>,
                        kThreads, static_cast<size_t>(L.total));
  }, -1);
}

// Launches the float32 forward on `stream`: the stage image of w3 and b3,
// then the layer.  Pointers are device pointers; h, x, w3, b3, row_weight,
// s_dense and out float32; senders_perm and slot_rows int32; image bfloat16
// scratch [chunks][K+1][3][n][dp] (f32_wgmma.cuh Chunks(c_out, c_in), dp =
// c_in rounded up to 16), 16-byte aligned.  Exactly one of s_dense and
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
  return static_cast<int>(with_shape(c_out, c_in, [&](auto n, auto s) {
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
