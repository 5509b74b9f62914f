// Fused edge-conditioned conv layer, forward, in bfloat16 on Hopper's tensor
// cores (wgmma, sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_edge_conv_jit
// for bfloat16 operands (fused_edge_conv_f32_wgmma.cu is the float32
// instance) and computes the same function.  Slots are the receiver-sorted edges, grouped
// host-side into num_blocks blocks of `blk` slots, block b holding the edges
// whose receivers lie in rows [64 b, 64 b + 64):
//
//   W_e[i, o]  = sum_k h[e, k] w3[k, i*c_out + o] + b3[i*c_out + o]
//   msg_e[o]   = sum_i x[senders_perm[e], i] W_e[i, o]
//   out[r, o]  = sum_{e in block(r)} S[r, e] msg_e[o]
//
// with S dense ([num_blocks*64, blk] f32) or given by its CompactS generators
// (S[64 b + r, e] = (slot_rows[e] == r) row_weight[64 b + r], padding -1).
//
// Numbers.  h, x and w3 arrive as bfloat16 (the plain version,
// ops/fused_conv.py:fused_edge_conv_plain, rounds the same three); b3, S and
// every sum are float32.  The design keeps that contract by factoring:
//
//   msg_e = sum_k h[e, k] P_k[e] + x_src[e] @ B3,   P_k = X @ W3_k,
//
// X the tile's [64, c_in] gathered x rows and W3_k = w3[k] as [c_in, c_out].
// The tensor cores see only X and W3_k, values the plain version rounds
// too, and accumulate in float32; h[e, k] P_k and the b3 term (1/(K+1) of
// the work, b3 never rounded) run on the CUDA cores in float32.
//
// Design.  A block is one warpgroup and owns one part of one receiver
// block's slot walk (grid (num_blocks, parts); the wrapper's planner,
// ops/fused_conv.py:conv_parts, picks the parts from the SM count).  Per
// 64-slot tile it gathers X into shared memory in wgmma's K-major layout
// (wgmma_tile.cuh), stages h, and walks k: W3_k is the product's MN-major B
// operand, so w3's rows copy in 16-byte pieces by cp.async into a ring of
// three buffers (W3Row), two rows ahead of the running product (across the
// part's tiles: the last steps of a tile start the next tile's first rows).
// The tile's messages share their shared memory with X and h, which are
// dead by then.  At c_in = c_out = K = 128 a block takes 225 KB, one block
// per SM; at width 48 and K 48 47 KB.  The scatter is a segmented sum in
// CompactS form: each slot feeds one row, so a thread owning an output
// column adds the tile's 64 messages into its rows in slot order (64 c_out
// adds per tile); the dense form keeps the 64 x 64 S product.  Tiles of
// padding only are skipped in CompactS form.  Each part writes its own
// [64, c_out] partial (straight into the output when there is one part);
// the wrapper sums the partials in a fixed order.  No atomics: two launches
// on the same inputs give the same bits.
//
// Widths.  c_in, c_out and K 1..256.  N, the product's width (m64nNk16, N
// up to 128) and a template argument (with_wide_width), is c_out rounded up
// to 8 where the block's shared memory (Layout) holds it: every width up to
// 128 at K up to 128.  Else c_out is cut into column chunks (FwdChunks) of
// the widest N whose Layout fits, evened out, each chunk a block of its own
// (grid z) that copies w3's rows at its columns only and writes its columns
// of the output: at K = c_in = c_out = 256 five chunks of 56 columns (219
// KB a block), at c_in = c_out = 128 and K 256 two of 64.  The ring of
// W3_k^T and b3 grow with N times c_in, and the X and h tiles with c_in and
// K: what is left for N sets the chunks.
//
// Bound.  Per real slot the layer needs 2 (K+1) c_in c_out operations and
// moves (K + c_in) 2 + 8 bytes: at width 48 about 225 kFLOP against 200 B,
// far above the card's ridge of about 295 FLOP/B in bf16, so it is bounded
// by operations on the tensor cores (989 TFLOP/s dense bf16).  What stands in
// the way here: w3 is read from L2 once per tile (c_in c_out 2 bytes per k),
// and the h-weighted sum and the scatter run on the CUDA cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_wgmma.so fused_edge_conv_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_tile.cuh"

namespace {

using namespace wgmma_tile;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;   // receiver rows per block (rows_blk)
constexpr int kTile = 64;   // slots per tile
constexpr int kMaxDim = 256;
constexpr int kMaxK = 256;

// Row stride of the staged h tile in bf16 elements: at least K and 2 mod 4,
// so that the 8 rows a warp reads at one k fall in 8 different banks.
__host__ __device__ inline int h_stride(int K) { return K + (6 - K % 4) % 4; }

// Byte offsets of the shared-memory regions, np = the chunk's columns
// padded to 8 and cols the columns a block writes (c_out, or a chunk's).
// X and h, read by a tile's walk over k, and the tile's messages, written
// after it, share the first region.
struct Layout {
  int dp, hs;
  long h, b, b3, acc, srow, total;
  __host__ __device__ Layout(int K, int c_in, int cols, int np) {
    dp = round_up(c_in, 16);
    hs = h_stride(K);
    h = 2L * kTile * dp;                     // X [64][dp] at 0
    const long xh = h + 2L * kTile * hs;     // h [64][hs]
    const long m = 4L * kTile * (np + 1);    // or messages [64][np+1] f32
    b = xh > m ? xh : m;                     // W3_k^T [kRowBufs][np][dp]
    b3 = b + 2L * kRowBufs * np * dp;
    acc = b3 + 4L * c_in * np;               // b3 [c_in][np] f32
    srow = acc + 4L * kRows * cols;          // part sums [64][cols] f32
    total = srow + 4L * kTile;               // slot_rows of the tile
  }
};

// The column chunks of c_out: `chunks` of n columns (a multiple of 8, at
// most 128), one chunk of all of them where its Layout fits a block (every
// width up to 128 at K up to 128), else the widest n that fits, evened out
// over the chunks (ops/fused_conv.py:wgmma_fwd_chunks).
struct FwdChunks {
  int chunks, n;
  __host__ __device__ FwdChunks(int K, int c_in, int c_out) {
    const int r8 = round_up(c_out, 8);
    int most = r8 < 128 ? r8 : 128;
    while (most > 8 &&
           Layout(K, c_in, most < c_out ? most : c_out, most).total > kSmemMax)
      most -= 8;
    chunks = (r8 + most - 1) / most;
    n = round_up((r8 + chunks - 1) / chunks, 8);
  }
  // the columns a block writes at most
  __host__ __device__ int cols(int c_out) const { return n < c_out ? n : c_out; }
};

// NP = the chunk's columns padded to 8.  Block (b, part, z) walks part
// `part` of receiver block b's tiles for the columns z NP .. of c_out.
template <int NP>
__global__ void __launch_bounds__(kWarpgroup)
conv_fwd_wgmma(const bf16* __restrict__ h, const bf16* __restrict__ x,
               const int* __restrict__ senders_perm,
               const bf16* __restrict__ w3, const float* __restrict__ b3,
               const int* __restrict__ slot_rows,
               const float* __restrict__ row_weight,
               const float* __restrict__ s_dense, float* __restrict__ out,
               int blk, int K, int c_in, int c_out, int n_nodes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.z * NP;  // the block's first column and columns
  const int cols = c_out - c0 < NP ? c_out - c0 : NP;
  const Layout L(K, c_in, c_out < NP ? c_out : NP, NP);
  const int dp = L.dp, hs = L.hs;
  bf16* a_sm = reinterpret_cast<bf16*>(smem);
  bf16* b_sm = reinterpret_cast<bf16*>(smem + L.b);
  bf16* h_sm = reinterpret_cast<bf16*>(smem + L.h);
  float* b3_sm = reinterpret_cast<float*>(smem + L.b3);
  float* m_sm = reinterpret_cast<float*>(smem);  // after the walk over k
  float* acc_sm = reinterpret_cast<float*>(smem + L.acc);
  int* srow = reinterpret_cast<int*>(smem + L.srow);

  const int tid = threadIdx.x;
  const int b = blockIdx.x, part = blockIdx.y, parts = gridDim.y;
  const int tiles = blk / kTile;
  const int t_lo = part * tiles / parts, t_hi = (part + 1) * tiles / parts;
  const long row_base = static_cast<long>(b) * kRows;
  const bool compact = s_dense == nullptr;
  const bf16 zero = __float2bfloat16(0.f);

  // padding of the W3 buffers stays zero: staging writes real entries only
  for (int e = tid; e < kRowBufs * NP * dp; e += kWarpgroup) b_sm[e] = zero;
  for (int e = tid; e < c_in * NP; e += kWarpgroup) {
    const int i = e / NP, o = e - i * NP;
    b3_sm[e] = o < cols ? b3[i * c_out + c0 + o] : 0.f;
  }
  for (int e = tid; e < kRows * cols; e += kWarpgroup) acc_sm[e] = 0.f;
  __syncthreads();  // the zeros land before the first row

  // W3_k^T ([cols, c_in], MN-major: w3's rows copy in 16-byte pieces)
  // streams through the three buffers in one sequence of steps over the
  // part's tiles, k = 0 .. K-1 per tile: step n reads buffer n % 3 while
  // rows n + 1 and n + 2 (mod K) land in the other two.
  const int bsize = NP * dp;
  const W3Row<true> wr(w3 + c0, c_in, cols, c_out, dp);
  wr.start(b_sm, 0);
  wr.start(b_sm + bsize, 1 % K);
  pieces_wait<1>();  // row 0 has landed
  int step = 0;

  const int r0 = acc_row(0);
  for (int t = t_lo; t < t_hi; ++t) {
    const long tile = static_cast<long>(b) * blk + static_cast<long>(t) * kTile;
    if (compact) {
      int real = 0;
      if (tid < kTile) {
        srow[tid] = slot_rows[tile + tid];
        real = srow[tid] >= 0;
      }
      if (!__syncthreads_or(real)) continue;  // padding only
    }

    // ---- stage X (gathered, channels tid % 64 + 64 m of slots tid / 64 +
    // 2 m') and h; W3_0 has landed in buffer step % 3 ----
    if ((tid & 63) < dp) {
#pragma unroll 4
      for (int s = tid >> 6; s < kTile; s += 2) {
        const int src = senders_perm[tile + s];
        const bool real = src >= 0 && src < n_nodes;
        for (int i = tid & 63; i < dp; i += 64)
          a_sm[kmajor(s, i, dp)] =
              real && i < c_in ? x[static_cast<long>(src) * c_in + i] : zero;
      }
    }
#pragma unroll 4
    for (int s = tid >> 6; s < kTile; s += 2)
      for (int k = tid & 63; k < K; k += 64)
        h_sm[s * hs + k] = h[(tile + s) * K + k];
    fence_async_smem();
    __syncthreads();

    // ---- msg = X @ B3 (CUDA cores), then += h[:, k] P_k over k ----
    float msg[NP / 2];
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) msg[j] = 0.f;
    for (int i = 0; i < c_in; ++i) {
      const float xa = __bfloat162float(a_sm[kmajor(r0, i, dp)]);
      const float xb = __bfloat162float(a_sm[kmajor(r0 + 8, i, dp)]);
#pragma unroll
      for (int j = 0; j < NP / 2; ++j)
        msg[j] += ((j >> 1) & 1 ? xb : xa) * b3_sm[i * NP + acc_col(j)];
    }
    for (int k = 0; k < K; ++k, ++step) {
      float p[NP / 2];
      product<NP, 1>(p, a_sm, b_sm + (step % kRowBufs) * bsize, dp);
      // the row two steps on (k + 2, or the next tile's), into the buffer
      // that step - 1's finished product read
      wr.start(b_sm + ((step + 2) % kRowBufs) * bsize, (k + 2) % K);
      wait_all();
      fence_operand(p);
      const float ha = __bfloat162float(h_sm[r0 * hs + k]);
      const float hb = __bfloat162float(h_sm[(r0 + 8) * hs + k]);
#pragma unroll
      for (int j = 0; j < NP / 2; ++j) msg[j] += ((j >> 1) & 1 ? hb : ha) * p[j];
      pieces_wait<1>();  // the next step's row has landed
      fence_async_smem();
      __syncthreads();
    }

    // ---- scatter the tile's messages into the part's row sums (X and h
    // are dead: every thread passed the last step's barrier) ----
#pragma unroll
    for (int j = 0; j < NP / 2; ++j)
      m_sm[acc_row(j) * (NP + 1) + acc_col(j)] = msg[j];
    __syncthreads();
    if (compact) {
      for (int o = tid; o < cols; o += kWarpgroup)
        for (int s = 0; s < kTile; ++s) {
          const int r = srow[s];
          if (r >= 0) acc_sm[r * cols + o] += m_sm[s * (NP + 1) + o];
        }
    } else {
      const float* s_tile = s_dense + row_base * blk + static_cast<long>(t) * kTile;
      for (int e = tid; e < kRows * cols; e += kWarpgroup) {
        const int r = e / cols, o = e - r * cols;
        float v = 0.f;
        for (int s = 0; s < kTile; ++s)
          v += s_tile[static_cast<long>(r) * blk + s] * m_sm[s * (NP + 1) + o];
        acc_sm[e] += v;
      }
    }
    __syncthreads();  // the next tile overwrites srow and the operands
  }

  // ---- the block's columns of the part's partial (the output itself
  // when parts == 1) ----
  float* dst = out + (static_cast<long>(part) * gridDim.x * kRows + row_base) * c_out + c0;
  for (int e = tid; e < kRows * cols; e += kWarpgroup) {
    const int r = e / cols;
    const float v = acc_sm[e];
    dst[r * c_out + e - r * cols] = compact ? row_weight[row_base + r] * v : v;
  }
}

template <int NP>
cudaError_t launch(const void* h, const void* x, const void* senders_perm,
                   const void* w3, const void* b3, const void* slot_rows,
                   const void* row_weight, const void* s_dense, void* out,
                   int num_blocks, int blk, int K, int c_in, int c_out,
                   int n_nodes, int parts, int chunks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(
      Layout(K, c_in, c_out < NP ? c_out : NP, NP).total);
  auto kernel = conv_fwd_wgmma<NP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(num_blocks, parts, chunks), kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(x),
      static_cast<const int*>(senders_perm), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
      static_cast<const float*>(row_weight),
      static_cast<const float*>(s_dense), static_cast<float*>(out), blk, K,
      c_in, c_out, n_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_conv_wgmma_smem_bytes(int K, int c_in, int c_out) {
  const FwdChunks ch(K, c_in, c_out);
  return Layout(K, c_in, ch.cols(c_out), ch.n).total;
}

// Blocks one SM holds at once at these widths (-1 if they are not taken).
int fused_edge_conv_wgmma_blocks_per_sm(int K, int c_in, int c_out) {
  const FwdChunks ch(K, c_in, c_out);
  return with_wide_width(ch.n, [&](auto n) {
    return blocks_per_sm(
        conv_fwd_wgmma<decltype(n)::value>,
        static_cast<size_t>(Layout(K, c_in, ch.cols(c_out), ch.n).total));
  }, -1);
}

// Launches the bfloat16 forward on `stream`.  Pointers are device pointers;
// h, x and w3 bfloat16; b3, row_weight, s_dense and out float32;
// senders_perm and slot_rows int32.  Exactly one of s_dense and (slot_rows,
// row_weight) is non-null.  out is [num_blocks*64, c_out] when parts == 1,
// else the partials [parts, num_blocks*64, c_out].  Returns the cudaError_t
// of the launch (0 on success).
int fused_edge_conv_wgmma_forward(const void* h, const void* x,
                                  const void* senders_perm, const void* w3,
                                  const void* b3, const void* slot_rows,
                                  const void* row_weight, const void* s_dense,
                                  void* out, int num_blocks, int blk, int K,
                                  int c_in, int c_out, int n_nodes, int parts,
                                  void* stream) {
  if (K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      parts < 1 || parts > blk / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdChunks ch(K, c_in, c_out);
  return static_cast<int>(with_wide_width(ch.n, [&](auto n) {
    return launch<decltype(n)::value>(h, x, senders_perm, w3, b3, slot_rows,
                                      row_weight, s_dense, out, num_blocks, blk,
                                      K, c_in, c_out, n_nodes, parts,
                                      ch.chunks, s);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
