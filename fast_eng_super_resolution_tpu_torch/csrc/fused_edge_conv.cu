// Fused edge-conditioned conv layer, forward: message + scatter-mean in one
// kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_edge_conv_jit
// for float32 operands and computes the same function (bfloat16 operands
// run fused_edge_conv_wgmma.cu, on the tensor cores).  Slots are the receiver-sorted edges,
// grouped host-side into num_blocks blocks of `blk` slots, block b holding
// the edges whose receivers lie in rows [64 b, 64 b + 64):
//
//   W_e[i, o]  = sum_k h[e, k] w3[k, i*c_out + o] + b3[i*c_out + o]
//   msg_e[o]   = sum_i x[senders_perm[e], i] W_e[i, o]
//   out[r, o]  = sum_{e in block(r)} S[r, e] msg_e[o]
//
// S is either dense ([num_blocks*64, blk] f32) or given by its generators
// (CompactS): S[64 b + r, e] = (slot_rows[e] == r) * row_weight[64 b + r],
// padding slots carrying slot_rows = -1.
//
// Design.  msg_e = [h_e (x) x_e, x_e] @ [[w3 as [K*c_in, c_out]], [b3 as
// [c_in, c_out]]]: a GEMM whose left operand, the outer product of the edge
// MLP's hidden features with the sender's features, is generated in
// registers and never stored.  W_e therefore never reaches device memory
// (the per-edge [c_in, c_out] matrices would be 9 KB per edge at width 48).
// One thread block owns one 64-row receiver block and walks its slots in
// tiles of 64: it gathers x[senders_perm] and h into shared memory, streams
// w3 row by row (double-buffered) through shared memory, forms the 64-slot
// message tile in registers (message_tile.cuh), and folds it into a
// per-thread [64, c_out] accumulator through the S tile — fixed summation
// order, no atomics, and each output row is written once (blocks partition
// the rows).  In CompactS
// mode a tile made only of padding slots is skipped.
//
// Bound.  Per real slot the layer needs 2*(K+1)*c_in*c_out operations and
// moves (K + c_in)*sizeof(T) + 8 bytes; at width 48 that is ~225 kFLOP
// against ~200 B, far above the H100's ~295 FLOP/B ridge in bf16, so the
// kernel is bounded by operations.  This float32 instance runs them as FMAs
// on the CUDA cores: a TF32 product would not meet the float32 parity
// checks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv.so fused_edge_conv.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "message_tile.cuh"

namespace {

using namespace message_tile;

constexpr int kRows = 64;               // receiver rows per block (rows_blk)
constexpr int kRowsPerThread = kRows / kTy;   // 4

// OB = ceil(c_out / 16) output columns per thread (c_out <= 64).
template <typename T, int OB>
__global__ void __launch_bounds__(kThreads)
fused_edge_conv_kernel(const T* __restrict__ h, const T* __restrict__ x,
                       const int* __restrict__ senders_perm,
                       const T* __restrict__ w3, const float* __restrict__ b3,
                       const int* __restrict__ slot_rows,
                       const float* __restrict__ row_weight,
                       const float* __restrict__ s_dense,
                       float* __restrict__ out, int blk, int K, int c_in,
                       int c_out, int n_nodes) {
  extern __shared__ __align__(16) float smem[];
  const int c2 = c_in * c_out;
  float* hT = smem;                        // [K+1][kTile], row K is all ones
  float* xT = hT + (K + 1) * kTile;        // [c_in][kTile]
  float* wbuf = xT + c_in * kTile;         // [2][c2] w3 rows, then b3
  float* s_sm = wbuf + 2 * c2;             // [kRows][kTile]
  float* msg_sm = s_sm + kRows * kTile;    // [kTile][c_out]

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int b = blockIdx.x;
  const long slot_base = static_cast<long>(b) * blk;
  const long row_base = static_cast<long>(b) * kRows;
  const bool compact = s_dense == nullptr;

  float acc[kRowsPerThread][OB];
#pragma unroll
  for (int ra = 0; ra < kRowsPerThread; ++ra)
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) acc[ra][ob] = 0.f;

  for (int t0 = 0; t0 < blk; t0 += kTile) {
    const long tile = slot_base + t0;
    if (compact) {
      int real = 0;
      if (tid < kTile) real = slot_rows[tile + tid] >= 0;
      if (!__syncthreads_or(real)) continue;  // padding-only tile
    }

    // ---- stage the tile's operands in shared memory (as float32) ----
    for (int e = tid; e < kTile * K; e += kThreads) {
      const int s = e / K, k = e - s * K;
      hT[k * kTile + s] = to_f32(h[(tile + s) * K + k]);
    }
    for (int s = tid; s < kTile; s += kThreads) hT[K * kTile + s] = 1.f;
    for (int e = tid; e < kTile * c_in; e += kThreads) {
      const int s = e / c_in, i = e - s * c_in;
      const int src = senders_perm[tile + s];
      xT[i * kTile + s] = (src >= 0 && src < n_nodes)
                              ? to_f32(x[static_cast<long>(src) * c_in + i])
                              : 0.f;
    }
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile, s = e - r * kTile;
      s_sm[e] = compact ? (slot_rows[tile + s] == r ? row_weight[row_base + r]
                                                    : 0.f)
                        : s_dense[(row_base + r) * blk + t0 + s];
    }
    for (int j = tid; j < c2; j += kThreads) wbuf[j] = to_f32(w3[j]);
    __syncthreads();

    // ---- message tile: m[s, o] = sum_{k<=K, i} hT[k, s] xT[i, s] W[k, i, o]
    // (columns o >= c_out read the S tile after wbuf and are never stored)
    float m[kSlotsPerThread][OB];
    messages<T, OB>(hT, xT, wbuf, w3, b3, K, c_in, c_out, m);

    // ---- scatter-mean: acc[r, o] += sum_s S[r, s] m[s, o] ----
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) {
        const int o = tx + ob * kTx;
        if (o < c_out) msg_sm[(ty * kSlotsPerThread + a) * c_out + o] = m[a][ob];
      }
    __syncthreads();
    for (int s = 0; s < kTile; ++s) {
      float mv[OB];
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) {
        const int o = tx + ob * kTx;
        mv[ob] = o < c_out ? msg_sm[s * c_out + o] : 0.f;
      }
#pragma unroll
      for (int ra = 0; ra < kRowsPerThread; ++ra) {
        const float sv = s_sm[(ty + ra * kTy) * kTile + s];
#pragma unroll
        for (int ob = 0; ob < OB; ++ob) acc[ra][ob] += sv * mv[ob];
      }
    }
    __syncthreads();  // the next tile overwrites shared memory
  }

#pragma unroll
  for (int ra = 0; ra < kRowsPerThread; ++ra)
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) {
      const int o = tx + ob * kTx;
      if (o < c_out)
        out[(row_base + ty + ra * kTy) * c_out + o] = acc[ra][ob];
    }
}

template <typename T, int OB>
cudaError_t launch(const void* h, const void* x, const void* senders_perm,
                   const void* w3, const void* b3, const void* slot_rows,
                   const void* row_weight, const void* s_dense, void* out,
                   int num_blocks, int blk, int K, int c_in, int c_out,
                   int n_nodes, size_t smem, cudaStream_t stream) {
  auto kernel = fused_edge_conv_kernel<T, OB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x),
      static_cast<const int*>(senders_perm), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
      static_cast<const float*>(row_weight),
      static_cast<const float*>(s_dense), static_cast<float*>(out), blk, K,
      c_in, c_out, n_nodes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int ob, const void* h, const void* x,
                     const void* senders_perm, const void* w3, const void* b3,
                     const void* slot_rows, const void* row_weight,
                     const void* s_dense, void* out, int num_blocks, int blk,
                     int K, int c_in, int c_out, int n_nodes, size_t smem,
                     cudaStream_t stream) {
  switch (ob) {
    case 1:
      return launch<T, 1>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out,
                          n_nodes, smem, stream);
    case 2:
      return launch<T, 2>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out,
                          n_nodes, smem, stream);
    case 3:
      return launch<T, 3>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out,
                          n_nodes, smem, stream);
    case 4:
      return launch<T, 4>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out,
                          n_nodes, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's limit before launching).
long fused_edge_conv_smem_bytes(int K, int c_in, int c_out) {
  return 4L * ((K + 1) * kTile + c_in * kTile + 2L * c_in * c_out +
               kRows * kTile + kTile * c_out);
}

// Launches the float32 forward on `stream`.  Pointers are device pointers to
// float32 data, senders_perm and slot_rows int32.  Exactly one of
// s_dense and (slot_rows, row_weight) is non-null.  blk must be a multiple
// of 64.  Returns the cudaError_t of the launch (0 on success).
int fused_edge_conv_forward(const void* h, const void* x,
                            const void* senders_perm, const void* w3,
                            const void* b3, const void* slot_rows,
                            const void* row_weight, const void* s_dense,
                            void* out, int num_blocks, int blk, int K,
                            int c_in, int c_out, int n_nodes, void* stream) {
  if (c_out < 1 || c_out > 4 * kTx || blk % kTile != 0 || num_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ob = (c_out + kTx - 1) / kTx;
  const size_t smem =
      static_cast<size_t>(fused_edge_conv_smem_bytes(K, c_in, c_out));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch<float>(ob, h, x, senders_perm, w3, b3,
                                          slot_rows, row_weight, s_dense, out,
                                          num_blocks, blk, K, c_in, c_out,
                                          n_nodes, smem, s));
}

}  // extern "C"
