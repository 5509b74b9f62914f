// Per-edge messages of the edge-conditioned conv, without the scatter, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/pallas_mp.py:fused_edge_messages
// and computes the same function, in float32:
//
//   W_e[i, o] = sum_k h[e, k] w3[k, i*c_out + o] + b3[i*c_out + o]
//   out[e, o] = sum_i x_src[e, i] W_e[i, o]
//
// Design.  The TPU kernel's layout (a reduction grid over c_in, a-major
// transposes of w3, b3 and x_src, E padded to its block) is dropped: this
// kernel reads w3 [K, c_in*c_out] and b3 in the model's layout and takes any
// E.  It is fused_edge_conv.cu's message stage (message_tile.cuh) without
// the scatter: out_e = [h_e (x) x_e, x_e] @ [[w3 as [K*c_in, c_out]], [b3 as
// [c_in, c_out]]], a GEMM whose left operand is generated in registers, so
// W_e never reaches device memory.  One thread block per 64-edge tile stages
// h^T (a row of ones appended for b3) and x_src^T in shared memory, streams
// w3 row by row (double-buffered, b3 after the last row) and keeps a 4-edge
// x OB register accumulator per thread; the last tile is masked.  Each
// output is written once, straight to [E, c_out]: no atomics.
//
// Bound.  Per edge 2 (K+1) c_in c_out operations against (K + c_in + c_out)
// 4 bytes; at K 48, width 48 that is ~226 kFLOP against 576 B, far above the
// H100's ridge, so the kernel is bounded by operations.  They run as float32
// FMAs on the CUDA cores: a correct first kernel, not a tensor-core one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_messages.so fused_edge_messages.cu

#include <cuda_runtime.h>

#include "message_tile.cuh"

namespace {

using namespace message_tile;

constexpr int kMaxK = 128;
constexpr int kMaxC = 4 * kTx;          // c_in, c_out <= 64
constexpr int kPad = kTx;               // slack after the w buffers

// OB = ceil(c_out / 16) output columns per thread.
template <int OB>
__global__ void __launch_bounds__(kThreads)
fused_edge_messages_kernel(const float* __restrict__ h,
                           const float* __restrict__ x_src,
                           const float* __restrict__ w3,
                           const float* __restrict__ b3,
                           float* __restrict__ out, long num_edges, int K,
                           int c_in, int c_out) {
  extern __shared__ __align__(16) float smem[];
  const int c2 = c_in * c_out;
  float* hT = smem;                        // [K+1][kTile], row K is all ones
  float* xT = hT + (K + 1) * kTile;        // [c_in][kTile]
  float* wbuf = xT + c_in * kTile;         // [2][c2] w3 rows, then b3

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const long e0 = static_cast<long>(blockIdx.x) * kTile;  // 64 edges a block
  const long left = num_edges - e0;
  const int n = left < kTile ? static_cast<int>(left) : kTile;

  // ---- stage the tile's operands; edges past the end read as 0 ----
  for (int e = tid; e < kTile * K; e += kThreads) {
    const int s = e / K, k = e - s * K;
    hT[k * kTile + s] = s < n ? h[e0 * K + e] : 0.f;
  }
  for (int s = tid; s < kTile; s += kThreads) hT[K * kTile + s] = 1.f;
  for (int e = tid; e < kTile * c_in; e += kThreads) {
    const int s = e / c_in, i = e - s * c_in;
    xT[i * kTile + s] = s < n ? x_src[e0 * c_in + e] : 0.f;
  }
  for (int j = tid; j < c2; j += kThreads) wbuf[j] = w3[j];
  __syncthreads();

  // ---- m[s, o] = sum_{k<=K, i} hT[k, s] xT[i, s] W~[k, i, o] ----
  // (columns o >= c_out read the slack after wbuf and are never stored)
  float m[kSlotsPerThread][OB];
  messages<float, OB>(hT, xT, wbuf, w3, b3, K, c_in, c_out, m);

#pragma unroll
  for (int a = 0; a < kSlotsPerThread; ++a) {
    const int s = ty * kSlotsPerThread + a;
    if (s >= n) continue;
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) {
      const int o = tx + ob * kTx;
      if (o < c_out) out[(e0 + s) * c_out + o] = m[a][ob];
    }
  }
}

template <int OB>
cudaError_t launch(const float* h, const float* x_src, const float* w3,
                   const float* b3, float* out, long num_edges, int K,
                   int c_in, int c_out, size_t smem, cudaStream_t stream) {
  auto kernel = fused_edge_messages_kernel<OB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long blocks = (num_edges + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      h, x_src, w3, b3, out, num_edges, K, c_in, c_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_messages_smem_bytes(int K, int c_in, int c_out) {
  return 4L * ((K + 1) * kTile + c_in * kTile + 2L * c_in * c_out + kPad);
}

// Launches the kernel on `stream`.  Pointers are device pointers to
// contiguous float32: h [E, K], x_src [E, c_in], w3 [K, c_in*c_out], b3
// [c_in*c_out], out [E, c_out].  Returns the cudaError_t of the launch (0 on
// success).
int fused_edge_messages_forward(const void* h, const void* x_src,
                                const void* w3, const void* b3, void* out,
                                int num_edges, int K, int c_in, int c_out,
                                void* stream) {
  if (num_edges < 1 || K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxC ||
      c_out < 1 || c_out > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(fused_edge_messages_smem_bytes(K, c_in, c_out));
  const float* hp = static_cast<const float*>(h);
  const float* xp = static_cast<const float*>(x_src);
  const float* wp = static_cast<const float*>(w3);
  const float* bp = static_cast<const float*>(b3);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((c_out + kTx - 1) / kTx) {
    case 1:
      err = launch<1>(hp, xp, wp, bp, op, num_edges, K, c_in, c_out, smem, s);
      break;
    case 2:
      err = launch<2>(hp, xp, wp, bp, op, num_edges, K, c_in, c_out, smem, s);
      break;
    case 3:
      err = launch<3>(hp, xp, wp, bp, op, num_edges, K, c_in, c_out, smem, s);
      break;
    default:
      err = launch<4>(hp, xp, wp, bp, op, num_edges, K, c_in, c_out, smem, s);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
