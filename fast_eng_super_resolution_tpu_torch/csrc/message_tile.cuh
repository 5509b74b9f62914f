// The message stage of fused_edge_conv.cu (B1's float32 instance): for one
// tile of 64 slots (edges) whose operands are staged in shared memory as
// float32,
//
//   m[s, o] = sum_{k <= K, i} hT[k, s] xT[i, s] W~[k, i, o],
//
// with hT [K+1][64] (row K all ones), xT [c_in][64] and W~ = [[w3], [b3]]
// seen as [K+1, c_in, c_out]: the GEMM [h (x) x, x] @ W~ whose left operand
// is formed in registers.  W~ is streamed row by row through the double
// buffer wbuf [2][c_in*c_out]; the caller stages row 0 (w3's first row) and
// synchronises before the call.  Thread (tx, ty) of the 16 x 16 block
// accumulates the slots 4 ty .. 4 ty + 3 and the columns tx + 16 ob,
// ob < OB = ceil(c_out / 16); columns o >= c_out read the next row or the
// memory after the buffer and are never to be stored.  Every thread leaves
// through a barrier, so the caller may overwrite shared memory next.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace message_tile {

constexpr int kTile = 64;               // slots per tile
constexpr int kTx = 16;                 // threads along c_out
constexpr int kTy = 16;                 // threads along slots
constexpr int kThreads = kTx * kTy;
constexpr int kSlotsPerThread = kTile / kTy;  // 4 (one float4)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int OB>
__device__ __forceinline__ void messages(const float* hT, const float* xT,
                                         float* wbuf, const T* __restrict__ w3,
                                         const float* __restrict__ b3, int K,
                                         int c_in, int c_out,
                                         float (&m)[kSlotsPerThread][OB]) {
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int c2 = c_in * c_out;
#pragma unroll
  for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) m[a][ob] = 0.f;

  for (int k = 0; k <= K; ++k) {
    const float* wcur = wbuf + (k & 1) * c2;
    if (k < K) {  // prefetch row k+1 (b3 after the last w3 row)
      float* wnext = wbuf + ((k + 1) & 1) * c2;
      if (k + 1 < K) {
        const T* src = w3 + static_cast<long>(k + 1) * c2;
        for (int j = tid; j < c2; j += kThreads) wnext[j] = to_f32(src[j]);
      } else {
        for (int j = tid; j < c2; j += kThreads) wnext[j] = b3[j];
      }
    }
    const float4 hv =
        *reinterpret_cast<const float4*>(&hT[k * kTile + ty * kSlotsPerThread]);
    for (int i = 0; i < c_in; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(
          &xT[i * kTile + ty * kSlotsPerThread]);
      const float z[kSlotsPerThread] = {hv.x * xv.x, hv.y * xv.y,
                                        hv.z * xv.z, hv.w * xv.w};
      const float* wrow = wcur + i * c_out + tx;
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) {
        const float w = wrow[ob * kTx];
#pragma unroll
        for (int a = 0; a < kSlotsPerThread; ++a) m[a][ob] += z[a] * w;
      }
    }
    __syncthreads();
  }
}

}  // namespace message_tile
