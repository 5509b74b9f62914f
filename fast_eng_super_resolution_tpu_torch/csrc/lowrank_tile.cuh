// The rank-r kernels' shared tile code (fused_edge_conv_lowrank.cu, B3, and
// fused_edge_conv_lowrank_bwd.cu, B4): per 64-slot tile, uv = [h, 1] @
// [[w3], [b3]] is formed in column chunks of at most kChunk columns, each
// chunk's w3 rows and b3 staged in shared memory and multiplied on a 4 x 8
// register tile per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lowrank_tile {

constexpr int kRows = 64;               // receiver rows per block (rows_blk)
constexpr int kTile = 64;               // slots per tile
constexpr int kTx = 16;                 // threads along columns
constexpr int kTy = 16;                 // threads along slots / rows
constexpr int kThreads = kTx * kTy;
constexpr int kSlotsPerThread = kTile / kTy;  // 4 (one float4)
constexpr int kChunk = 128;             // uv columns per chunk, at most
constexpr int kWStride = kChunk + 4;    // w3 chunk row stride (float4 rows)
constexpr int kUvStride = kChunk + 1;   // uv chunk row stride
constexpr int kMaxDim = 64;             // K, c_in, c_out <= 64
constexpr int kMaxRank = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// w[k, c] = w3[k, j0 + c] (k < K), b3[j0 + c] (k == K), 0 for c >= cw.
template <typename T>
__device__ __forceinline__ void stage_w(float* w, const T* __restrict__ w3,
                                        const float* __restrict__ b3, int K,
                                        int ncol, int j0, int cw) {
  for (int e = threadIdx.x; e < (K + 1) * kChunk; e += kThreads) {
    const int k = e / kChunk, c = e - k * kChunk;
    float v = 0.f;
    if (c < cw)
      v = k < K ? to_f32(w3[static_cast<long>(k) * ncol + j0 + c]) : b3[j0 + c];
    w[k * kWStride + c] = v;
  }
}

// uv[s, c] = sum_{k <= K} hT[k, s] w[k, c] for the tile's 64 slots and the
// chunk's cw columns.  Thread (tx, ty) owns slots 4 ty..4 ty+3 and columns
// 4 tx..4 tx+3 and 64 + 4 tx..64 + 4 tx+3.
__device__ __forceinline__ void uv_tile(const float* w, const float* hT,
                                        float* uv, int K, int cw) {
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  float acc[kSlotsPerThread][8];
#pragma unroll
  for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  for (int k = 0; k <= K; ++k) {
    const float4 hv =
        *reinterpret_cast<const float4*>(&hT[k * kTile + ty * kSlotsPerThread]);
    const float4 w0 = *reinterpret_cast<const float4*>(&w[k * kWStride + tx * 4]);
    const float4 w1 =
        *reinterpret_cast<const float4*>(&w[k * kWStride + 64 + tx * 4]);
    const float hr[kSlotsPerThread] = {hv.x, hv.y, hv.z, hv.w};
    const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] += hr[a] * wr[c];
  }
#pragma unroll
  for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4;
      if (col < cw) uv[(ty * kSlotsPerThread + a) * kUvStride + col] = acc[a][c];
    }
}

}  // namespace lowrank_tile
