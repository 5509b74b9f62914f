// Fused edge-conditioned conv layer, backward: the gradients of
// fused_edge_conv.cu's forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_edge_conv_bwd_jit
// for float32 operands and computes the same function (bfloat16 operands
// run fused_edge_conv_bwd_wgmma.cu, on the tensor cores).  With the forward's notation (slots in
// blocks of `blk`, block b feeding receiver rows [64 b, 64 b + 64)), g the
// gradient of the forward's output, h~ = [h, 1] and W~ = [[w3], [b3]] seen as
// [K+1, c_in, c_out]:
//
//   dmsg[e, o]   = sum_r S[r, e] g[r, o]                  (0 on padding)
//   dh[e, k]     = sum_{i,o} x_src[e, i] dmsg[e, o] w3[k, i*c_out + o]
//   dx_src[e, i] = sum_{k<=K, o} h~[e, k] dmsg[e, o] W~[k, i, o]
//   dw3[k, i*c_out + o] = sum_e h[e, k] x_src[e, i] dmsg[e, o]
//   db3[i*c_out + o]    = sum_e x_src[e, i] dmsg[e, o]
//
// In CompactS form S[64 b + r, e] = (slot_rows[e] == r) row_weight[64 b + r].
// h, x_src, w3 and dmsg are rounded to the GEMM input type T; everything
// else is float32, as in the plain version (ops/fused_conv.py:
// fused_edge_conv_bwd_plain), which rounds at the same points.
//
// Design.  All three products are GEMMs whose left operand is an outer
// product per slot (x_src (x) dmsg for dh and dw3, h~ (x) dmsg for dx_src);
// the products are formed in registers, tile by tile, and never stored, so
// the per-slot [c_in, c_out] matrices never reach device memory.  dh and
// dx_src contract dmsg first (t = sum_o dmsg W, one FMA per term) and scale
// by x_src or h~ once per channel.  Two launches:
//
//  (a) rows kernel: one thread block per 64-row receiver block, walking its
//      slots in tiles of 64.  Per tile it forms dmsg (from the block's g rows
//      and the S tile or generators), writes it to a scratch buffer, then
//      computes dh (streaming w3 in [64, c_out] column chunks, one per input
//      channel and part of at most 64 rows of K, so that a thread holds at
//      most 4 columns of dh at any K up to 128) and dx_src (streaming W~ row
//      by row), both double-buffered through shared memory.  Nothing is
//      carried across blocks; tiles of padding only are skipped in CompactS
//      mode (their gradients are 0).
//  (b) weights kernel: dw3 and db3 together as one [(K+1), c2] split-K GEMM
//      h~^T (x_src (x) dmsg) over the slots, on a grid of output tiles
//      [rows of one K part, 4 input channels, c_out] x slot splits, the K
//      parts holding at most 64 rows of w3 each (the last one also the b3
//      row), so that a tile's register accumulator stays the same size up to
//      K = 128.  Each split writes its own partial; the wrapper sums the
//      partials in a fixed order (no atomics: the result is the same on
//      every run).  The whole [(K+1), c2] accumulator (451 KB at width 48)
//      would not fit one SM.
//
// Bound.  Per real slot the backward needs about 3 x 2 (K+1) c_in c_out
// operations (three GEMMs of the forward's size) and moves (K + c_in) sizeof(T)
// + c_out 4 + (K + c_in) 4 bytes; at width 48 that is ~680 kFLOP against
// ~600 B, far above the card's ridge, so it is bounded by operations.  This
// float32 instance runs them as FMAs on the CUDA cores: a TF32 product would
// not meet the float32 parity checks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_bwd.so fused_edge_conv_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;               // receiver rows per block (rows_blk)
constexpr int kTile = 64;               // slots per tile
constexpr int kTx = 16;                 // threads along the output columns
constexpr int kTy = 16;                 // threads along slots
constexpr int kThreads = kTx * kTy;
constexpr int kSlotsPerThread = kTile / kTy;  // 4 (one float4)
constexpr int kMaxDim = 4 * kTx;        // c_in, c_out <= 64; K parts of <= 64
constexpr int kMaxK = 2 * kMaxDim;      // K <= 128
constexpr int kPad = kMaxDim;           // shared-memory slack after the w buffers
constexpr int kIn = 4;                  // weights kernel: input channels per block

__device__ __forceinline__ float to_f32(float v) { return v; }

// A float32 rounded to T and widened back (T is float32 only here: the
// bfloat16 instance is fused_edge_conv_bwd_wgmma.cu).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

// Rows of K in one part: K split into ceil(K / 64) parts of equal size.
__host__ __device__ inline int k_part(int K) {
  const int parts = (K + kMaxDim - 1) / kMaxDim;
  return (K + parts - 1) / parts;
}

__host__ __device__ inline int w_len(int K, int c_in, int c_out) {
  const int kp = k_part(K);
  return (kp > c_in ? kp : c_in) * c_out;
}

// ---------------------------------------------------------------------------
// (a) dmsg, dh and dx_src, one thread block per 64-row receiver block.
// CB = ceil(max(k_part(K), c_in) / 16) output columns per thread.
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const float* __restrict__ g, const T* __restrict__ h,
                const T* __restrict__ x_src, const T* __restrict__ w3,
                const float* __restrict__ b3,
                const int* __restrict__ slot_rows,
                const float* __restrict__ row_weight,
                const float* __restrict__ s_dense, float* __restrict__ dh,
                float* __restrict__ dx_src, float* __restrict__ dmsg_out,
                int blk, int K, int c_in, int c_out) {
  extern __shared__ __align__(16) float smem[];
  const int c2 = c_in * c_out;
  const int wlen = w_len(K, c_in, c_out);
  const int kp = k_part(K);
  float* g_sm = smem;                      // [kRows][c_out]
  float* s_sm = g_sm + kRows * c_out;      // [kRows][kTile] dense S tile
  float* dT = s_sm + kRows * kTile;        // [c_out][kTile] dmsg
  float* xT = dT + c_out * kTile;          // [c_in][kTile]
  float* hT = xT + c_in * kTile;           // [K+1][kTile], row K all ones
  float* wbuf = hT + (K + 1) * kTile;      // [2][wlen] (+ kPad slack)

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int b = blockIdx.x;
  const long slot_base = static_cast<long>(b) * blk;
  const long row_base = static_cast<long>(b) * kRows;
  const bool compact = s_dense == nullptr;

  // the block's g rows; in CompactS form with the row weight folded in, so
  // that dmsg[e] = g_sm[slot_rows[e]] is the same float32 product S[r, e] g[r]
  for (int e = tid; e < kRows * c_out; e += kThreads) {
    const float v = g[row_base * c_out + e];
    g_sm[e] = compact ? row_weight[row_base + e / c_out] * v : v;
  }
  __syncthreads();

  for (int t0 = 0; t0 < blk; t0 += kTile) {
    const long tile = slot_base + t0;
    if (compact) {
      int real = 0;
      if (tid < kTile) real = slot_rows[tile + tid] >= 0;
      if (!__syncthreads_or(real)) {  // padding only: every gradient is 0
        for (int e = tid; e < kTile * K; e += kThreads) dh[tile * K + e] = 0.f;
        for (int e = tid; e < kTile * c_in; e += kThreads)
          dx_src[tile * c_in + e] = 0.f;
        for (int e = tid; e < kTile * c_out; e += kThreads)
          dmsg_out[tile * c_out + e] = 0.f;
        continue;
      }
    }

    // ---- stage the tile's operands (as float32) ----
    if (!compact) {
      for (int e = tid; e < kRows * kTile; e += kThreads) {
        const int r = e / kTile, s = e - r * kTile;
        s_sm[e] = s_dense[(row_base + r) * blk + t0 + s];
      }
    }
    for (int e = tid; e < kTile * K; e += kThreads) {
      const int s = e / K, k = e - s * K;
      hT[k * kTile + s] = to_f32(h[(tile + s) * K + k]);
    }
    for (int s = tid; s < kTile; s += kThreads) hT[K * kTile + s] = 1.f;
    for (int e = tid; e < kTile * c_in; e += kThreads) {
      const int s = e / c_in, i = e - s * c_in;
      xT[i * kTile + s] = to_f32(x_src[(tile + s) * c_in + i]);
    }
    __syncthreads();

    // ---- dmsg = S^T g for the tile's slots, rounded to T ----
    for (int e = tid; e < kTile * c_out; e += kThreads) {
      const int s = e / c_out, o = e - s * c_out;
      float v = 0.f;
      if (compact) {
        const int r = slot_rows[tile + s];
        if (r >= 0) v = g_sm[r * c_out + o];
      } else {
        for (int r = 0; r < kRows; ++r)
          v += s_sm[r * kTile + s] * g_sm[r * c_out + o];
      }
      v = round_to<T>(v);
      dT[o * kTile + s] = v;
      dmsg_out[(tile + s) * c_out + o] = v;
    }

    float acc[kSlotsPerThread][CB];

    // ---- dh[s, k] = sum_{i, o} x[s, i] dmsg[s, o] w3[k, i*c_out + o],
    //      for the rows k0 <= k < k0 + kn of one part of K at a time ----
    for (int k0 = 0; k0 < K; k0 += kp) {
      const int kn = K - k0 < kp ? K - k0 : kp;
      // the part's first w3 column chunk: wbuf[o*kn + k] = w3[k0 + k, o]
      // (input channel 0); the previous part's last reads ended at a barrier
      for (int j = tid; j < kn * c_out; j += kThreads) {
        const int k = j / c_out, o = j - k * c_out;
        wbuf[o * kn + k] = to_f32(w3[static_cast<long>(k0 + k) * c2 + o]);
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) acc[a][cb] = 0.f;
      for (int i = 0; i < c_in; ++i) {
        const float* wcur = wbuf + (i & 1) * wlen;
        if (i + 1 < c_in) {  // prefetch input channel i+1's [kn, c_out] chunk
          float* wnext = wbuf + ((i + 1) & 1) * wlen;
          for (int j = tid; j < kn * c_out; j += kThreads) {
            const int k = j / c_out, o = j - k * c_out;
            wnext[o * kn + k] = to_f32(
                w3[static_cast<long>(k0 + k) * c2 + (i + 1) * c_out + o]);
          }
        }
        // t[s, k] = sum_o dmsg[s, o] w3[k0 + k, i*c_out + o]; dh += x[s, i] t
        float t[kSlotsPerThread][CB];
#pragma unroll
        for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) t[a][cb] = 0.f;
        for (int o = 0; o < c_out; ++o) {
          const float4 dv = *reinterpret_cast<const float4*>(
              &dT[o * kTile + ty * kSlotsPerThread]);
          const float d[kSlotsPerThread] = {dv.x, dv.y, dv.z, dv.w};
          // columns k >= kn read neighbouring shared memory, never stored
          const float* wrow = wcur + o * kn + tx;
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) {
            const float w = wrow[cb * kTx];
#pragma unroll
            for (int a = 0; a < kSlotsPerThread; ++a) t[a][cb] += d[a] * w;
          }
        }
        const float4 xv = *reinterpret_cast<const float4*>(
            &xT[i * kTile + ty * kSlotsPerThread]);
        const float xr[kSlotsPerThread] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
          for (int cb = 0; cb < CB; ++cb) acc[a][cb] += xr[a] * t[a][cb];
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          const int k = tx + cb * kTx;
          if (k < kn)
            dh[(tile + ty * kSlotsPerThread + a) * K + k0 + k] = acc[a][cb];
        }
    }

    // ---- dx[s, i] = sum_{k <= K, o} h~[s, k] dmsg[s, o] W~[k, i, o] ----
    // wbuf[o*c_in + i] = W~[k, i, o]: row k of w3 (b3 for k == K), transposed
    for (int j = tid; j < c2; j += kThreads) {
      const int i = j / c_out, o = j - i * c_out;
      wbuf[o * c_in + i] = K > 0 ? to_f32(w3[j]) : b3[j];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) acc[a][cb] = 0.f;
    for (int k = 0; k <= K; ++k) {
      const float* wcur = wbuf + (k & 1) * wlen;
      if (k < K) {  // prefetch row k+1 (b3 after the last w3 row)
        float* wnext = wbuf + ((k + 1) & 1) * wlen;
        const bool bias = k + 1 == K;
        for (int j = tid; j < c2; j += kThreads) {
          const int i = j / c_out, o = j - i * c_out;
          wnext[o * c_in + i] =
              bias ? b3[j] : to_f32(w3[static_cast<long>(k + 1) * c2 + j]);
        }
      }
      // t[s, i] = sum_o dmsg[s, o] W~[k, i, o]; dx += h~[s, k] t
      float t[kSlotsPerThread][CB];
#pragma unroll
      for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) t[a][cb] = 0.f;
      for (int o = 0; o < c_out; ++o) {
        const float4 dv = *reinterpret_cast<const float4*>(
            &dT[o * kTile + ty * kSlotsPerThread]);
        const float d[kSlotsPerThread] = {dv.x, dv.y, dv.z, dv.w};
        const float* wrow = wcur + o * c_in + tx;
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          const float w = wrow[cb * kTx];
#pragma unroll
          for (int a = 0; a < kSlotsPerThread; ++a) t[a][cb] += d[a] * w;
        }
      }
      const float4 hv =
          *reinterpret_cast<const float4*>(&hT[k * kTile + ty * kSlotsPerThread]);
      const float hr[kSlotsPerThread] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) acc[a][cb] += hr[a] * t[a][cb];
      __syncthreads();  // also: the next tile overwrites shared memory
    }
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const int i = tx + cb * kTx;
        if (i < c_in)
          dx_src[(tile + ty * kSlotsPerThread + a) * c_in + i] = acc[a][cb];
      }
  }
}

// ---------------------------------------------------------------------------
// (b) partial[split, k, i*c_out + o] = sum over the split's slots e of
//     h~[e, k] x_src[e, i] dmsg[e, o],  k <= K (k == K: db3).
// Grid: (ceil(c_in / kIn), num_splits, parts of K).  A block owns the rows
// of h~ in one part of K (the last part also k == K, the b3 row) and every
// o for kIn input channels: per 64-slot chunk it copies the part's columns
// of h~, x_src's kIn columns and dmsg into shared memory (contiguous rows),
// and each thread accumulates KB of the part's rows ty + 16 a  x  kIn channels
// x  OB columns o = tx + 16 b, forming x * dmsg once per (i, o) and reusing
// it for its KB rows: KB*kIn*OB FMAs per KB + 1 + OB shared-memory loads
// per slot.
template <typename T, int KB, int OB>
__global__ void __launch_bounds__(kThreads)
bwd_weights_kernel(const T* __restrict__ h, const T* __restrict__ x_src,
                   const float* __restrict__ dmsg,
                   const int* __restrict__ slot_rows,
                   float* __restrict__ partial, long num_chunks,
                   long chunks_per_split, int K, int c_in, int c_out) {
  constexpr int kRowsK = KB * kTy;         // k rows held: the part's, then 0
  __shared__ __align__(16) float a_sm[kTile][kRowsK];      // h~
  __shared__ __align__(16) float x_sm[kTile][kIn];         // x_src[:, i0:]
  __shared__ __align__(16) float d_sm[kTile * kMaxDim + kPad];  // dmsg
  const int c2 = c_in * c_out;
  const int i0 = blockIdx.x * kIn;
  const long split = blockIdx.y;
  // the part's nh columns of h from column k0 on; the last part also holds
  // the b3 row (k == K) at a_sm column nh, the others no bias column (-1)
  const int kp = k_part(K);
  const int k0 = static_cast<int>(blockIdx.z) * kp;
  const T* hp = h + k0;
  const int nh = K - k0 < kp ? K - k0 : kp;
  const int bias_col = k0 + kp >= K ? nh : -1;
  const long c_lo = split * chunks_per_split;
  const long c_hi = c_lo + chunks_per_split < num_chunks
                        ? c_lo + chunks_per_split
                        : num_chunks;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;

  float acc[KB][kIn][OB];
#pragma unroll
  for (int a = 0; a < KB; ++a)
#pragma unroll
    for (int ii = 0; ii < kIn; ++ii)
#pragma unroll
      for (int b = 0; b < OB; ++b) acc[a][ii][b] = 0.f;

  for (long ch = c_lo; ch < c_hi; ++ch) {
    const long s0 = ch * kTile;
    if (slot_rows != nullptr) {  // CompactS: skip chunks of padding only
      int real = 0;
      if (tid < kTile) real = slot_rows[s0 + tid] >= 0;
      if (!__syncthreads_or(real)) continue;
    }
    for (int e = tid; e < kTile * kRowsK; e += kThreads) {
      const int s = e / kRowsK, k = e - s * kRowsK;
      a_sm[s][k] = k < nh ? to_f32(hp[(s0 + s) * K + k])
                          : (k == bias_col ? 1.f : 0.f);
    }
    for (int e = tid; e < kTile * kIn; e += kThreads) {
      const int s = e / kIn, ii = e - s * kIn;
      x_sm[s][ii] = i0 + ii < c_in ? to_f32(x_src[(s0 + s) * c_in + i0 + ii])
                                   : 0.f;
    }
    const float* dsrc = dmsg + s0 * c_out;
    for (int e = tid; e < kTile * c_out; e += kThreads) d_sm[e] = dsrc[e];
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < kTile; ++s) {
      float hv[KB];
#pragma unroll
      for (int a = 0; a < KB; ++a) hv[a] = a_sm[s][ty + a * kTy];
      const float4 xv = *reinterpret_cast<const float4*>(&x_sm[s][0]);
      const float xr[kIn] = {xv.x, xv.y, xv.z, xv.w};
      // columns o >= c_out read neighbouring shared memory, never stored
      float dv[OB];
#pragma unroll
      for (int b = 0; b < OB; ++b) dv[b] = d_sm[s * c_out + tx + b * kTx];
#pragma unroll
      for (int ii = 0; ii < kIn; ++ii)
#pragma unroll
        for (int b = 0; b < OB; ++b) {
          const float y = xr[ii] * dv[b];
#pragma unroll
          for (int a = 0; a < KB; ++a) acc[a][ii][b] += hv[a] * y;
        }
    }
    __syncthreads();
  }

  const int kn = bias_col >= 0 ? nh + 1 : nh;
#pragma unroll
  for (int a = 0; a < KB; ++a) {
    const int kk = ty + a * kTy;
    if (kk >= kn) continue;
    const int k = k0 + kk;
#pragma unroll
    for (int ii = 0; ii < kIn; ++ii) {
      if (i0 + ii >= c_in) continue;
#pragma unroll
      for (int b = 0; b < OB; ++b) {
        const int o = tx + b * kTx;
        if (o < c_out)
          partial[(split * (K + 1) + k) * c2 + (i0 + ii) * c_out + o] =
              acc[a][ii][b];
      }
    }
  }
}

template <typename T, int KB, int OB>
cudaError_t launch_weights(const void* h, const void* x_src, const void* dmsg,
                           const void* slot_rows, void* partial,
                           long num_chunks, int num_splits, int K, int c_in,
                           int c_out, cudaStream_t stream) {
  const long per_split = (num_chunks + num_splits - 1) / num_splits;
  const dim3 grid((c_in + kIn - 1) / kIn, num_splits,
                  (K + kMaxDim - 1) / kMaxDim);
  bwd_weights_kernel<T, KB, OB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x_src),
      static_cast<const float*>(dmsg), static_cast<const int*>(slot_rows),
      static_cast<float*>(partial), num_chunks, per_split, K, c_in, c_out);
  return cudaGetLastError();
}

// KB = ceil((k_part(K)+1) / 16) in 1..5, OB = ceil(c_out / 16) in 1..4.
template <typename T, int KB>
cudaError_t weights_ob(int ob, const void* h, const void* x_src,
                       const void* dmsg, const void* slot_rows, void* partial,
                       long num_chunks, int num_splits, int K, int c_in,
                       int c_out, cudaStream_t stream) {
  switch (ob) {
    case 1:
      return launch_weights<T, KB, 1>(h, x_src, dmsg, slot_rows, partial,
                                      num_chunks, num_splits, K, c_in, c_out,
                                      stream);
    case 2:
      return launch_weights<T, KB, 2>(h, x_src, dmsg, slot_rows, partial,
                                      num_chunks, num_splits, K, c_in, c_out,
                                      stream);
    case 3:
      return launch_weights<T, KB, 3>(h, x_src, dmsg, slot_rows, partial,
                                      num_chunks, num_splits, K, c_in, c_out,
                                      stream);
    case 4:
      return launch_weights<T, KB, 4>(h, x_src, dmsg, slot_rows, partial,
                                      num_chunks, num_splits, K, c_in, c_out,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_weights_any(int kb, int ob, const void* h,
                               const void* x_src, const void* dmsg,
                               const void* slot_rows, void* partial,
                               long num_chunks, int num_splits, int K,
                               int c_in, int c_out, cudaStream_t stream) {
  switch (kb) {
    case 1:
      return weights_ob<T, 1>(ob, h, x_src, dmsg, slot_rows, partial,
                              num_chunks, num_splits, K, c_in, c_out, stream);
    case 2:
      return weights_ob<T, 2>(ob, h, x_src, dmsg, slot_rows, partial,
                              num_chunks, num_splits, K, c_in, c_out, stream);
    case 3:
      return weights_ob<T, 3>(ob, h, x_src, dmsg, slot_rows, partial,
                              num_chunks, num_splits, K, c_in, c_out, stream);
    case 4:
      return weights_ob<T, 4>(ob, h, x_src, dmsg, slot_rows, partial,
                              num_chunks, num_splits, K, c_in, c_out, stream);
    case 5:
      return weights_ob<T, 5>(ob, h, x_src, dmsg, slot_rows, partial,
                              num_chunks, num_splits, K, c_in, c_out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int CB>
cudaError_t launch_rows(const void* g, const void* h, const void* x_src,
                        const void* w3, const void* b3, const void* slot_rows,
                        const void* row_weight, const void* s_dense, void* dh,
                        void* dx_src, void* dmsg, int num_blocks, int blk,
                        int K, int c_in, int c_out, size_t smem,
                        cudaStream_t stream) {
  auto kernel = bwd_rows_kernel<T, CB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(h),
      static_cast<const T*>(x_src), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
      static_cast<const float*>(row_weight),
      static_cast<const float*>(s_dense), static_cast<float*>(dh),
      static_cast<float*>(dx_src), static_cast<float*>(dmsg), blk, K, c_in,
      c_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(int cb, const void* g, const void* h,
                       const void* x_src, const void* w3, const void* b3,
                       const void* slot_rows, const void* row_weight,
                       const void* s_dense, void* dh, void* dx_src,
                       void* dmsg, void* partial, int num_blocks, int blk,
                       int K, int c_in, int c_out, int num_splits,
                       size_t smem, cudaStream_t stream) {
  cudaError_t err;
  switch (cb) {
    case 1:
      err = launch_rows<T, 1>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, num_blocks, blk, K,
                              c_in, c_out, smem, stream);
      break;
    case 2:
      err = launch_rows<T, 2>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, num_blocks, blk, K,
                              c_in, c_out, smem, stream);
      break;
    case 3:
      err = launch_rows<T, 3>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, num_blocks, blk, K,
                              c_in, c_out, smem, stream);
      break;
    case 4:
      err = launch_rows<T, 4>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, num_blocks, blk, K,
                              c_in, c_out, smem, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long num_chunks = static_cast<long>(num_blocks) * blk / kTile;
  return launch_weights_any<T>((k_part(K) + 1 + kTy - 1) / kTy,
                               (c_out + kTx - 1) / kTx, h, x_src, dmsg,
                               slot_rows, partial, num_chunks, num_splits, K,
                               c_in, c_out, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the rows kernel needs.
long fused_edge_conv_bwd_smem_bytes(int K, int c_in, int c_out) {
  return 4L * (kRows * c_out + kRows * kTile + c_out * kTile + c_in * kTile +
               (K + 1) * kTile + 2L * w_len(K, c_in, c_out) + kPad);
}

// Launches the float32 backward on `stream`: the rows kernel, then the
// weights kernel.  Pointers are device pointers to float32 data, slot_rows
// int32.  Exactly one of s_dense and
// (slot_rows, row_weight) is non-null.  Outputs: dh [slots, K], dx_src
// [slots, c_in], dmsg [slots, c_out] (scratch), partial [num_splits, K+1,
// c_in*c_out] (dw3 rows then the db3 row, summed over splits by the
// caller).  Returns the cudaError_t of the launches (0 on success).
int fused_edge_conv_backward(const void* g, const void* h, const void* x_src,
                             const void* w3, const void* b3,
                             const void* slot_rows, const void* row_weight,
                             const void* s_dense, void* dh, void* dx_src,
                             void* dmsg, void* partial, int num_blocks,
                             int blk, int K, int c_in, int c_out,
                             int num_splits, void* stream) {
  if (K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      num_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int widest = k_part(K) > c_in ? k_part(K) : c_in;
  const int cb = (widest + kTx - 1) / kTx;
  const size_t smem =
      static_cast<size_t>(fused_edge_conv_bwd_smem_bytes(K, c_in, c_out));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_all<float>(
      cb, g, h, x_src, w3, b3, slot_rows, row_weight, s_dense, dh, dx_src,
      dmsg, partial, num_blocks, blk, K, c_in, c_out, num_splits, smem, s));
}

}  // extern "C"
