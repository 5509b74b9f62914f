// Fused edge-conditioned conv layer with rank-r factorized edge kernels,
// backward: the gradients of fused_edge_conv_lowrank.cu's forward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_lowrank_bwd_jit
// and computes the same function, returning the w3/b3 gradients in the
// model's own column layout.  With the forward's notation (uv = h w3 + b3,
// U[i, q] = uv[i*r + q], V[o, q] = uv[r*c_in + o*r + q], t = U^T x_src,
// msg = V t) and g the gradient of the forward's output, per slot e:
//
//   dmsg[o]  = sum_r S[r, e] g[r, o]                 (0 on padding)
//   dt[q]    = sum_o V[o, q] dmsg[o]
//   dx_src[i] = sum_q U[i, q] dt[q]
//   duv[i*r + q]          = x_src[i] dt[q]           (the U columns)
//   duv[r*c_in + o*r + q] = dmsg[o] t[q]             (the V columns)
//   dh[k]    = sum_j duv[j] w3[k, j]
//   dw3[k, j] = sum_e h[e, k] duv[e, j],  db3[j] = sum_e duv[e, j]
//
// In CompactS form S[64 b + r, e] = (slot_rows[e] == r) row_weight[64 b + r].
// h, x_src, w3 and dmsg are rounded to the GEMM input type T; everything
// else is float32, as in the plain version (ops/fused_conv.py:
// fused_edge_conv_lowrank_bwd_plain), which rounds at the same points.
//
// Design: fused_edge_conv_bwd.cu's two launches.
//
//  (a) rows kernel: one thread block per 64-row receiver block, walking its
//      slots in tiles of 64.  Per tile it forms dmsg (row_weight folded into
//      the block's g rows in CompactS form) and recomputes uv in column
//      chunks of whole channels, as the forward does: the V chunks give dt,
//      then the U chunks give t and dx_src and, as the GEMM
//      [duv U chunk] @ [w3 chunk]^T formed in shared memory, the U half of
//      dh; a second walk over the V chunks adds the V half of dh from
//      dmsg (x) t.  It writes dh, dx_src and, as scratch for (b), per-slot
//      dmsg, t and dt ((c_out + 2r) 4 bytes a slot).  Tiles of padding only
//      are skipped in CompactS mode (their gradients are 0).
//  (b) weights kernel: dw3 and db3 together as one [(K+1), r (c_in+c_out)]
//      split-K GEMM h~^T duv over the slots, the duv columns formed in
//      registers as triple products h[k] x[i] dt[q] and h[k] dmsg[o] t[q],
//      on a grid of 8-channel column tiles x slot splits.  Each split writes
//      its own partial; the wrapper sums them in a fixed order (no atomics).
//      The whole [(K+1), 1536] accumulator (301 KB at width 48, rank 16)
//      fits no single SM.
//
// Bound.  Per real slot about 4 (K+1) r (c_in + c_out) operations (the uv
// recompute and dh in (a), dw3/db3 in (b); the rest is O(r (c_in + c_out)))
// against (K + c_in) (sizeof(T) + 4) + c_out 4 bytes of inputs and outputs:
// ~450 kFLOP against ~500 B at width 48, rank 16, far above the card's
// ridge, so it is bounded by operations.  This version runs them as float32
// FMAs on the CUDA cores: a correct first kernel, not a tensor-core one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_lowrank_bwd.so
//        fused_edge_conv_lowrank_bwd.cu

#include "lowrank_tile.cuh"

namespace {

using namespace lowrank_tile;

constexpr int kCh = 8;                  // weights kernel: channels per block

// A float32 rounded to T and widened back (round to nearest even, as
// torch's .to(torch.bfloat16)).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Offsets (in floats) of the rows kernel's shared-memory arrays.  The
// block's g rows and the dense S tile are live only while dmsg is formed,
// the w3 chunk and the uv (or transposed duv) chunk only after: they share
// their space.
struct Layout {
  int hT, xT, dT, t, dt, w, uv, g, s, total;
};

__host__ __device__ inline Layout layout(int K, int c_in, int c_out, int r) {
  Layout L;
  L.hT = 0;                                // [K+1][kTile], row K all ones
  L.xT = L.hT + (K + 1) * kTile;           // [c_in][kTile] x_src
  L.dT = L.xT + c_in * kTile;              // [c_out][kTile] dmsg
  L.t = L.dT + c_out * kTile;              // [kTile][r]
  L.dt = L.t + kTile * r;                  // [kTile][r]
  L.w = L.dt + kTile * r;                  // [K+1][kWStride] w3 rows, b3
  L.uv = L.w + (K + 1) * kWStride;         // [kTile][kUvStride] or [kChunk][kTile]
  L.g = L.w;                               // [kRows][c_out]
  L.s = L.g + kRows * c_out;               // [kRows][kTile] dense S tile
  const int chunk_end = L.uv + kTile * kUvStride;
  const int s_end = L.s + kRows * kTile;
  L.total = chunk_end > s_end ? chunk_end : s_end;
  return L;
}

// acc[a][cb] += sum_{c < cw} duvT[c, 4 ty + a] w[k, c],  k = tx + 16 cb:
// one chunk's share of dh.  Rows k >= K read neighbouring shared memory and
// are never stored.
template <int CB>
__device__ __forceinline__ void dh_tile(const float* w, const float* duvT,
                                        float (&acc)[kSlotsPerThread][CB],
                                        int cw) {
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  for (int c = 0; c < cw; ++c) {
    const float4 dv =
        *reinterpret_cast<const float4*>(&duvT[c * kTile + ty * kSlotsPerThread]);
    const float d[kSlotsPerThread] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      const float wv = w[(tx + cb * kTx) * kWStride + c];
#pragma unroll
      for (int a = 0; a < kSlotsPerThread; ++a) acc[a][cb] += d[a] * wv;
    }
  }
}

// ---------------------------------------------------------------------------
// (a) dmsg, t, dt, dx_src and dh, one thread block per 64-row receiver
// block.  CB = ceil(K / 16) dh columns per thread.
template <typename T, int CB>
__global__ void __launch_bounds__(kThreads, 2)
lowrank_bwd_rows_kernel(const float* __restrict__ g, const T* __restrict__ h,
                        const T* __restrict__ x_src, const T* __restrict__ w3,
                        const float* __restrict__ b3,
                        const int* __restrict__ slot_rows,
                        const float* __restrict__ row_weight,
                        const float* __restrict__ s_dense,
                        float* __restrict__ dh, float* __restrict__ dx_src,
                        float* __restrict__ dmsg_out, float* __restrict__ t_out,
                        float* __restrict__ dt_out, int blk, int K, int c_in,
                        int c_out, int r) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(K, c_in, c_out, r);
  float* hT = smem + L.hT;
  float* xT = smem + L.xT;
  float* dT = smem + L.dT;
  float* t_sm = smem + L.t;
  float* dt_sm = smem + L.dt;
  float* w_sm = smem + L.w;
  float* uv_sm = smem + L.uv;   // as duvT: [kChunk][kTile]
  float* g_sm = smem + L.g;
  float* s_sm = smem + L.s;

  const int ncol = r * (c_in + c_out);
  const int ru = r * c_in;
  const int group = kChunk / r;            // channels per chunk
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int b = blockIdx.x;
  const long slot_base = static_cast<long>(b) * blk;
  const long row_base = static_cast<long>(b) * kRows;
  const bool compact = s_dense == nullptr;

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
        for (int e = tid; e < kTile * r; e += kThreads) {
          t_out[tile * r + e] = 0.f;
          dt_out[tile * r + e] = 0.f;
        }
        continue;
      }
    }

    // ---- stage the tile's operands (as float32) ----
    // the block's g rows; in CompactS form with the row weight folded in, so
    // that dmsg[e] = g_sm[slot_rows[e]] is the same float32 product S[r, e] g[r]
    for (int e = tid; e < kRows * c_out; e += kThreads) {
      const float v = g[row_base * c_out + e];
      g_sm[e] = compact ? row_weight[row_base + e / c_out] * v : v;
    }
    if (!compact) {
      for (int e = tid; e < kRows * kTile; e += kThreads) {
        const int rr = e / kTile, s = e - rr * kTile;
        s_sm[e] = s_dense[(row_base + rr) * blk + t0 + s];
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
    for (int e = tid; e < kTile * r; e += kThreads) {
      t_sm[e] = 0.f;
      dt_sm[e] = 0.f;
    }
    __syncthreads();

    // ---- dmsg = S^T g for the tile's slots, rounded to T ----
    for (int e = tid; e < kTile * c_out; e += kThreads) {
      const int s = e / c_out, o = e - s * c_out;
      float v = 0.f;
      if (compact) {
        const int rr = slot_rows[tile + s];
        if (rr >= 0) v = g_sm[rr * c_out + o];
      } else {
        for (int rr = 0; rr < kRows; ++rr)
          v += s_sm[rr * kTile + s] * g_sm[rr * c_out + o];
      }
      v = round_to<T>(v);
      dT[o * kTile + s] = v;
      dmsg_out[(tile + s) * c_out + o] = v;
    }
    __syncthreads();  // the w3 chunks overwrite g_sm and s_sm

    // ---- V chunks: dt[s, q] += sum_o V[s, o, q] dmsg[s, o] ----
    for (int o0 = 0; o0 < c_out; o0 += group) {
      const int gc = min(group, c_out - o0);
      stage_w(w_sm, w3, b3, K, ncol, ru + o0 * r, gc * r);
      __syncthreads();
      uv_tile(w_sm, hT, uv_sm, K, gc * r);
      __syncthreads();
      for (int e = tid; e < kTile * r; e += kThreads) {
        const int s = e / r, q = e - s * r;
        float v = dt_sm[e];
        for (int gg = 0; gg < gc; ++gg)
          v += uv_sm[s * kUvStride + gg * r + q] * dT[(o0 + gg) * kTile + s];
        dt_sm[e] = v;
      }
      __syncthreads();
    }

    float acc[kSlotsPerThread][CB];
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) acc[a][cb] = 0.f;

    // ---- U chunks: t, dx_src, and dh += (x (x) dt) w3_U^T ----
    for (int i0 = 0; i0 < c_in; i0 += group) {
      const int gc = min(group, c_in - i0);
      const int cw = gc * r;
      stage_w(w_sm, w3, b3, K, ncol, i0 * r, cw);
      __syncthreads();
      uv_tile(w_sm, hT, uv_sm, K, cw);
      __syncthreads();
      for (int e = tid; e < kTile * r; e += kThreads) {
        const int s = e / r, q = e - s * r;
        float v = t_sm[e];
        for (int gg = 0; gg < gc; ++gg)
          v += xT[(i0 + gg) * kTile + s] * uv_sm[s * kUvStride + gg * r + q];
        t_sm[e] = v;
      }
      for (int e = tid; e < kTile * gc; e += kThreads) {
        const int s = e / gc, gg = e - s * gc;
        float v = 0.f;
        for (int q = 0; q < r; ++q)
          v += uv_sm[s * kUvStride + gg * r + q] * dt_sm[s * r + q];
        dx_src[(tile + s) * c_in + i0 + gg] = v;
      }
      __syncthreads();
      for (int e = tid; e < cw * kTile; e += kThreads) {
        const int c = e / kTile, s = e - c * kTile;
        const int cq = c / r;
        uv_sm[e] = xT[(i0 + cq) * kTile + s] * dt_sm[s * r + c - cq * r];
      }
      __syncthreads();
      dh_tile<CB>(w_sm, uv_sm, acc, cw);
      __syncthreads();
    }
    for (int e = tid; e < kTile * r; e += kThreads) {
      t_out[tile * r + e] = t_sm[e];
      dt_out[tile * r + e] = dt_sm[e];
    }

    // ---- V chunks again: dh += (dmsg (x) t) w3_V^T ----
    for (int o0 = 0; o0 < c_out; o0 += group) {
      const int gc = min(group, c_out - o0);
      const int cw = gc * r;
      stage_w(w_sm, w3, b3, K, ncol, ru + o0 * r, cw);
      for (int e = tid; e < cw * kTile; e += kThreads) {
        const int c = e / kTile, s = e - c * kTile;
        const int co = c / r;
        uv_sm[e] = dT[(o0 + co) * kTile + s] * t_sm[s * r + c - co * r];
      }
      __syncthreads();
      dh_tile<CB>(w_sm, uv_sm, acc, cw);
      __syncthreads();  // also: the next tile overwrites shared memory
    }
#pragma unroll
    for (int a = 0; a < kSlotsPerThread; ++a)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const int k = tx + cb * kTx;
        if (k < K) dh[(tile + ty * kSlotsPerThread + a) * K + k] = acc[a][cb];
      }
  }
}

// ---------------------------------------------------------------------------
// (b) partial[split, k, j] = sum over the split's slots e of h~[e, k] duv[e, j],
//     k <= K (k == K: db3).
// Grid: (ceil(c_in / 8) + ceil(c_out / 8) column tiles, num_splits).  A
// block owns every k and q for 8 channels of one half (U: input channels,
// duv = x_src dt; V: output channels, duv = dmsg t): per 64-slot chunk it
// copies h, the 8 channels' values and dt (or t) into shared memory, and
// each thread accumulates KB rows k = ty + 16 a  x  8 channels  x  QB ranks
// q = tx + 16 b, forming channel * dt once per (channel, q) and reusing it
// for its KB rows.
template <typename T, int KB, int QB>
__global__ void __launch_bounds__(kThreads)
lowrank_bwd_weights_kernel(const T* __restrict__ h, const T* __restrict__ x_src,
                           const float* __restrict__ dmsg,
                           const float* __restrict__ t_vec,
                           const float* __restrict__ dt_vec,
                           const int* __restrict__ slot_rows,
                           float* __restrict__ partial, long num_chunks,
                           long chunks_per_split, int K, int c_in, int c_out,
                           int r) {
  constexpr int kRowsK = KB * kTy;         // k rows held, >= K + 1
  __shared__ __align__(16) float a_sm[kTile][kRowsK];      // h~, 0 past K
  __shared__ __align__(16) float c_sm[kTile][kCh];         // channel values
  __shared__ __align__(16) float v_sm[kTile][kMaxRank];    // dt or t, 0 past r
  const int ncol = r * (c_in + c_out);
  const int u_tiles = (c_in + kCh - 1) / kCh;
  const bool v_half = static_cast<int>(blockIdx.x) >= u_tiles;
  const int ch0 = (v_half ? blockIdx.x - u_tiles : blockIdx.x) * kCh;
  const int nch = v_half ? c_out : c_in;
  const int col0 = v_half ? r * c_in : 0;
  const float* vec = v_half ? t_vec : dt_vec;
  const long split = blockIdx.y;
  const long c_lo = split * chunks_per_split;
  const long c_hi = c_lo + chunks_per_split < num_chunks
                        ? c_lo + chunks_per_split
                        : num_chunks;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;

  float acc[KB][kCh][QB];
#pragma unroll
  for (int a = 0; a < KB; ++a)
#pragma unroll
    for (int cc = 0; cc < kCh; ++cc)
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) acc[a][cc][qb] = 0.f;

  for (long ch = c_lo; ch < c_hi; ++ch) {
    const long s0 = ch * kTile;
    if (slot_rows != nullptr) {  // CompactS: skip chunks of padding only
      int real = 0;
      if (tid < kTile) real = slot_rows[s0 + tid] >= 0;
      if (!__syncthreads_or(real)) continue;
    }
    for (int e = tid; e < kTile * kRowsK; e += kThreads) {
      const int s = e / kRowsK, k = e - s * kRowsK;
      a_sm[s][k] = k < K ? to_f32(h[(s0 + s) * K + k]) : (k == K ? 1.f : 0.f);
    }
    for (int e = tid; e < kTile * kCh; e += kThreads) {
      const int s = e / kCh, cc = e - s * kCh;
      float v = 0.f;
      if (ch0 + cc < nch)
        v = v_half ? dmsg[(s0 + s) * c_out + ch0 + cc]
                   : to_f32(x_src[(s0 + s) * c_in + ch0 + cc]);
      c_sm[s][cc] = v;
    }
    for (int e = tid; e < kTile * kMaxRank; e += kThreads) {
      const int s = e / kMaxRank, q = e - s * kMaxRank;
      v_sm[s][q] = q < r ? vec[(s0 + s) * r + q] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < kTile; ++s) {
      float hv[KB];
#pragma unroll
      for (int a = 0; a < KB; ++a) hv[a] = a_sm[s][ty + a * kTy];
      const float4 c0 = *reinterpret_cast<const float4*>(&c_sm[s][0]);
      const float4 c1 = *reinterpret_cast<const float4*>(&c_sm[s][4]);
      const float cv[kCh] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float vv[QB];
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) vv[qb] = v_sm[s][tx + qb * kTx];
#pragma unroll
      for (int cc = 0; cc < kCh; ++cc)
#pragma unroll
        for (int qb = 0; qb < QB; ++qb) {
          const float y = cv[cc] * vv[qb];
#pragma unroll
          for (int a = 0; a < KB; ++a) acc[a][cc][qb] += hv[a] * y;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < KB; ++a) {
    const int k = ty + a * kTy;
    if (k > K) continue;
#pragma unroll
    for (int cc = 0; cc < kCh; ++cc) {
      if (ch0 + cc >= nch) continue;
#pragma unroll
      for (int qb = 0; qb < QB; ++qb) {
        const int q = tx + qb * kTx;
        if (q < r)
          partial[(split * (K + 1) + k) * ncol + col0 + (ch0 + cc) * r + q] =
              acc[a][cc][qb];
      }
    }
  }
}

template <typename T, int KB, int QB>
cudaError_t launch_weights(const void* h, const void* x_src, const void* dmsg,
                           const void* t_vec, const void* dt_vec,
                           const void* slot_rows, void* partial,
                           long num_chunks, int num_splits, int K, int c_in,
                           int c_out, int r, cudaStream_t stream) {
  const long per_split = (num_chunks + num_splits - 1) / num_splits;
  const dim3 grid((c_in + kCh - 1) / kCh + (c_out + kCh - 1) / kCh,
                  num_splits);
  lowrank_bwd_weights_kernel<T, KB, QB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x_src),
      static_cast<const float*>(dmsg), static_cast<const float*>(t_vec),
      static_cast<const float*>(dt_vec), static_cast<const int*>(slot_rows),
      static_cast<float*>(partial), num_chunks, per_split, K, c_in, c_out, r);
  return cudaGetLastError();
}

// KB = ceil((K+1) / 16) in 1..5, QB = ceil(r / 16) in 1..2.
template <typename T, int KB>
cudaError_t weights_qb(int qb, const void* h, const void* x_src,
                       const void* dmsg, const void* t_vec,
                       const void* dt_vec, const void* slot_rows,
                       void* partial, long num_chunks, int num_splits, int K,
                       int c_in, int c_out, int r, cudaStream_t stream) {
  switch (qb) {
    case 1:
      return launch_weights<T, KB, 1>(h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                                      partial, num_chunks, num_splits, K,
                                      c_in, c_out, r, stream);
    case 2:
      return launch_weights<T, KB, 2>(h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                                      partial, num_chunks, num_splits, K,
                                      c_in, c_out, r, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_weights_any(int kb, int qb, const void* h,
                               const void* x_src, const void* dmsg,
                               const void* t_vec, const void* dt_vec,
                               const void* slot_rows, void* partial,
                               long num_chunks, int num_splits, int K,
                               int c_in, int c_out, int r,
                               cudaStream_t stream) {
  switch (kb) {
    case 1:
      return weights_qb<T, 1>(qb, h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                              partial, num_chunks, num_splits, K, c_in, c_out,
                              r, stream);
    case 2:
      return weights_qb<T, 2>(qb, h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                              partial, num_chunks, num_splits, K, c_in, c_out,
                              r, stream);
    case 3:
      return weights_qb<T, 3>(qb, h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                              partial, num_chunks, num_splits, K, c_in, c_out,
                              r, stream);
    case 4:
      return weights_qb<T, 4>(qb, h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                              partial, num_chunks, num_splits, K, c_in, c_out,
                              r, stream);
    case 5:
      return weights_qb<T, 5>(qb, h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                              partial, num_chunks, num_splits, K, c_in, c_out,
                              r, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int CB>
cudaError_t launch_rows(const void* g, const void* h, const void* x_src,
                        const void* w3, const void* b3, const void* slot_rows,
                        const void* row_weight, const void* s_dense, void* dh,
                        void* dx_src, void* dmsg, void* t_vec, void* dt_vec,
                        int num_blocks, int blk, int K, int c_in, int c_out,
                        int r, size_t smem, cudaStream_t stream) {
  auto kernel = lowrank_bwd_rows_kernel<T, CB>;
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
      static_cast<float*>(dx_src), static_cast<float*>(dmsg),
      static_cast<float*>(t_vec), static_cast<float*>(dt_vec), blk, K, c_in,
      c_out, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(int cb, const void* g, const void* h,
                       const void* x_src, const void* w3, const void* b3,
                       const void* slot_rows, const void* row_weight,
                       const void* s_dense, void* dh, void* dx_src,
                       void* dmsg, void* t_vec, void* dt_vec, void* partial,
                       int num_blocks, int blk, int K, int c_in, int c_out,
                       int r, int num_splits, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err;
  switch (cb) {
    case 1:
      err = launch_rows<T, 1>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, t_vec, dt_vec,
                              num_blocks, blk, K, c_in, c_out, r, smem,
                              stream);
      break;
    case 2:
      err = launch_rows<T, 2>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, t_vec, dt_vec,
                              num_blocks, blk, K, c_in, c_out, r, smem,
                              stream);
      break;
    case 3:
      err = launch_rows<T, 3>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, t_vec, dt_vec,
                              num_blocks, blk, K, c_in, c_out, r, smem,
                              stream);
      break;
    case 4:
      err = launch_rows<T, 4>(g, h, x_src, w3, b3, slot_rows, row_weight,
                              s_dense, dh, dx_src, dmsg, t_vec, dt_vec,
                              num_blocks, blk, K, c_in, c_out, r, smem,
                              stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long num_chunks = static_cast<long>(num_blocks) * blk / kTile;
  return launch_weights_any<T>((K + 1 + kTy - 1) / kTy, (r + kTx - 1) / kTx,
                               h, x_src, dmsg, t_vec, dt_vec, slot_rows,
                               partial, num_chunks, num_splits, K, c_in,
                               c_out, r, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the rows kernel needs.
long fused_edge_conv_lowrank_bwd_smem_bytes(int K, int c_in, int c_out,
                                            int r) {
  return 4L * layout(K, c_in, c_out, r).total;
}

// Launches the backward on `stream`: the rows kernel, then the weights
// kernel.  Pointers are device pointers; h, x_src and w3 share one type
// (is_bf16 ? bfloat16 : float32); g, b3, row_weight, s_dense and every
// output are float32; slot_rows int32.  Exactly one of s_dense and
// (slot_rows, row_weight) is non-null.  w3 is [K, r*(c_in+c_out)] in the
// model's column layout.  Outputs: dh [slots, K], dx_src [slots, c_in],
// dmsg [slots, c_out], t_vec and dt_vec [slots, r] (scratch), partial
// [num_splits, K+1, r*(c_in+c_out)] (dw3 rows then the db3 row, summed over
// splits by the caller).  1 <= K, c_in, c_out <= 64, 1 <= r <= 32.  Returns
// the cudaError_t of the launches (0 on success).
int fused_edge_conv_lowrank_backward(
    const void* g, const void* h, const void* x_src, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* dh, void* dx_src, void* dmsg, void* t_vec,
    void* dt_vec, void* partial, int num_blocks, int blk, int K, int c_in,
    int c_out, int r, int num_splits, int is_bf16, void* stream) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || r < 1 || r > kMaxRank || blk % kTile != 0 ||
      blk < kTile || num_blocks < 1 || num_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cb = (K + kTx - 1) / kTx;
  const size_t smem = static_cast<size_t>(
      fused_edge_conv_lowrank_bwd_smem_bytes(K, c_in, c_out, r));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(cb, g, h, x_src, w3, b3, slot_rows,
                                          row_weight, s_dense, dh, dx_src,
                                          dmsg, t_vec, dt_vec, partial,
                                          num_blocks, blk, K, c_in, c_out, r,
                                          num_splits, smem, s)
              : launch_all<float>(cb, g, h, x_src, w3, b3, slot_rows,
                                  row_weight, s_dense, dh, dx_src, dmsg,
                                  t_vec, dt_vec, partial, num_blocks, blk, K,
                                  c_in, c_out, r, num_splits, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
