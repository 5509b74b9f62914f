// Fused edge-conditioned conv layer with rank-r factorized edge kernels,
// forward: message + scatter-mean in one kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_lowrank_jit
// and computes the same function.  Slots are grouped as for the full-rank
// layer (fused_edge_conv_wgmma.cu): block b holds the slots whose receivers lie in
// rows [64 b, 64 b + 64).  Per slot e the edge MLP's head gives
// uv = h_e w3 + b3 of width r (c_in + c_out), read in the model's own column
// layout (no permutation):
//
//   U_e[i, q] = uv[i*r + q]                 i < c_in,  q < r
//   V_e[o, q] = uv[r*c_in + o*r + q]        o < c_out
//   t_e[q]    = sum_i U_e[i, q] x[senders_perm[e], i]
//   msg_e[o]  = sum_q V_e[o, q] t_e[q]
//   out[r, o] = sum_{e in block(r)} S[r, e] msg_e[o]
//
// S is dense ([num_blocks*64, blk] f32) or given by its generators
// (CompactS): S[64 b + r, e] = (slot_rows[e] == r) * row_weight[64 b + r].
// h, x and w3 arrive in the GEMM input type T; uv, t and msg are float32, as
// in the plain version (ops/fused_conv.py:fused_edge_conv_lowrank_plain).
//
// Design.  A 64-slot tile of uv is 64 x 1536 floats at width 48 and rank 16
// (384 KB), more than one block's shared memory.  The kernel forms uv in
// column chunks of whole channels (r*floor(128/r) columns) and consumes each
// chunk at once: a U chunk (input channels i0..) adds its channels' terms to
// t, then a V chunk (output channels o0..) gives those channels' msg from the
// finished t.  Each chunk is the GEMM [h, 1] @ [[w3 chunk], [b3 chunk]]
// (64 slots x 128 columns x K+1, 4 x 8 outputs per thread, w3 chunk staged
// in shared memory).  The scatter-mean is the full-rank layer's: one thread
// block per 64-row receiver block, accumulating its rows in registers through
// the S tile in a fixed order, no atomics; in CompactS mode a tile of padding
// only is skipped.
//
// Bound.  Per real slot the layer needs about 2 (K+1) r (c_in + c_out)
// operations (the uv GEMM; t and msg add 2 r (c_in + c_out)) and moves
// (K + c_in) sizeof(T) + 8 bytes: at width 48, rank 16 that is ~150 kFLOP
// against ~200 B, far above the H100's ridge, so the kernel is bounded by
// operations.  This design runs them as float32 FMAs on the CUDA cores
// (bf16 inputs are widened on load).  It serves both types at ranks that
// are not a multiple of 8; the other ranks run on the tensor cores
// (fused_edge_conv_lowrank_wgmma.cu, fused_edge_conv_lowrank_f32_wgmma.cu;
// ops/fused_conv.py:design).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_lowrank.so
//        fused_edge_conv_lowrank.cu

#include "lowrank_tile.cuh"

namespace {

using namespace lowrank_tile;

constexpr int kRowsPerThread = kRows / kTy;   // 4

// Offsets (in floats) of the shared-memory arrays.  The w3 chunk and the uv
// chunk are live only while uv is formed; the S tile only in the scatter
// stage, so it shares their space.
struct Layout {
  int hT, xT, t, msg, w, uv, s, total;
};

__host__ __device__ inline Layout layout(int K, int c_in, int c_out, int r) {
  Layout L;
  L.hT = 0;                                // [K+1][kTile], row K all ones
  L.xT = L.hT + (K + 1) * kTile;           // [c_in][kTile]
  L.t = L.xT + c_in * kTile;               // [kTile][r]
  L.msg = L.t + kTile * r;                 // [kTile][c_out]
  L.w = L.msg + kTile * c_out;             // [K+1][kWStride] w3 rows, b3
  L.uv = L.w + (K + 1) * kWStride;         // [kTile][kUvStride]
  L.s = L.w;                               // [kRows][kTile]
  const int chunk_end = L.uv + kTile * kUvStride;
  const int s_end = L.s + kRows * kTile;
  L.total = chunk_end > s_end ? chunk_end : s_end;
  return L;
}

// OB = ceil(c_out / 16) output columns per thread in the scatter stage.
template <typename T, int OB>
__global__ void __launch_bounds__(kThreads, 2)
lowrank_fwd_kernel(const T* __restrict__ h, const T* __restrict__ x,
                   const int* __restrict__ senders_perm,
                   const T* __restrict__ w3, const float* __restrict__ b3,
                   const int* __restrict__ slot_rows,
                   const float* __restrict__ row_weight,
                   const float* __restrict__ s_dense, float* __restrict__ out,
                   int blk, int K, int c_in, int c_out, int r, int n_nodes) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(K, c_in, c_out, r);
  float* hT = smem + L.hT;
  float* xT = smem + L.xT;
  float* t_sm = smem + L.t;
  float* msg_sm = smem + L.msg;
  float* w_sm = smem + L.w;
  float* uv_sm = smem + L.uv;
  float* s_sm = smem + L.s;

  const int ncol = r * (c_in + c_out);
  const int group = kChunk / r;            // channels per chunk
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

    // ---- stage h (with a row of ones for b3) and the gathered x ----
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
    for (int e = tid; e < kTile * r; e += kThreads) t_sm[e] = 0.f;
    __syncthreads();

    // ---- U chunks: t[s, q] += sum_i x[s, i] U[s, i, q] ----
    for (int i0 = 0; i0 < c_in; i0 += group) {
      const int gc = min(group, c_in - i0);
      stage_w(w_sm, w3, b3, K, ncol, i0 * r, gc * r);
      __syncthreads();
      uv_tile(w_sm, hT, uv_sm, K, gc * r);
      __syncthreads();
      for (int e = tid; e < kTile * r; e += kThreads) {
        const int s = e / r, q = e - s * r;
        float v = t_sm[e];
        for (int g = 0; g < gc; ++g)
          v += xT[(i0 + g) * kTile + s] * uv_sm[s * kUvStride + g * r + q];
        t_sm[e] = v;
      }
      __syncthreads();
    }
    // ---- V chunks: msg[s, o] = sum_q V[s, o, q] t[s, q] ----
    for (int o0 = 0; o0 < c_out; o0 += group) {
      const int gc = min(group, c_out - o0);
      stage_w(w_sm, w3, b3, K, ncol, r * c_in + o0 * r, gc * r);
      __syncthreads();
      uv_tile(w_sm, hT, uv_sm, K, gc * r);
      __syncthreads();
      for (int e = tid; e < kTile * gc; e += kThreads) {
        const int s = e / gc, g = e - s * gc;
        float v = 0.f;
        for (int q = 0; q < r; ++q)
          v += uv_sm[s * kUvStride + g * r + q] * t_sm[s * r + q];
        msg_sm[s * c_out + o0 + g] = v;
      }
      __syncthreads();
    }

    // ---- scatter-mean: acc[r, o] += sum_s S[r, s] msg[s, o] ----
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile, s = e - rr * kTile;
      s_sm[e] = compact ? (slot_rows[tile + s] == rr ? row_weight[row_base + rr]
                                                     : 0.f)
                        : s_dense[(row_base + rr) * blk + t0 + s];
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
                   int num_blocks, int blk, int K, int c_in, int c_out, int r,
                   int n_nodes, size_t smem, cudaStream_t stream) {
  auto kernel = lowrank_fwd_kernel<T, OB>;
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
      c_in, c_out, r, n_nodes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int ob, const void* h, const void* x,
                     const void* senders_perm, const void* w3, const void* b3,
                     const void* slot_rows, const void* row_weight,
                     const void* s_dense, void* out, int num_blocks, int blk,
                     int K, int c_in, int c_out, int r, int n_nodes,
                     size_t smem, cudaStream_t stream) {
  switch (ob) {
    case 1:
      return launch<T, 1>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out, r,
                          n_nodes, smem, stream);
    case 2:
      return launch<T, 2>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out, r,
                          n_nodes, smem, stream);
    case 3:
      return launch<T, 3>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out, r,
                          n_nodes, smem, stream);
    case 4:
      return launch<T, 4>(h, x, senders_perm, w3, b3, slot_rows, row_weight,
                          s_dense, out, num_blocks, blk, K, c_in, c_out, r,
                          n_nodes, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_conv_lowrank_smem_bytes(int K, int c_in, int c_out, int r) {
  return 4L * layout(K, c_in, c_out, r).total;
}

// Launches the forward on `stream`.  Pointers are device pointers; h, x, w3
// share one type (is_bf16 ? bfloat16 : float32); b3, row_weight, s_dense and
// out are float32; senders_perm and slot_rows int32.  Exactly one of s_dense
// and (slot_rows, row_weight) is non-null.  w3 is [K, r*(c_in+c_out)] in the
// model's column layout.  1 <= K, c_in, c_out <= 64, 1 <= r <= 32, blk a
// multiple of 64.  Returns the cudaError_t of the launch (0 on success).
int fused_edge_conv_lowrank_forward(const void* h, const void* x,
                                    const void* senders_perm, const void* w3,
                                    const void* b3, const void* slot_rows,
                                    const void* row_weight,
                                    const void* s_dense, void* out,
                                    int num_blocks, int blk, int K, int c_in,
                                    int c_out, int r, int n_nodes, int is_bf16,
                                    void* stream) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || r < 1 || r > kMaxRank || blk % kTile != 0 ||
      blk < kTile || num_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ob = (c_out + kTx - 1) / kTx;
  const size_t smem = static_cast<size_t>(
      fused_edge_conv_lowrank_smem_bytes(K, c_in, c_out, r));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(ob, h, x, senders_perm, w3, b3,
                                        slot_rows, row_weight, s_dense, out,
                                        num_blocks, blk, K, c_in, c_out, r,
                                        n_nodes, smem, s)
              : dispatch<float>(ob, h, x, senders_perm, w3, b3, slot_rows,
                                row_weight, s_dense, out, num_blocks, blk, K,
                                c_in, c_out, r, n_nodes, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
