// Fused edge-conditioned conv layer, backward, in float32 on Hopper's tensor
// cores (wgmma, sm_90a), exact to float32 through split bf16 operands: the
// gradients of fused_edge_conv_f32_wgmma.cu's forward.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_edge_conv_bwd_jit
// for float32 operands (fused_edge_conv_bwd_wgmma.cu is the bfloat16
// instance) and computes the same function.  With the forward's notation, g
// the gradient of its output and W~ = [[w3], [b3]] seen as [K+1, c_in,
// c_out]:
//
//   dmsg[e, o]   = sum_r S[r, e] g[r, o]                  (0 on padding)
//   dh[e, k]     = sum_{i,o} x_src[e, i] dmsg[e, o] w3[k, i*c_out + o]
//   dx_src[e, i] = sum_{k<=K, o} h~[e, k] dmsg[e, o] W~[k, i, o]
//   dw3[k, i*c_out + o] = sum_e h[e, k] x_src[e, i] dmsg[e, o]
//   db3[i*c_out + o]    = sum_e x_src[e, i] dmsg[e, o]
//
// Numbers.  Every operand and every sum is float32, as in the plain version
// (ops/fused_conv.py:fused_edge_conv_bwd_plain, which rounds h, x_src, w3 and
// dmsg to the GEMM type: float32 here, so not at all).  The tensor cores see
// float32 operands split exactly into three bf16 parts and sum the six
// products of order >= 2^-16, smallest first (f32_wgmma.cuh).
//
//  (a) rows kernel, factored.  R_k = D @ W~_k^T ([64, c_out] x [c_out,
//      c_in], D the tile's dmsg rows) for k = 0..K, D and W~_k split in
//      three: six products per k.  Then in float32 dx_src += h~[:, k] R_k
//      and, for k < K, dh[:, k] = sum_i x_src[:, i] R_k[:, i] (the row sum
//      over the accumulator fragment takes a quad shuffle).  The b3 term is
//      stage K with h~ = 1, like the forward's: b3 is split, never rounded.
//  (b) weights kernel.  dw3 = h^T @ z with z = x_src (x) dmsg formed in
//      float32, exactly as the plain version forms it.  The bfloat16
//      instance needs two passes, because a product of two bf16 values
//      splits exactly into hi + lo; here h and z are float32, so each takes
//      three parts and the product six passes.  db3 = sum_e z is summed in
//      float32 from z itself by the thread that forms its column.
//
// Design.
//  (a) one block per 64-slot tile: one consumer warpgroup and one producer
//      warp.  The producer streams the stage image of W~^T (laid out once per
//      call by a first launch, rows i and depth o, f32_wgmma.cuh) by bulk
//      copy into a 4-stage ring.  The consumers form the tile's dmsg in
//      float32 (row_weight g[slot_rows[e]] straight from g in CompactS form;
//      the dense form sums S^T g), write it once (for the weights kernel),
//      split it into D's register-A fragments, and walk the K+1 stages with
//      two products in flight (runs of 4, all waited for by each run's end:
//      ptxas serializes every wgmma of a loop that carries one in flight),
//      two blocks per SM where the registers allow (kRowsMinBlocks).
//      Tiles of padding only write zeros in CompactS form.
//  (b) output tiles of 64 rows of K x 128 columns of c_in c_out, times slot
//      splits: grid (column tiles, row tiles, splits).  Per 64-slot chunk a
//      block splits its h rows into three MN-major A parts (h^T), forms z
//      (each thread one column, in slot order) and splits it into three
//      K-major B parts, then runs 6 x 4 m64n128k16 products into a fresh
//      accumulator, which it adds into its float32 sum (the tensor cores'
//      own sum never runs longer than one chunk).  The next chunk's h,
//      x_src and dmsg rows are copied into shared memory by cp.async while
//      the products run.  Each split writes its partial [K+1, c2] (row K:
//      db3) once; the wrapper sums the partials in a fixed order.  No
//      atomics anywhere: two launches on the same inputs give the same
//      bits.
//
// Widths.  c_in and c_out 1..256, K 1..256: the rows kernel cuts its N,
// the c_in columns of R_k, into column chunks as the forward cuts c_out
// (f32_wgmma.cuh Chunks; 32 wide where c_out is 65..128), walks the K+1
// stages once per chunk, writes each chunk's dx_src columns and adds each
// chunk's share of dh[:, k] to the earlier chunks' (the same thread, in
// chunk order).  Up to a c_out of 128 D's parts stay in registers across
// the passes.  Past it they would take 192 registers at 256: D is formed
// 8 columns at a time, written out and split into shared memory (96 KB at
// 256), and each W~_k of a chunk walks in c_out / 32 stages of 32 deep
// (f32_wgmma.cuh DeepWalk); h is then read from device memory, one k ahead
// of the epilogue, and the float32 dmsg tile is not kept (144 KB at K =
// c_in = c_out = 256).  The weights kernel's tiles cover any c_in c_out
// (152 KB of shared memory at 128, one block per SM; 216 KB at 256, just
// under the 227 KB a block may take, one block per SM).

// Bound.  About 3 x 2 (K+1) c_in c_out operations per real slot (three
// products of the forward's size) against (K + c_in) 4 + c_out 4 + (K +
// c_in) 4 bytes: bounded by operations, on the tensor cores six bf16 passes
// at 989 TFLOP/s (against float32 FMAs at 67).  What stands in the way: the
// per-stage cost of the ring, the float32 epilogues on the CUDA cores, and
// in (b) the splits of h and z on them before each chunk's products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_bwd_f32_wgmma.so
//        fused_edge_conv_bwd_f32_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_wgmma.cuh"

namespace {

using namespace f32_wgmma;

constexpr int kRows = 64;   // receiver rows per block (rows_blk)
constexpr int kTile = 64;   // slots per tile
constexpr int kMaxDim = 256;
constexpr int kMaxK = 256;
constexpr int kThreads = kWarpgroup + 32;  // rows kernel: + the producer warp
constexpr int kCols = 128;  // weights kernel: output columns per block

// Byte offsets of the rows kernel's shared memory: the 2 kRing mbarriers,
// the ring of stages ([3][n][sd] bf16 each, n a chunk's columns of c_in, sd
// the stage's depth of c_out), and up to a c_out of 128 the h tile
// [64][hstride] f32 (column K all ones) and the dmsg tile [64][c_out] f32,
// past it D's parts [3][64][dq] bf16: 78 KB at K 48 and width 48, 98 KB at
// K 128 (two blocks per SM), 160 KB at K 128, c_in = c_out = 128, 144 KB
// at K = c_in = c_out = 256.
struct RowsLayout {
  Chunks ch;
  int dq, hstride;
  long stage, ring, hs, d, total;
  __host__ __device__ RowsLayout(int K, int c_in, int c_out) : ch(c_in, c_out) {
    dq = ch.dp;
    hstride = (K + 1) | 1;
    stage = 3 * 2L * ch.n * ch.sd;
    ring = 128;
    hs = ring + kRing * stage;
    if (ch.deep) {  // D's parts at hs
      d = hs;
      total = hs + 3 * 2L * kTile * dq;
    } else {
      d = hs + 4L * kTile * hstride;
      total = d + 4L * kTile * c_out;
    }
  }
};

// Blocks per SM the rows kernel's launch bounds hold the registers to: two
// (at most 168 registers a thread, so that two blocks' ten warps fit the
// register files of the SM's four sub-partitions) for the instances that
// fit them with at most a few bytes of spills (N * S below 128, or up to
// 160 with N at most 48: width 48 among them), else one.
template <int N, int S>
constexpr int kRowsMinBlocks =
    S <= 4 && (N * S < 128 || (N * S <= 160 && N <= 48)) ? 2 : 1;

// ---------------------------------------------------------------------------
// (a) dmsg, dh and dx_src for one 64-slot tile.  N = a chunk's columns of
// c_in (the N of R_k, f32_wgmma.cuh Chunks), S = c_out rounded up to 16,
// over 16 (its k16 steps), or kDeepA past a c_out of 128 (D's parts in
// shared memory).
template <int N, int S>
__global__ void __launch_bounds__(kThreads, kRowsMinBlocks<N, S>)
bwd_rows_f32_wgmma(const float* __restrict__ g, const float* __restrict__ h,
                   const float* __restrict__ x_src,
                   const bf16* __restrict__ image,
                   const int* __restrict__ slot_rows,
                   const float* __restrict__ row_weight,
                   const float* __restrict__ s_dense, float* __restrict__ dh,
                   float* __restrict__ dx_src, float* __restrict__ dmsg_out,
                   int blk, int K, int c_in, int c_out) {
  constexpr bool kDeep = S == kDeepA;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(K, c_in, c_out);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const long slot0 = static_cast<long>(blockIdx.x) * kTile;
  const long b = slot0 / blk;
  const long row_base = b * kRows;
  const bool compact = s_dense == nullptr;
  const int lane = threadIdx.x % 32;
  // every warp decides by itself whether the tile holds a real slot
  const bool real = !compact ||
                    __any_sync(0xffffffffu, slot_rows[slot0 + lane] >= 0 ||
                                                slot_rows[slot0 + lane + 32] >= 0);

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  const int chunks = L.ch.chunks;
  if (threadIdx.x >= kWarpgroup) {  // ---- producer ----
    if (real && lane == 0) {
      uint32_t j = 0;
      produce(full, empty, ring, reinterpret_cast<const unsigned char*>(image),
              static_cast<uint32_t>(L.stage),
              chunks * (K + 1) * L.ch.slices - 1, j);
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x;
  if (!real) {  // padding only: every gradient is 0
    for (int e = tid; e < kTile * K; e += kWarpgroup) dh[slot0 * K + e] = 0.f;
    for (int e = tid; e < kTile * c_in; e += kWarpgroup)
      dx_src[slot0 * c_in + e] = 0.f;
    for (int e = tid; e < kTile * c_out; e += kWarpgroup)
      dmsg_out[slot0 * c_out + e] = 0.f;
    return;
  }
  const int hstride = L.hstride;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* d_sm = reinterpret_cast<float*>(smem + L.d);
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.d);
  // dmsg[slot0 + s, o], float32: row_weight g[slot_rows] in CompactS form,
  // S^T g in the dense form
  auto dmsg_at = [&](int s, int o) {
    float d = 0.f;
    if (compact) {
      const int r = slot_rows[slot0 + s];
      if (r >= 0) d = row_weight[row_base + r] * g[(row_base + r) * c_out + o];
    } else {
      const float* s_col = s_dense + row_base * blk + (slot0 - b * blk) + s;
      for (int r = 0; r < kRows; ++r)
        d = fmaf(s_col[static_cast<long>(r) * blk], g[(row_base + r) * c_out + o], d);
    }
    return d;
  };

  const int r0 = acc_row(0);  // this thread's rows: r0 and r0 + 8
  uint32_t da[3][kDeep ? 1 : S][4];
  if constexpr (kDeep) {
    // D formed 8 columns at a time, written out and split into A's parts
    const int per = L.dq / 8;
    for (int p = tid; p < kTile * per; p += kWarpgroup) {
      const int s = p / per, o0 = 8 * (p - s * per);
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int o = o0 + u;
        v[u] = o < c_out ? dmsg_at(s, o) : 0.f;
        if (o < c_out) dmsg_out[(slot0 + s) * c_out + o] = v[u];
      }
      put_split8(a_sm, L.dq, s, o0, v);
    }
    fence_async_smem();
    warpgroup_sync(0);  // D's parts are in place
  } else {
    // h rows by cp.async (column K all ones), while dmsg forms
    prefetch_h(hs, h, slot0, K, hstride);
    for (int s = tid; s < kTile; s += kWarpgroup) hs[s * hstride + K] = 1.f;
    for (int e = tid; e < kTile * c_out; e += kWarpgroup) {
      const int s = e / c_out, o = e - s * c_out;
      const float d = dmsg_at(s, o);
      dmsg_out[slot0 * c_out + e] = d;
      d_sm[e] = d;
    }
    cp_async_wait_all();
    warpgroup_sync(0);  // h and the dmsg tile have landed

    // D's parts at this thread's fragment rows and columns
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = a_row(2 * u), col = 16 * s + a_col(2 * u);
        const float va = col < c_out ? d_sm[row * c_out + col] : 0.f;
        const float vb = col + 1 < c_out ? d_sm[row * c_out + col + 1] : 0.f;
        split3(va, vb, da[0][s][u], da[1][s][u], da[2][s][u]);
      }
  }

  // ---- per chunk c of c_in: dx = sum_k h~[:, k] R_k and dh[:, k] +=
  // sum_i x_src[:, i] R_k[:, i] at the chunk's columns i ----
  float dx[N / 2], xs[N / 2];  // xs: x_src at the chunk's columns
  const bool writer = tid % 4 == 0;
  int c = 0;
  // past a c_out of 128: h~[:, k] from device memory, the next k's loaded
  // while this one's products run (h~[:, K] = 1)
  const float* ha_row = h + (slot0 + r0) * K;
  const float* hb_row = ha_row + 8L * K;
  float hna = 0.f, hnb = 0.f;
  auto fin = [&](const float (&rk)[N / 2], int k) {
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
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int v = 0; v < N / 2; ++v) {
      if (v & 2) {
        dx[v] = fmaf(hb, rk[v], dx[v]);
        sb = fmaf(xs[v], rk[v], sb);
      } else {
        dx[v] = fmaf(ha, rk[v], dx[v]);
        sa = fmaf(xs[v], rk[v], sa);
      }
    }
    if (k < K) {
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      if (writer) {
        float* pa = dh + (slot0 + r0) * K + k;
        float* pb = dh + (slot0 + r0 + 8) * K + k;
        *pa = c ? *pa + sa : sa;
        *pb = c ? *pb + sb : sb;
      }
    }
  };
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  uint32_t j = 0;
  for (; c < chunks; ++c) {
#pragma unroll
    for (int v = 0; v < N / 2; ++v) {
      const int i = c * N + acc_col(v);
      xs[v] = i < c_in ? x_src[(slot0 + acc_row(v)) * c_in + i] : 0.f;
      dx[v] = 0.f;
    }
    if constexpr (kDeep) {
      hna = __ldg(ha_row);
      hnb = __ldg(hb_row);
      const DeepWalk<N, decltype(fin)> walk{
          desc(a_sm, L.dq), static_cast<uint32_t>(2 * kTile * L.dq >> 4),
          L.ch.slices, full, empty, desc(ring, L.ch.sd), dstage, dstage / 3,
          lane, fin};
      walk.all(K + 1, j);
    } else {
      const Walk<N, S, decltype(fin)> walk{da, full, empty, desc(ring, L.dq),
                                           dstage, dstage / 3, lane, fin};
      walk.all(K, j);
    }
#pragma unroll
    for (int v = 0; v < N / 2; ++v) {
      const int i = c * N + acc_col(v);
      if (i < c_in) dx_src[(slot0 + acc_row(v)) * c_in + i] = dx[v];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) partial[split, k, c] = sum over the split's slots e of h[e, k] z[e, c]
// for the block's 64 rows of K and kCols columns of c2, z[e, i*c_out + o] =
// x_src[e, i] dmsg[e, o]; the row-tile-0 blocks also write row K, db3.
// The weights kernel's shared memory: 112 KB at width 48 (two blocks per
// SM), 120 KB at 64, 152 KB at 128, and at 256 216 KB, just under the 227
// KB a block may take (one block per SM).
struct WeightsLayout {
  long a, z, x, d, hraw, total;
  __host__ __device__ WeightsLayout(int c_in, int c_out) {
    a = 0;                                   // h^T parts [3][64 k][64 e]
    z = a + 3 * 2L * kTile * kTile;          // z parts [3][kCols][64 e]
    x = z + 3 * 2L * kCols * kTile;          // x_src [64][c_in] f32
    d = x + 4L * kTile * c_in;               // dmsg [64][c_out] f32
    hraw = d + 4L * kTile * c_out;           // h [64 e][64 k] f32
    total = hraw + 4L * kTile * kTile;
  }
};

__global__ void __launch_bounds__(kWarpgroup)
bwd_weights_f32_wgmma(const float* __restrict__ h,
                      const float* __restrict__ x_src,
                      const float* __restrict__ dmsg,
                      const int* __restrict__ slot_rows,
                      float* __restrict__ partial, long num_chunks,
                      long chunks_per_split, int K, int c_in, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WeightsLayout L(c_in, c_out);
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  bf16* z_sm = reinterpret_cast<bf16*>(smem + L.z);
  float* x_sm = reinterpret_cast<float*>(smem + L.x);
  float* d_sm = reinterpret_cast<float*>(smem + L.d);
  float* h_sm = reinterpret_cast<float*>(smem + L.hraw);
  const int tid = threadIdx.x;
  const int c2 = c_in * c_out;
  const int n0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * kTile;
  const long split = blockIdx.z;
  const long c_lo = split * chunks_per_split;
  const long c_hi = c_lo + chunks_per_split < num_chunks
                        ? c_lo + chunks_per_split
                        : num_chunks;
  // this thread's column of z: c = n0 + tid (none past c2)
  const int col = n0 + tid;
  const bool has_col = col < c2;
  const int ci = has_col ? col / c_out : 0, co = has_col ? col - ci * c_out : 0;
  const int zpart = kCols * kTile, apart = kTile * kTile;  // elements

  // rows of z past c2 stay zero
  for (int e = tid; e < 3 * zpart / 8; e += kWarpgroup)
    reinterpret_cast<uint4*>(z_sm)[e] = make_uint4(0u, 0u, 0u, 0u);
  float sum[kCols / 2], acc[kCols / 2];
#pragma unroll
  for (int v = 0; v < kCols / 2; ++v) sum[v] = 0.f;
  float dbias = 0.f;

  // the first chunk from ch on (c_hi if none) that holds a real slot
  // (every chunk in the dense form): chunks of padding only (dmsg 0) are
  // skipped in CompactS form
  auto next_real = [&](long ch) {
    if (slot_rows == nullptr) return ch;
    for (; ch < c_hi; ++ch)
      if (__syncthreads_or(tid < kTile && slot_rows[ch * kTile + tid] >= 0))
        break;
    return ch;
  };
  // chunk ch's rows of h (columns k0 .. k0+63, zeros past K), x_src and
  // dmsg into shared memory by cp.async: 16-byte pieces where the rows
  // allow them; nothing waits for them here
  const bool vec_h = K % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const bool vec = (reinterpret_cast<uintptr_t>(x_src) |
                    reinterpret_cast<uintptr_t>(dmsg)) % 16 == 0;
  auto fetch = [&](long ch) {
    const long s0 = ch * kTile;
    if (vec_h) {
      for (int q = tid; q < kTile * kTile / 4; q += kWarpgroup) {
        const int s = q >> 4, k = k0 + 4 * (q & 15);
        const int bytes = k < K ? 4 * min(4, K - k) : 0;
        cp_async16(h_sm + 4 * q, bytes ? h + (s0 + s) * K + k : h, bytes);
      }
    } else {
      for (int q = tid; q < kTile * kTile; q += kWarpgroup) {
        const int s = q >> 6, k = k0 + (q & 63);
        cp_async4(h_sm + q, k < K ? h + (s0 + s) * K + k : h, k < K ? 4 : 0);
      }
    }
    if (vec) {
      for (int q = tid; q < 16 * c_in; q += kWarpgroup)
        cp_async16(x_sm + 4 * q, x_src + s0 * c_in + 4 * q, 16);
      for (int q = tid; q < 16 * c_out; q += kWarpgroup)
        cp_async16(d_sm + 4 * q, dmsg + s0 * c_out + 4 * q, 16);
    } else {
      for (int q = tid; q < kTile * c_in; q += kWarpgroup)
        cp_async4(x_sm + q, x_src + s0 * c_in + q, 4);
      for (int q = tid; q < kTile * c_out; q += kWarpgroup)
        cp_async4(d_sm + q, dmsg + s0 * c_out + q, 4);
    }
    cp_async_commit();
  };
  const uint64_t dA = desc_mn(a_sm, kTile), dZ = desc(z_sm, kTile);
  const uint32_t dApart = 2 * apart >> 4, dZpart = 2 * zpart >> 4;
  long ch = next_real(c_lo);
  if (ch < c_hi) fetch(ch);
  while (ch < c_hi) {
    cp_async_wait_all();
    __syncthreads();  // the chunk's rows have landed, and every thread is
                      // done with the last chunk's products
    // A = h^T, MN-major: 8 consecutive k of one slot are a 16-byte piece of
    // each part; thread t splits the pieces t + 128 m
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = tid + kWarpgroup * m, s = q >> 3, kk = 8 * (q & 7);
      const float4 lo = *reinterpret_cast<const float4*>(h_sm + s * kTile + kk);
      const float4 hi = *reinterpret_cast<const float4*>(h_sm + s * kTile + kk + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint4 p[3];
      split3_8(v, p);
      const int at = mnmajor(kk, s, kTile);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        *reinterpret_cast<uint4*>(a_sm + r * apart + at) = p[r];
    }
    if (has_col) {
      for (int s = 0; s < kTile; s += 8) {  // 8 slots: a 16-byte piece each
        float z[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          z[u] = x_sm[(s + u) * c_in + ci] * d_sm[(s + u) * c_out + co];
          dbias += z[u];
        }
        uint4 p[3];
        split3_8(z, p);
        const int at = kmajor(tid, s, kTile);
#pragma unroll
        for (int r = 0; r < 3; ++r)
          *reinterpret_cast<uint4*>(z_sm + r * zpart + at) = p[r];
      }
    }
    fence_async_smem();
    __syncthreads();  // the parts are in place; the raw rows are free
    fence_operand(acc);
    fence();
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int st = 0; st < kTile / 16; ++st)
        Mma<kCols, 1>::run(acc, dA + a_part(q) * dApart + 16 * st,
                           dZ + b_part(q) * dZpart + 16 * st, q + st > 0);
    commit();
    ch = next_real(ch + 1);
    if (ch < c_hi) fetch(ch);  // while the products run
    wait_all();
    fence_operand(acc);
#pragma unroll
    for (int v = 0; v < kCols / 2; ++v) sum[v] += acc[v];
  }
  float* dst = partial + split * (K + 1) * static_cast<long>(c2);
#pragma unroll
  for (int v = 0; v < kCols / 2; ++v) {
    const int k = k0 + acc_row(v), c = n0 + acc_col(v);
    if (k < K && c < c2) dst[static_cast<long>(k) * c2 + c] = sum[v];
  }
  if (blockIdx.y == 0 && has_col) dst[static_cast<long>(K) * c2 + col] = dbias;
}

template <int N, int S>
cudaError_t launch_rows(const float* g, const float* h, const float* x_src,
                        const float* w3, const float* b3, const int* slot_rows,
                        const float* row_weight, const float* s_dense,
                        bf16* image, float* dh, float* dx_src, float* dmsg,
                        long num_tiles, int blk, int K, int c_in, int c_out,
                        cudaStream_t stream) {
  const RowsLayout L(K, c_in, c_out);
  const size_t smem = static_cast<size_t>(L.total);
  auto kernel = bwd_rows_f32_wgmma<N, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = launch_image(w3, b3, image, K, c_in, c_out, L.ch, false, stream);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(num_tiles), kThreads, smem, stream>>>(
      g, h, x_src, image, slot_rows, row_weight, s_dense, dh, dx_src, dmsg,
      blk, K, c_in, c_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the rows kernel needs.
long fused_edge_conv_bwd_f32_wgmma_smem_bytes(int K, int c_in, int c_out) {
  return RowsLayout(K, c_in, c_out).total;
}

// Blocks one SM holds at once at these widths: the rows kernel's
// (weights = 0) or the weights kernel's (-1 if they are not taken).
int fused_edge_conv_bwd_f32_wgmma_blocks_per_sm(int K, int c_in, int c_out,
                                                int weights) {
  if (K < 1 || K > kMaxK) return -1;
  if (weights)
    return blocks_on_sm(bwd_weights_f32_wgmma, kWarpgroup,
                        static_cast<size_t>(WeightsLayout(c_in, c_out).total));
  const RowsLayout L(K, c_in, c_out);
  return with_wide_shape(c_in, c_out, [&](auto n, auto s) {
    return blocks_on_sm(bwd_rows_f32_wgmma<decltype(n)::value, decltype(s)::value>,
                        kThreads, static_cast<size_t>(L.total));
  }, -1);
}

// Launches the float32 backward on `stream`: the stage image of w3 and b3,
// the rows kernel, then the weights kernel.  Pointers are device pointers to
// float32 arrays but slot_rows (int32) and image (bfloat16 scratch
// [chunks][K+1][slices][3][n][sd], f32_wgmma.cuh Chunks(c_in, c_out): c_out
// padded to dq = slices x sd, to 16 up to 128, past it to 32 in stages of
// 32; 16-byte aligned); dmsg [slots, c_out] is written by the
// rows kernel and read by the weights kernel.  Exactly one of s_dense and
// (slot_rows, row_weight) is non-null.  partial is [num_splits, K+1,
// c_in*c_out] (dw3 rows then the db3 row, summed over splits by the
// caller).  Returns the cudaError_t of the launches (0 on success).
int fused_edge_conv_bwd_f32_wgmma_backward(
    const void* g, const void* h, const void* x_src, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* image, void* dh, void* dx_src, void* dmsg,
    void* partial, int num_blocks, int blk, int K, int c_in, int c_out,
    int num_splits, void* stream) {
  if (K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      num_splits < 1 || reinterpret_cast<uintptr_t>(image) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long num_tiles = static_cast<long>(num_blocks) * blk / kTile;
  cudaError_t err = with_wide_shape(c_in, c_out, [&](auto n, auto s) {
    return launch_rows<decltype(n)::value, decltype(s)::value>(
        static_cast<const float*>(g), static_cast<const float*>(h),
        static_cast<const float*>(x_src), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
        static_cast<const float*>(row_weight),
        static_cast<const float*>(s_dense), static_cast<bf16*>(image),
        static_cast<float*>(dh), static_cast<float*>(dx_src),
        static_cast<float*>(dmsg), num_tiles, blk, K, c_in, c_out, st);
  }, cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  // output tiles (as ops/fused_conv.py:weight_tiles): columns, rows of K
  const int tiles[2] = {(c_in * c_out + kCols - 1) / kCols,
                        (K + kTile - 1) / kTile};
  const long per_split = (num_tiles + num_splits - 1) / num_splits;
  const size_t smem = static_cast<size_t>(WeightsLayout(c_in, c_out).total);
  err = allow_smem(bwd_weights_f32_wgmma, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_weights_f32_wgmma<<<dim3(tiles[0], tiles[1], num_splits), kWarpgroup,
                          smem, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(x_src),
      static_cast<const float*>(dmsg), static_cast<const int*>(slot_rows),
      static_cast<float*>(partial), num_tiles, per_split, K, c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
