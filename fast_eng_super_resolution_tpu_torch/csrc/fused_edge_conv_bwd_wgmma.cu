// Fused edge-conditioned conv layer, backward, in bfloat16 on Hopper's tensor
// cores (wgmma, sm_90a): the gradients of fused_edge_conv_wgmma.cu's forward.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_edge_conv_bwd_jit
// for bfloat16 operands (fused_edge_conv_bwd_f32_wgmma.cu is the float32
// instance) and computes the same function.  With the forward's notation, g the
// gradient of its output and W~ = [[w3], [b3]] seen as [K+1, c_in, c_out]:
//
//   dmsg[e, o]   = sum_r S[r, e] g[r, o]                  (0 on padding)
//   dh[e, k]     = sum_{i,o} x_src[e, i] dmsg[e, o] w3[k, i*c_out + o]
//   dx_src[e, i] = sum_{k<=K, o} h~[e, k] dmsg[e, o] W~[k, i, o]
//   dw3[k, i*c_out + o] = sum_e h[e, k] x_src[e, i] dmsg[e, o]
//   db3[i*c_out + o]    = sum_e x_src[e, i] dmsg[e, o]
//
// Numbers.  h, x_src, w3 and dmsg are bfloat16 values (the plain version,
// ops/fused_conv.py:fused_edge_conv_bwd_plain, rounds the same four); b3 and
// every sum are float32.  No operand of a wgmma is a rounding of a product
// or a sum:
//
//  (a) rows kernel, factored.  R_k = D @ W3_k^T ([64, c_out] x [c_out, c_in],
//      D the tile's dmsg rows, W3_k = w3[k] as [c_in, c_out], both bf16
//      values of the plain version) on the tensor cores; then in float32
//      dx_src += h[:, k] R_k and dh[:, k] = sum_i x_src[:, i] R_k[:, i] (the
//      row sum over the accumulator fragment takes a quad shuffle), and the
//      b3 term dx_src += D @ b3^T on the CUDA cores.
//  (b) weights kernel, exact split.  dw3 = h^T @ z with z = x_src (x) dmsg.
//      A product of two bf16 values has at most 16 significant bits, so
//      hi = bf16(z) and lo = bf16(z - hi) (z - hi is exact in float32 and
//      needs at most 8 significant bits) give z = hi + lo EXACTLY: the split
//      is no approximation.  h^T @ z_hi + h^T @ z_lo runs as two wgmma
//      passes, each product of two bf16 values again exact in the float32
//      accumulator.  (A lo below bf16's normal range would lose bits; that
//      needs |z| < 2^-118, far below any gradient here.)  db3 = sum_e z is
//      summed in float32 from z itself by the thread that forms its column.
//
// Design.
//  (a) one warpgroup per 64-slot tile (grid: every tile of the graph, 4864
//      at the serving chunk for 132 SMs); the tile's receiver block is
//      tile / (blk / 64).  It gathers dmsg[e] = row_weight g[slot_rows[e]]
//      straight from g in CompactS form (the dense form sums S^T g), rounds
//      it to bf16, writes it once (bf16, for the weights kernel) and stages
//      it as the wgmma's A operand; W3_k, K-major in w3's own layout, is
//      copied per k in 16-byte pieces by cp.async into a ring of three
//      buffers, two rows ahead of the running product (wgmma_tile.cuh
//      W3Row).  x_src at the thread's accumulator rows and columns waits in
//      shared memory for the row sums of dh, in the thread's own fragment
//      order (four bf16 values per 8-byte read, consecutive threads on
//      consecutive pieces): registers hold the accumulators at width 128.
//      Tiles of padding only write zeros in CompactS form.
//  (b) output tiles of 64 rows of K x 128 columns of c_in c_out, times slot
//      splits: grid (column tiles, row tiles, splits).  Per 64-slot chunk a
//      block copies h rows in 16-byte pieces as A (h^T, MN-major), forms
//      z_hi and z_lo as B (each thread one column, in slot order, 16-byte
//      stores) and runs 2 x 4 m64n128k16 products, whose sum it moves into
//      its split's partial [K+1, c2] (row K: db3) every 32 chunks; the
//      wrapper sums the partials in a fixed order.  No atomics anywhere: two launches on the
//      same inputs give the same bits.
//
// Widths.  c_in, c_out and K 1..256.  N, the rows kernel's product width
// (m64nNk16, N up to 128) and a template argument (with_wide_width), is
// c_in rounded up to 8 where the block's shared memory (RowsLayout) holds
// it: every width up to 128 at K up to 128 (209 KB at c_in = c_out = K =
// 128, one block per SM).  Else c_in is cut into chunks (RowsChunks) of the
// widest N that fits, evened out, which the tile walks in turn: the W3_k
// row stream runs on through the chunks (step c K + k reads rows i of chunk
// c), b3^T and the x_src pieces are staged per chunk, each chunk writes its
// dx_src columns and adds its share of dh[:, k] to the earlier chunks' (the
// same thread, in chunk order).  At K = c_in = c_out = 256: five chunks of
// 56 (212 KB).  The weights kernel's tiles cover any c_in c_out (74 KB at
// 128, 104 KB at 256).

// Bound.  About 3 x 2 (K+1) c_in c_out operations per real slot (three
// products of the forward's size) against (K + c_in) 2 + c_out 4 +
// (K + c_in) 4 bytes: bounded by operations on the tensor cores.  What
// stands in the way here: w3 is read from L2 once per tile in (a), the
// float32 epilogues run on the CUDA cores, and (b) forms z on them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_bwd_wgmma.so
//        fused_edge_conv_bwd_wgmma.cu

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
constexpr int kCols = 128;  // weights kernel: output columns per block
constexpr int kPromote = 32;  // weights kernel: chunks per tensor-core sum

__host__ __device__ inline int h_stride(int K) { return K + (6 - K % 4) % 4; }

// A bf16 pair as one 32-bit word, .x first (the lower address), and back.
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  union {
    __nv_bfloat162 b;
    uint32_t u;
  } cv;
  cv.b = v;
  return cv.u;
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  union {
    uint32_t u;
    __nv_bfloat162 b;
  } cv;
  cv.u = u;
  return cv.b;
}

// Byte offsets of the rows kernel's shared memory, np = a chunk's channels
// of c_in padded to 8.
struct RowsLayout {
  int dq, hs;
  long b, h, b3, xs, srow, total;
  __host__ __device__ RowsLayout(int K, int c_out, int np) {
    dq = round_up(c_out, 16);
    hs = h_stride(K);
    b = 2L * kTile * dq;                     // a: dmsg [64][dq]
    h = b + 2L * kRowBufs * np * dq;         // b: W3_k [kRowBufs][np][dq]
    b3 = h + 2L * kTile * hs;                // h [64][hs]
    xs = b3 + 4L * c_out * np;               // b3^T [c_out][np] f32
    srow = xs + 2L * kTile * np;             // x_src [np / 8][128][4] bf16
    total = srow + 4L * kTile;
  }
};

// The chunks of c_in the rows kernel walks: `chunks` of n channels (a
// multiple of 8, at most 128), one of all of them where its RowsLayout fits
// a block (every width up to 128 at K up to 128), else the widest n that
// fits, evened out over the chunks (ops/fused_conv.py:wgmma_rows_chunks).
struct RowsChunks {
  int chunks, n;
  __host__ __device__ RowsChunks(int K, int c_in, int c_out) {
    const int r8 = round_up(c_in, 8);
    int most = r8 < 128 ? r8 : 128;
    while (most > 8 && RowsLayout(K, c_out, most).total > kSmemMax) most -= 8;
    chunks = (r8 + most - 1) / most;
    n = round_up((r8 + chunks - 1) / chunks, 8);
  }
};

// ---------------------------------------------------------------------------
// (a) dmsg, dh and dx_src for one 64-slot tile.  NP = a chunk's channels of
// c_in padded to 8 (the N of R_k); its depth is c_out padded to 16.
template <int NP>
__global__ void __launch_bounds__(kWarpgroup)
bwd_rows_wgmma(const float* __restrict__ g, const bf16* __restrict__ h,
               const bf16* __restrict__ x_src, const bf16* __restrict__ w3,
               const float* __restrict__ b3,
               const int* __restrict__ slot_rows,
               const float* __restrict__ row_weight,
               const float* __restrict__ s_dense, float* __restrict__ dh,
               float* __restrict__ dx_src, bf16* __restrict__ dmsg_out,
               int blk, int K, int c_in, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(K, c_out, NP);
  const int dq = L.dq, hs = L.hs;
  bf16* a_sm = reinterpret_cast<bf16*>(smem);
  bf16* b_sm = reinterpret_cast<bf16*>(smem + L.b);
  bf16* h_sm = reinterpret_cast<bf16*>(smem + L.h);
  float* b3_sm = reinterpret_cast<float*>(smem + L.b3);
  uint2* x_sm = reinterpret_cast<uint2*>(smem + L.xs);
  int* srow = reinterpret_cast<int*>(smem + L.srow);

  const int tid = threadIdx.x;
  const long slot0 = static_cast<long>(blockIdx.x) * kTile;
  const long b = slot0 / blk;
  const long row_base = b * kRows;
  const bool compact = s_dense == nullptr;
  const bf16 zero = __float2bfloat16(0.f);
  const int chunks = (c_in + NP - 1) / NP;

  if (compact) {
    int real = 0;
    if (tid < kTile) {
      srow[tid] = slot_rows[slot0 + tid];
      real = srow[tid] >= 0;
    }
    if (!__syncthreads_or(real)) {  // padding only: every gradient is 0
      for (int e = tid; e < kTile * K; e += kWarpgroup) dh[slot0 * K + e] = 0.f;
      for (int e = tid; e < kTile * c_in; e += kWarpgroup)
        dx_src[slot0 * c_in + e] = 0.f;
      for (int e = tid; e < kTile * c_out; e += kWarpgroup)
        dmsg_out[slot0 * c_out + e] = zero;
      return;
    }
  }

  // ---- stage dmsg (rounded to bf16; channels tid % 64 + 64 m of slots
  // tid / 64 + 2 m'), h and W3_0 ----
  const W3Row<false> wr(w3, c_in, c_out, c_out, dq);
  for (int e = tid; e < kRowBufs * NP * dq; e += kWarpgroup) b_sm[e] = zero;
#pragma unroll 4
  for (int s = tid >> 6; s < kTile; s += 2)
    for (int o = tid & 63; o < dq; o += 64) {
      bf16 v = zero;
      if (o < c_out) {
        float d = 0.f;
        if (compact) {
          const int r = srow[s];
          if (r >= 0) d = row_weight[row_base + r] * g[(row_base + r) * c_out + o];
        } else {
          const float* s_col = s_dense + row_base * blk + (slot0 - b * blk) + s;
          for (int r = 0; r < kRows; ++r)
            d += s_col[static_cast<long>(r) * blk] * g[(row_base + r) * c_out + o];
        }
        v = __float2bfloat16(d);
        dmsg_out[(slot0 + s) * c_out + o] = v;
      }
      a_sm[kmajor(s, o, dq)] = v;
    }
#pragma unroll 4
  for (int s = tid >> 6; s < kTile; s += 2)
    for (int k = tid & 63; k < K; k += 64)
      h_sm[s * hs + k] = h[(slot0 + s) * K + k];
  // W3_k ([c_in, c_out]) streams through the three buffers, chunk by chunk
  // of c_in: step n = c K + k reads buffer n % 3 while rows n + 1 and n + 2
  // land in the other two (a step with no row left to start closes an
  // empty group)
  const int bsize = NP * dq, steps = chunks * K;
  auto start = [&](int n) {
    if (n < steps) {
      const int c = n / K, i_lo = c * NP;
      wr.start(b_sm + (n % kRowBufs) * bsize, n - c * K, i_lo,
               c_in - i_lo < NP ? c_in - i_lo : NP);
    } else {
      pieces_commit();
    }
  };
  __syncthreads();  // the zeros land before the first row
  start(0);
  start(1);

  const int r0 = acc_row(0);  // this thread's rows: r0 and r0 + 8
  const bool writer = tid % 4 == 0;
  for (int c = 0; c < chunks; ++c) {
    const int i_lo = c * NP;
    // x_src at this thread's accumulator entries j = 4 m .. 4 m + 3 (rows
    // r0, r0, r0 + 8, r0 + 8; columns c, c + 1, c, c + 1 of the chunk) as
    // piece m, and the chunk's b3^T (every thread is done with the last
    // chunk's: it passed the last step's barrier)
#pragma unroll
    for (int m = 0; m < NP / 8; ++m) {
      bf16 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i_lo + acc_col(4 * m + u);
        v[u] = i < c_in ? x_src[(slot0 + acc_row(4 * m + u)) * c_in + i] : zero;
      }
      x_sm[m * kWarpgroup + tid] =
          make_uint2(as_u32(__halves2bfloat162(v[0], v[1])),
                     as_u32(__halves2bfloat162(v[2], v[3])));
    }
    for (int e = tid; e < c_out * NP; e += kWarpgroup) {
      const int o = e / NP, i = i_lo + e - o * NP;
      b3_sm[e] = i < c_in ? b3[i * c_out + o] : 0.f;
    }
    pieces_wait<1>();  // the chunk's first row has landed
    fence_async_smem();
    __syncthreads();  // and so have x_src's pieces and b3^T

    // ---- dx = D @ b3^T (CUDA cores), then += h[:, k] R_k over k ----
    float dx[NP / 2];
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) dx[j] = 0.f;
    for (int o = 0; o < c_out; ++o) {
      const float da = __bfloat162float(a_sm[kmajor(r0, o, dq)]);
      const float db = __bfloat162float(a_sm[kmajor(r0 + 8, o, dq)]);
#pragma unroll
      for (int j = 0; j < NP / 2; ++j)
        dx[j] += ((j >> 1) & 1 ? db : da) * b3_sm[o * NP + acc_col(j)];
    }
    for (int k = 0; k < K; ++k) {
      const int n = c * K + k;
      float rk[NP / 2];
      product<NP>(rk, a_sm, b_sm + (n % kRowBufs) * bsize, dq);
      // step n + 2's row into the buffer that step n - 1's finished
      // product read
      start(n + 2);
      wait_all();
      fence_operand(rk);
      const float ha = __bfloat162float(h_sm[r0 * hs + k]);
      const float hb = __bfloat162float(h_sm[(r0 + 8) * hs + k]);
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int m = 0; m < NP / 8; ++m) {
        const uint2 xv = x_sm[m * kWarpgroup + tid];
        const float2 xa = __bfloat1622float2(as_bf162(xv.x));
        const float2 xb = __bfloat1622float2(as_bf162(xv.y));
        const int j = 4 * m;
        dx[j] += ha * rk[j];
        da += xa.x * rk[j];
        dx[j + 1] += ha * rk[j + 1];
        da += xa.y * rk[j + 1];
        dx[j + 2] += hb * rk[j + 2];
        db += xb.x * rk[j + 2];
        dx[j + 3] += hb * rk[j + 3];
        db += xb.y * rk[j + 3];
      }
      da += __shfl_xor_sync(0xffffffffu, da, 1);
      da += __shfl_xor_sync(0xffffffffu, da, 2);
      db += __shfl_xor_sync(0xffffffffu, db, 1);
      db += __shfl_xor_sync(0xffffffffu, db, 2);
      if (writer) {
        float* pa = dh + (slot0 + r0) * K + k;
        float* pb = dh + (slot0 + r0 + 8) * K + k;
        *pa = c ? *pa + da : da;
        *pb = c ? *pb + db : db;
      }
      pieces_wait<1>();  // step n + 1's row has landed
      fence_async_smem();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) {
      const int i = i_lo + acc_col(j);
      if (i < c_in) dx_src[(slot0 + acc_row(j)) * c_in + i] = dx[j];
    }
  }
}

// Adds the weights kernel's tensor-core sums into its partial (stores them
// the first time) and restarts them from zero.
__device__ __forceinline__ void promote(float (&acc)[kCols / 2], float* dst,
                                        bool& first, int k0, int n0, int K,
                                        int c2) {
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) {
    const int k = k0 + acc_row(j), c = n0 + acc_col(j);
    if (k < K && c < c2) {
      float* p = dst + static_cast<long>(k) * c2 + c;
      *p = first ? acc[j] : *p + acc[j];
    }
    acc[j] = 0.f;
  }
  first = false;
}

// ---------------------------------------------------------------------------
// (b) partial[split, k, c] = sum over the split's slots e of h[e, k] z[e, c]
// for the block's 64 rows of K and kCols columns of c2, z[e, i*c_out + o] =
// x_src[e, i] dmsg[e, o]; the row-tile-0 blocks also write row K, db3.
__global__ void __launch_bounds__(kWarpgroup)
bwd_weights_wgmma(const bf16* __restrict__ h, const bf16* __restrict__ x_src,
                  const bf16* __restrict__ dmsg,
                  const int* __restrict__ slot_rows,
                  float* __restrict__ partial, long num_chunks,
                  long chunks_per_split, int K, int c_in, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_sm = reinterpret_cast<bf16*>(smem);   // h^T [64 k][64 e]
  bf16* hi_sm = a_sm + kTile * kTile;           // z_hi [kCols][64 e]
  bf16* lo_sm = hi_sm + kCols * kTile;          // z_lo [kCols][64 e]
  bf16* x_sm = lo_sm + kCols * kTile;           // x_src [64][c_in]
  bf16* d_sm = x_sm + kTile * c_in;             // dmsg [64][c_out]
  const int tid = threadIdx.x;
  const int c2 = c_in * c_out;
  const int n0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * kTile;
  const long split = blockIdx.z;
  const long c_lo = split * chunks_per_split;
  const long c_hi = c_lo + chunks_per_split < num_chunks
                        ? c_lo + chunks_per_split
                        : num_chunks;
  const bf16 zero = __float2bfloat16(0.f);
  // this thread's column of z: c = n0 + tid (none past c2)
  const int col = n0 + tid;
  const bool has_col = col < c2;
  const int ci = has_col ? col / c_out : 0, co = has_col ? col - ci * c_out : 0;

  // columns past c2 stay zero
  for (int e = tid; e < kCols * kTile; e += kWarpgroup) {
    hi_sm[e] = zero;
    lo_sm[e] = zero;
  }
  float acc[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) acc[j] = 0.f;
  float dbias = 0.f;
  // The tensor cores' float32 sum loses more per addition than a float32
  // add (at the train batch its error grew with the slots it ran over), so
  // every kPromote chunks it is added into the split's partial in device
  // memory and restarted from zero.  Each thread adds to its own entries,
  // in chunk order: no atomics, the same bits on every run.
  float* dst = partial + split * (K + 1) * static_cast<long>(c2);
  int pending = 0;
  bool first = true;

  // 16-byte copies of the x_src and dmsg rows where both are aligned
  const bool vec = (reinterpret_cast<uintptr_t>(x_src) |
                    reinterpret_cast<uintptr_t>(dmsg)) % 16 == 0;
  // CompactS: chunks of padding only are skipped; each chunk loads the
  // next one's flags, so that the test waits on no load
  const bool compact = slot_rows != nullptr;
  int real_next = 0;
  if (compact && tid < kTile && c_lo < c_hi)
    real_next = slot_rows[c_lo * kTile + tid] >= 0;
  // A = h^T, MN-major: 8 consecutive k of one slot are a 16-byte piece of
  // an h row; thread t owns the pieces t + 128 m
  const bool vec_h = K % 8 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  for (long ch = c_lo; ch < c_hi; ++ch) {
    const long s0 = ch * kTile;
    const int real = real_next;
    if (compact && tid < kTile && ch + 1 < c_hi)
      real_next = slot_rows[s0 + kTile + tid] >= 0;
    if (compact) {
      if (!__syncthreads_or(real)) continue;
    } else {
      __syncthreads();
    }
    if (vec_h) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int q = tid + kWarpgroup * m, s = q >> 3, k = 8 * (q & 7);
        const uint4 v = k0 + k < K ? *reinterpret_cast<const uint4*>(
                                         h + (s0 + s) * K + k0 + k)
                                   : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(a_sm + mnmajor(k, s, kTile)) = v;
      }
    } else {
      for (int e = tid; e < kTile * kTile; e += kWarpgroup) {
        const int s = e >> 6, k = e & 63;
        a_sm[mnmajor(k, s, kTile)] = k0 + k < K ? h[(s0 + s) * K + k0 + k] : zero;
      }
    }
    if (vec) {
      const uint4* xs = reinterpret_cast<const uint4*>(x_src + s0 * c_in);
      const uint4* ds = reinterpret_cast<const uint4*>(dmsg + s0 * c_out);
      for (int e = tid; e < 8 * c_in; e += kWarpgroup)
        reinterpret_cast<uint4*>(x_sm)[e] = xs[e];
      for (int e = tid; e < 8 * c_out; e += kWarpgroup)
        reinterpret_cast<uint4*>(d_sm)[e] = ds[e];
    } else {
      for (int e = tid; e < kTile * c_in; e += kWarpgroup)
        x_sm[e] = x_src[s0 * c_in + e];
      for (int e = tid; e < kTile * c_out; e += kWarpgroup)
        d_sm[e] = dmsg[s0 * c_out + e];
    }
    __syncthreads();
    if (has_col) {
      for (int s = 0; s < kTile; s += 8) {  // 8 slots: one 16-byte row each
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float z[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = s + 2 * q + u;
            z[u] = __bfloat162float(x_sm[e * c_in + ci]) *
                   __bfloat162float(d_sm[e * c_out + co]);
            dbias += z[u];
          }
          const __nv_bfloat162 zh = __floats2bfloat162_rn(z[0], z[1]);
          const float2 zf = __bfloat1622float2(zh);
          hi[q] = as_u32(zh);
          lo[q] = as_u32(__floats2bfloat162_rn(z[0] - zf.x, z[1] - zf.y));
        }
        const int at = kmajor(tid, s, kTile);
        *reinterpret_cast<uint4*>(hi_sm + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(lo_sm + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_async_smem();
    __syncthreads();
    const uint64_t da = desc_mn(a_sm, kTile), dhi = desc(hi_sm, kTile),
                   dlo = desc(lo_sm, kTile);
    fence_operand(acc);
    fence();
#pragma unroll
    for (int st = 0; st < kTile / 16; ++st) {
      Mma<kCols, 1>::run(acc, da + 16 * st, dhi + 16 * st, 1);
      Mma<kCols, 1>::run(acc, da + 16 * st, dlo + 16 * st, 1);
    }
    commit();
    wait_all();
    fence_operand(acc);
    if (++pending == kPromote) {
      promote(acc, dst, first, k0, n0, K, c2);
      pending = 0;
    }
  }
  if (pending > 0 || first) promote(acc, dst, first, k0, n0, K, c2);
  if (blockIdx.y == 0 && has_col) dst[static_cast<long>(K) * c2 + col] = dbias;
}

// 74 KB at c_in = c_out = 128, 104 KB at 256.
size_t weights_smem_bytes(int c_in, int c_out) {
  return 2 * (kTile * kTile + 2 * kCols * kTile + kTile * (c_in + c_out));
}

template <int NP>
cudaError_t launch_rows(const void* g, const void* h, const void* x_src,
                        const void* w3, const void* b3, const void* slot_rows,
                        const void* row_weight, const void* s_dense, void* dh,
                        void* dx_src, void* dmsg, long num_tiles, int blk,
                        int K, int c_in, int c_out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(RowsLayout(K, c_out, NP).total);
  auto kernel = bwd_rows_wgmma<NP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(num_tiles), kWarpgroup, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const bf16*>(h),
      static_cast<const bf16*>(x_src), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
      static_cast<const float*>(row_weight),
      static_cast<const float*>(s_dense), static_cast<float*>(dh),
      static_cast<float*>(dx_src), static_cast<bf16*>(dmsg), blk, K, c_in,
      c_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the rows kernel needs.
long fused_edge_conv_bwd_wgmma_smem_bytes(int K, int c_in, int c_out) {
  return RowsLayout(K, c_out, RowsChunks(K, c_in, c_out).n).total;
}

// Blocks one SM holds at once at these widths: the rows kernel's
// (weights = 0) or the weights kernel's (-1 if they are not taken).
int fused_edge_conv_bwd_wgmma_blocks_per_sm(int K, int c_in, int c_out,
                                            int weights) {
  if (weights) return blocks_per_sm(bwd_weights_wgmma, weights_smem_bytes(c_in, c_out));
  const int np = RowsChunks(K, c_in, c_out).n;
  return with_wide_width(np, [&](auto n) {
    return blocks_per_sm(bwd_rows_wgmma<decltype(n)::value>,
                         static_cast<size_t>(RowsLayout(K, c_out, np).total));
  }, -1);
}

// Launches the bfloat16 backward on `stream`: the rows kernel, then the
// weights kernel.  Pointers are device pointers; h, x_src and w3 bfloat16;
// g, b3, row_weight, s_dense, dh, dx_src and partial float32; dmsg
// bfloat16 (written by the first launch, read by the second); slot_rows
// int32.  Exactly one of s_dense and (slot_rows, row_weight) is non-null.
// partial is [num_splits, K+1, c_in*c_out] (dw3 rows then the db3 row,
// summed over splits by the caller).  Returns the cudaError_t of the
// launches (0 on success).
int fused_edge_conv_bwd_wgmma_backward(
    const void* g, const void* h, const void* x_src, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* dh, void* dx_src, void* dmsg, void* partial,
    int num_blocks, int blk, int K, int c_in, int c_out, int num_splits,
    void* stream) {
  if (K < 1 || K > kMaxK || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      num_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long num_tiles = static_cast<long>(num_blocks) * blk / kTile;
  cudaError_t err = with_wide_width(RowsChunks(K, c_in, c_out).n, [&](auto n) {
    return launch_rows<decltype(n)::value>(g, h, x_src, w3, b3, slot_rows,
                                           row_weight, s_dense, dh, dx_src,
                                           dmsg, num_tiles, blk, K, c_in,
                                           c_out, s);
  }, cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  // output tiles (as ops/fused_conv.py:weight_tiles): columns, rows of K
  const int tiles[2] = {(c_in * c_out + kCols - 1) / kCols,
                        (K + kTile - 1) / kTile};
  const long per_split = (num_tiles + num_splits - 1) / num_splits;
  const size_t smem = weights_smem_bytes(c_in, c_out);
  err = allow_smem(bwd_weights_wgmma, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_weights_wgmma<<<dim3(tiles[0], tiles[1], num_splits), kWarpgroup, smem,
                      s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(x_src),
      static_cast<const bf16*>(dmsg), static_cast<const int*>(slot_rows),
      static_cast<float*>(partial), num_tiles, per_split, K, c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
