// Fused edge-conditioned conv layer with rank-r factorized edge kernels,
// backward, in bfloat16 on Hopper's tensor cores (wgmma, sm_90a): the
// gradients of fused_edge_conv_lowrank_wgmma.cu's forward.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_lowrank_bwd_jit
// for bfloat16 operands at every rank 1 .. 256 and K, c_in, c_out 1 .. 256
// (fused_edge_conv_lowrank_bwd_f32_wgmma.cu is the float32 instance) and
// computes the same function, w3's and b3's gradients in the model's
// column layout.  With the forward's notation and g the gradient of
// its output, per slot e:
//
//   dmsg[o]   = sum_r S[r, e] g[r, o]                 (0 on padding)
//   dt[q]     = sum_o V[o, q] dmsg[o]
//   dx_src[i] = sum_q U[i, q] dt[q]
//   duv[i r + q]         = x_src[i] dt[q]             (the U columns)
//   duv[r c_in + o r + q] = dmsg[o] t[q]              (the V columns)
//   dh[k]     = sum_j duv[j] w3[k, j]
//   dw3[k, j] = sum_e h[e, k] duv[e, j],  db3[j] = sum_e duv[e, j]
//
// Numbers.  h, x_src, w3 and dmsg are bfloat16 values (the plain version,
// ops/fused_conv.py:fused_edge_conv_lowrank_bwd_plain, rounds the same
// four); b3, uv, t, dt, duv and every sum are float32.  No operand of a
// wgmma is a rounding of a float32 product or sum:
//
//  (a) rows kernel, factored.  uv is recomputed as h @ w3 chunks (as the
//      forward); dh = duv w3^T is not formed from duv but as
//        dh[k] = sum_q dt[q] P[k, q] + sum_q t[q] Q[k, q],
//        P = x_src @ W3U,  Q = dmsg @ W3V,
//      W3U[i, (k, q)] = w3[k, i r + q], W3V[o, (k, q)] = w3[k, r c_in + o r
//      + q]: two more products of bf16 values the plain version rounds,
//      weighted by t and dt in float32 on the CUDA cores.
//  (b) weights kernel, exact split.  duv is float32 (a bf16 value times a
//      float32 one), so it is split into three bf16 parts d1 = bf16(duv),
//      d2 = bf16(duv - d1), d3 = bf16(duv - d1 - d2) with d1 + d2 + d3 = duv
//      EXACTLY: each remainder is exact in float32 and 8 + 8 + 8 significant
//      bits cover float32's 24 (tests/test_torch_lowrank_wgmma_host.py;
//      bf16 has float32's exponent range, so this holds for 2^-110 <= |duv|
//      <= 3.38e38).  dw3 = h^T d1 + h^T d2 + h^T d3 runs as three wgmma
//      passes whose products are exact in the float32 accumulator; db3 is
//      summed from duv itself in float32 by the thread that forms its
//      column.
//
// Design.  Both kernels run at the padded rank rp (lowrank_wgmma.cuh: 8
// ceil(r / 8) up to 64, 64 ceil(r / 64) past it): at a rank other than rp
// a first launch lays out the zero-padded copy of w3, b3's columns are
// copied padded from its real ones, t and dt are scratch [slots, rp] (zero
// at q >= r), and the weights kernel writes only the model's columns of
// dw3 and db3.  Past rank 64 both run slabs of 64 (kSlab): (a) walks the
// slabs in turn per tile, each the rank-64 chunk walk on its slab's
// columns (t and dt in registers for one slab at a time, written out at
// the slab's end), dx_src and dh added slab after slab by the thread that
// writes them; in (b) each 64-column half of a block's 128 columns is one
// slab of one channel, so a block stages only those two slabs' t or dt
// ([64][64] each) and its shared memory stays the rank-64 one.
//  (a) one warpgroup per 64-slot tile (grid: every tile of the graph, 4864
//      at the serving chunk); the tile's receiver block is tile / (blk /
//      64).  It forms dmsg = row_weight g[slot_rows[e]] (CompactS; the dense
//      form sums S^T g), rounds it to bf16 and writes it once as scratch for
//      (b); stages h, x_src and dmsg as A operands, then runs m64n128
//      products in 128-column chunks of whole channels (lowrank_wgmma.cuh),
//      each chunk's w3 columns (and a uv chunk's b3) copied in 16-byte
//      pieces by cp.async into a ring of three buffers, two chunks ahead of
//      the running product (ChunkCopy): the V chunks of uv give dt (in
//      registers: every thread holds the same q of every channel), the U
//      chunks t and dx_src (a quad shuffle), then for each group of k the
//      P chunk and the Q chunk give dh (one quad shuffle per k; the P
//      chunk's per-thread partials wait in shared memory).  It writes
//      t and dt as float32 scratch for (b).  Tiles of padding only write
//      zeros in CompactS form.
//  (b) grid (128-column tiles of rp (c_in + c_out), slot splits, 64-row
//      tiles of K).  Per 64-slot chunk a block copies its 64 columns of the
//      h rows in 16-byte pieces as A (h^T, MN-major) and the chunk's x_src
//      and dt (U
//      columns) or dmsg and t (V columns), with cp.async into one of two
//      sets while the chunk before runs; each thread forms its column's duv
//      for 16 slots at a time
//      and its three parts (B, K-major), and the three products of those 16
//      slots are issued before the next 16 are formed, so that forming
//      overlaps the tensor cores.  The sums move into the split's partial
//      [K+1, r (c_in + c_out)] (row K: db3, from the blocks of the first row
//      tile only) every 32 chunks; the wrapper
//      sums the partials in a fixed order.  No atomics anywhere: two
//      launches on the same inputs give the same bits.
//
// Bound.  Per real slot about 2 (K+1) r (c_in + c_out) operations for the
// uv recompute, 2 K r (c_in + c_out) for dh and 2 (K+1) r (c_in + c_out) for
// dw3 and db3 (the rest is O(r (c_in + c_out))), against (K + c_in) (2 + 4)
// + c_out 4 bytes of inputs and outputs: bounded by operations on the
// tensor cores.  The padded instance does rp / r of that work, so it
// reaches at most r / rp of the bound.  What stands in the way here: w3 is
// read from L2 twice per tile in (a), the float32 epilogues run on the CUDA
// cores, and (b) runs its products three times over and forms duv on the
// CUDA cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_lowrank_bwd_wgmma.so
//        fused_edge_conv_lowrank_bwd_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lowrank_wgmma.cuh"

namespace {

using namespace lowrank_wgmma;

constexpr int kRows = 64;     // receiver rows per block (rows_blk)
constexpr int kPromote = 32;  // weights kernel: chunks per tensor-core sum
constexpr int kSlice = 16;    // weights kernel: slots formed per product

// A bf16 pair as one 32-bit word, .x first (the lower address).
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  union {
    __nv_bfloat162 b;
    uint32_t u;
  } cv;
  cv.b = v;
  return cv.u;
}

// Byte offsets of the rows kernel's shared memory: the A operands h,
// x_src and dmsg, the ring of kBufs buffers (a w3 chunk [128][dmax] bf16,
// then a uv chunk's b3 [128] f32), the P half of dh, slot_rows.  The P half
// waits for its Q chunk in shared memory, as each thread's 2 G unreduced
// partials in a column of its own ([2 G][128]: no bank conflicts, no
// barrier).  65 KB at width 48, K 48, rank 16 (three blocks per SM), 151 KB
// at 128, rank 64.  Past a depth (K, c_in or c_out) of 128 each buffer
// holds a stage of 64 deep and a chunk runs as ceil(depth / 64) stages
// into one accumulator (lowrank_wgmma.cuh staged, product_stage):
// 151 KB at K = c_in = c_out = 256, rank 64 (166 KB at rank 8), 131 KB at
// K 48 with widths 256, rank 16, 104 KB at K 256 with widths 48.
struct RowsLayout {
  int kp, dpi, dpo, dmax, bd;
  long ax, ad, ring, buf, dhp, srow, total;
  // deep: the chunks in stages (rows_deep)
  __host__ __device__ RowsLayout(int K, int c_in, int c_out, int r,
                                 bool deep) {
    kp = round_up(K, 16);
    dpi = round_up(c_in, 16);
    dpo = round_up(c_out, 16);
    dmax = kp > dpi ? kp : dpi;
    dmax = dmax > dpo ? dmax : dpo;
    bd = deep ? kStage : dmax;  // a buffer's depth
    ax = 2L * kTile * kp;                    // a: h [64][kp]
    ad = ax + 2L * kTile * dpi;              // x_src [64][dpi]
    ring = ad + 2L * kTile * dpo;            // dmsg [64][dpo]
    buf = 2L * kCols * bd + 4L * kCols;
    dhp = ring + kBufs * buf;
    srow = dhp + 4L * 2 * (kCols / r) * kWarpgroup;  // P half [2 G][128] f32
    total = srow + 4L * kTile;
  }
};

// Whether the rows kernel walks each chunk in stages of 64 (a K, c_in or
// c_out past 128).
__host__ __device__ constexpr bool rows_deep(int K, int c_in, int c_out) {
  return staged(round_up(K, 16)) || staged(round_up(c_in, 16)) ||
         staged(round_up(c_out, 16));
}

// ---------------------------------------------------------------------------
// (a) dmsg, t, dt, dx_src and dh for one 64-slot tile.  kDeep: a depth
// past 128, each chunk in stages of 64 (a separate instance, so that the
// one up to 128 stays the whole-chunk walk).
template <int R8, bool kDeep>
__global__ void __launch_bounds__(kWarpgroup)
lowrank_bwd_rows_wgmma(const float* __restrict__ g, const bf16* __restrict__ h,
                       const bf16* __restrict__ x_src,
                       const bf16* __restrict__ w3,
                       const float* __restrict__ b3,
                       const int* __restrict__ slot_rows,
                       const float* __restrict__ row_weight,
                       const float* __restrict__ s_dense,
                       float* __restrict__ dh, float* __restrict__ dx_src,
                       bf16* __restrict__ dmsg_out, float* __restrict__ t_out,
                       float* __restrict__ dt_out, int blk, int K, int c_in,
                       int c_out, int rank) {
  constexpr int R = 8 * R8, G = kCols / R;  // padded rank, channels per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(K, c_in, c_out, R, kDeep);
  const int kp = L.kp, dpi = L.dpi, dpo = L.dpo, bd = L.bd;
  bf16* ah_sm = reinterpret_cast<bf16*>(smem);
  bf16* ax_sm = reinterpret_cast<bf16*>(smem + L.ax);
  bf16* ad_sm = reinterpret_cast<bf16*>(smem + L.ad);
  unsigned char* ring = smem + L.ring;
  float* dhp_sm = reinterpret_cast<float*>(smem + L.dhp) + threadIdx.x;
  int* srow = reinterpret_cast<int*>(smem + L.srow);

  const int tid = threadIdx.x;
  const bool writer = tid % 4 == 0;
  const long slot0 = static_cast<long>(blockIdx.x) * kTile;
  const long b = slot0 / blk;
  const long row_base = b * kRows;
  const bool compact = s_dense == nullptr;
  const bf16 zero = __float2bfloat16(0.f);
  const int ru = R * c_in;

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
      for (int e = tid; e < kTile * R; e += kWarpgroup) {
        t_out[slot0 * R + e] = 0.f;
        dt_out[slot0 * R + e] = 0.f;
      }
      return;
    }
  }

  // chunks: the V chunks of uv (output channels G c ..), the U chunks, then
  // for each group of G k the P chunk and the Q chunk
  const int n_v = (c_out + G - 1) / G, n_u = (c_in + G - 1) / G;
  const int n_c = n_v + n_u + 2 * ((K + G - 1) / G);
  auto chunk = [&](int c) {
    if (c < n_v + n_u) {
      const bool v = c < n_v;
      const int ch0 = (v ? c : c - n_v) * G;
      const int gc = min(G, (v ? c_out : c_in) - ch0);
      return Chunk{kUv, (v ? ru : 0) + ch0 * R, gc * R, kp, K};
    }
    const int e = c - n_v - n_u, k0 = (e / 2) * G, gk = min(G, K - k0);
    return e % 2 == 0 ? Chunk{kP, k0 * R, gk * R, dpi, c_in}
                      : Chunk{kQ, k0 * R, gk * R, dpo, c_out};
  };
  // kDeep: each chunk runs as ceil(depth / bd) stages, one step of the
  // ring each, else as one step: step n is read from buffer n % 3 while
  // steps n + 1 and n + 2 land in the other two.  (ic, is) is the next
  // piece to copy: stage is of chunk ic.
  auto buf = [&](int n) {
    return reinterpret_cast<bf16*>(ring + (n % kBufs) * L.buf);
  };
  auto bias = [&](int n) {
    return reinterpret_cast<float*>(ring + (n % kBufs) * L.buf +
                                    2L * kCols * bd);
  };
  const ChunkCopy<R8> cc(w3, b3, c_in, c_out, rank);
  int ic = 0, is = 0;
  auto start_next = [&](int n) {
    if (ic < n_c) {
      const Chunk ch = chunk(ic);
      cc.start(buf(n), bias(n), stage_of(ch, is, bd));
      if (++is * bd >= ch.depth) {
        is = 0;
        ++ic;
      }
    } else {
      pieces_commit();  // an empty group, so that each step waits for its own
    }
  };
  if constexpr (kDeep) {
    start_next(0);
    start_next(1);
  } else {
    cc.start(buf(0), bias(0), chunk(0));
    cc.start(buf(1), bias(1), chunk(1));
  }

  // ---- stage dmsg (rounded to bf16; channels tid % 64 + 64 m' of slots
  // tid / 64 + 2 m), h and x_src; the first step's barrier publishes
  // them ----
#pragma unroll 4
  for (int s = tid >> 6; s < kTile; s += 2)
    for (int o = tid & 63; o < dpo; o += 64) {
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
      ad_sm[kmajor(s, o, dpo)] = v;
    }
  stage_rows(ah_sm, h + slot0 * K, K, kp);
  stage_rows(ax_sm, x_src + slot0 * c_in, c_in, dpi);

  // this thread's rows r0, r0 + 8 at its 2 R8 values of q
  const int r0 = acc_row(0);
  float tq[2][R8][2], dq[2][R8][2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int m = 0; m < R8; ++m)
      tq[hf][m][0] = tq[hf][m][1] = dq[hf][m][0] = dq[hf][m][1] = 0.f;

  int step = 0;
  for (int c = 0; c < n_c; ++c) {
    if constexpr (!kDeep) {
      pieces_wait<1>();  // chunk c has landed
      fence_async_smem();
      __syncthreads();
    }
    const Chunk ch = chunk(c);
    const bf16* a = ch.kind == kP ? ax_sm : ch.kind == kQ ? ad_sm : ah_sm;
    float acc[kCols / 2];
    if constexpr (kDeep) {
      for (int d0 = 0; d0 < ch.depth; d0 += bd, ++step) {
        pieces_wait<1>();  // this step's piece has landed
        fence_async_smem();
        __syncthreads();
        product_stage(acc, a, ch.depth, d0, buf(step),
                      min(bd, ch.depth - d0), d0 > 0);
        // the piece two steps on into the buffer that step - 1's finished
        // product read
        start_next(step + 2);
        wait_all();
        fence_operand(acc);
      }
    } else {
      product<kCols, 1>(acc, a, buf(c), ch.depth);
      // chunk c + 2 into the buffer that chunk c - 1's finished product
      // read (an empty group past the last, so that each step waits for
      // its own)
      if (c + 2 < n_c)
        cc.start(buf(c + 2), bias(c + 2), chunk(c + 2));
      else
        pieces_commit();
      wait_all();
      fence_operand(acc);
      step = c + 1;
    }
    const float* bs = bias(step - 1);
    if (c < n_v) {  // dt[s, q] += dmsg[s, o] V[s, o, q]
      const int o0 = c * G, gc = min(G, c_out - o0);
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if (gg >= gc) continue;
        const float da = __bfloat162float(ad_sm[kmajor(r0, o0 + gg, dpo)]);
        const float db = __bfloat162float(ad_sm[kmajor(r0 + 8, o0 + gg, dpo)]);
#pragma unroll
        for (int u = 0; u < 4 * R8; ++u) {
          const int j = 4 * R8 * gg + u;
          const float uv = acc[j] + bs[gg * R + q_of<R8>(j)];
          dq[(u >> 1) & 1][u >> 2][u & 1] += ((u >> 1) & 1 ? db : da) * uv;
        }
      }
    } else if (c < n_v + n_u) {  // t += x U; dx_src[s, i] = sum_q U dt
      const int i0 = (c - n_v) * G, gc = min(G, c_in - i0);
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if (gg >= gc) continue;
        const float xa = __bfloat162float(ax_sm[kmajor(r0, i0 + gg, dpi)]);
        const float xb = __bfloat162float(ax_sm[kmajor(r0 + 8, i0 + gg, dpi)]);
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int u = 0; u < 4 * R8; ++u) {
          const int j = 4 * R8 * gg + u;
          const float uv = acc[j] + bs[gg * R + q_of<R8>(j)];
          if ((u >> 1) & 1) {
            tq[1][u >> 2][u & 1] += xb * uv;
            pb += uv * dq[1][u >> 2][u & 1];
          } else {
            tq[0][u >> 2][u & 1] += xa * uv;
            pa += uv * dq[0][u >> 2][u & 1];
          }
        }
        pa = quad_sum(pa);
        pb = quad_sum(pb);
        if (writer) {
          dx_src[(slot0 + r0) * c_in + i0 + gg] = pa;
          dx_src[(slot0 + r0 + 8) * c_in + i0 + gg] = pb;
        }
      }
    } else {  // dh[s, k] = sum_q dt[s, q] P[s, k, q] + sum_q t[s, q] Q[s, k, q]
      const bool p_half = ch.kind == kP;
      const int k0 = ch.lo / R, gk = ch.cw / R;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if (gg >= gk) continue;
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int u = 0; u < 4 * R8; ++u) {
          const int j = 4 * R8 * gg + u;
          const int hf = (u >> 1) & 1;
          const float w = p_half ? dq[hf][u >> 2][u & 1] : tq[hf][u >> 2][u & 1];
          if (hf) pb += acc[j] * w; else pa += acc[j] * w;
        }
        if (p_half) {
          dhp_sm[2 * gg * kWarpgroup] = pa;
          dhp_sm[(2 * gg + 1) * kWarpgroup] = pb;
          continue;
        }
        pa = quad_sum(dhp_sm[2 * gg * kWarpgroup] + pa);
        pb = quad_sum(dhp_sm[(2 * gg + 1) * kWarpgroup] + pb);
        if (writer) {
          dh[(slot0 + r0) * K + k0 + gg] = pa;
          dh[(slot0 + r0 + 8) * K + k0 + gg] = pb;
        }
      }
    }
  }

  // ---- t and dt, scratch for the weights kernel ----
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int m = 0; m < R8; ++m)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long at = (slot0 + r0 + 8 * hf) * R + q_of<R8>(4 * m + u);
        t_out[at] = tq[hf][m][u];
        dt_out[at] = dq[hf][m][u];
      }
}

// (a) past rank 64: lowrank_bwd_rows_wgmma's tile at R8 = 8 walked slab by
// slab (the head padded to rp = 64 ceil(r / 64), slab s its columns i rp +
// 64 s ..; ChunkCopy's kSlab reading): per slab t and dt from zero in
// registers, written to t_out / dt_out at the slab's columns at its end,
// and this slab's terms of dx_src and dh added to the earlier slabs' by the
// thread that writes them.  A kernel of its own, so that the instances up
// to rank 64 keep their code (their registers sit at the 255 limit).
template <bool kDeep>
__global__ void __launch_bounds__(kWarpgroup)
lowrank_bwd_rows_slab_wgmma(const float* __restrict__ g,
                            const bf16* __restrict__ h,
                            const bf16* __restrict__ x_src,
                            const bf16* __restrict__ w3,
                            const float* __restrict__ b3,
                            const int* __restrict__ slot_rows,
                            const float* __restrict__ row_weight,
                            const float* __restrict__ s_dense,
                            float* __restrict__ dh, float* __restrict__ dx_src,
                            bf16* __restrict__ dmsg_out,
                            float* __restrict__ t_out,
                            float* __restrict__ dt_out, int blk, int K,
                            int c_in, int c_out, int rank) {
  constexpr int R8 = 8, R = 8 * R8, G = kCols / R;  // a slab's rank, channels
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(K, c_in, c_out, R, kDeep);
  const int kp = L.kp, dpi = L.dpi, dpo = L.dpo, bd = L.bd;
  bf16* ah_sm = reinterpret_cast<bf16*>(smem);
  bf16* ax_sm = reinterpret_cast<bf16*>(smem + L.ax);
  bf16* ad_sm = reinterpret_cast<bf16*>(smem + L.ad);
  unsigned char* ring = smem + L.ring;
  float* dhp_sm = reinterpret_cast<float*>(smem + L.dhp) + threadIdx.x;
  int* srow = reinterpret_cast<int*>(smem + L.srow);

  const int tid = threadIdx.x;
  const bool writer = tid % 4 == 0;
  const long slot0 = static_cast<long>(blockIdx.x) * kTile;
  const long b = slot0 / blk;
  const long row_base = b * kRows;
  const bool compact = s_dense == nullptr;
  const bf16 zero = __float2bfloat16(0.f);
  const int ru = R * c_in;
  const int rp = padded_rank(rank), slabs = rp / R;  // t's and dt's columns

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
      for (int e = tid; e < kTile * rp; e += kWarpgroup) {
        t_out[slot0 * rp + e] = 0.f;
        dt_out[slot0 * rp + e] = 0.f;
      }
      return;
    }
  }

  // chunks: the V chunks of uv (output channels G c ..), the U chunks, then
  // for each group of G k the P chunk and the Q chunk; chunk c of the
  // tile's walk is chunk c % n_c of slab c / n_c
  const int n_v = (c_out + G - 1) / G, n_u = (c_in + G - 1) / G;
  const int n_c = n_v + n_u + 2 * ((K + G - 1) / G);
  const int n_t = n_c * slabs;
  auto chunk = [&](int c) {
    const int sl = c / n_c;
    c -= sl * n_c;
    Chunk ch;
    if (c < n_v + n_u) {
      const bool v = c < n_v;
      const int ch0 = (v ? c : c - n_v) * G;
      const int gc = min(G, (v ? c_out : c_in) - ch0);
      ch = Chunk{kUv, (v ? ru : 0) + ch0 * R, gc * R, kp, K};
    } else {
      const int e = c - n_v - n_u, k0 = (e / 2) * G, gk = min(G, K - k0);
      ch = e % 2 == 0 ? Chunk{kP, k0 * R, gk * R, dpi, c_in}
                      : Chunk{kQ, k0 * R, gk * R, dpo, c_out};
    }
    ch.s0 = sl * R;
    return ch;
  };
  // kDeep: each chunk runs as ceil(depth / bd) stages, one step of the
  // ring each, else as one step: step n is read from buffer n % 3 while
  // steps n + 1 and n + 2 land in the other two.  (ic, is) is the next
  // piece to copy: stage is of chunk ic.
  auto buf = [&](int n) {
    return reinterpret_cast<bf16*>(ring + (n % kBufs) * L.buf);
  };
  auto bias = [&](int n) {
    return reinterpret_cast<float*>(ring + (n % kBufs) * L.buf +
                                    2L * kCols * bd);
  };
  const ChunkCopy<R8, true> cc(w3, b3, c_in, c_out, rank);
  int ic = 0, is = 0;
  auto start_next = [&](int n) {
    if (ic < n_t) {
      const Chunk ch = chunk(ic);
      cc.start(buf(n), bias(n), stage_of(ch, is, bd));
      if (++is * bd >= ch.depth) {
        is = 0;
        ++ic;
      }
    } else {
      pieces_commit();  // an empty group, so that each step waits for its own
    }
  };
  if constexpr (kDeep) {
    start_next(0);
    start_next(1);
  } else {
    cc.start(buf(0), bias(0), chunk(0));
    cc.start(buf(1), bias(1), chunk(1));
  }

  // ---- stage dmsg (rounded to bf16; channels tid % 64 + 64 m' of slots
  // tid / 64 + 2 m), h and x_src; the first step's barrier publishes
  // them ----
#pragma unroll 4
  for (int s = tid >> 6; s < kTile; s += 2)
    for (int o = tid & 63; o < dpo; o += 64) {
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
      ad_sm[kmajor(s, o, dpo)] = v;
    }
  stage_rows(ah_sm, h + slot0 * K, K, kp);
  stage_rows(ax_sm, x_src + slot0 * c_in, c_in, dpi);

  // this thread's rows r0, r0 + 8 at its 2 R8 values of q (of one slab)
  const int r0 = acc_row(0);
  int step = 0;
  for (int sl = 0; sl < slabs; ++sl) {
    // dx_src's and dh's entries: this slab's terms added to the earlier
    // slabs' (by the thread that wrote them)
    auto add = [&](float* at, float v) {
      if (sl > 0) v += *at;
      *at = v;
    };
    float tq[2][R8][2], dq[2][R8][2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int m = 0; m < R8; ++m)
        tq[hf][m][0] = tq[hf][m][1] = dq[hf][m][0] = dq[hf][m][1] = 0.f;

    for (int c = 0; c < n_c; ++c) {
      const int cg = sl * n_c + c;  // the chunk's place in the tile's walk
      if constexpr (!kDeep) {
        pieces_wait<1>();  // chunk cg has landed
        fence_async_smem();
        __syncthreads();
      }
      const Chunk ch = chunk(cg);
      const bf16* a = ch.kind == kP ? ax_sm : ch.kind == kQ ? ad_sm : ah_sm;
      float acc[kCols / 2];
      if constexpr (kDeep) {
        for (int d0 = 0; d0 < ch.depth; d0 += bd, ++step) {
          pieces_wait<1>();  // this step's piece has landed
          fence_async_smem();
          __syncthreads();
          product_stage(acc, a, ch.depth, d0, buf(step),
                        min(bd, ch.depth - d0), d0 > 0);
          // the piece two steps on into the buffer that step - 1's finished
          // product read
          start_next(step + 2);
          wait_all();
          fence_operand(acc);
        }
      } else {
        product<kCols, 1>(acc, a, buf(cg), ch.depth);
        // chunk cg + 2 into the buffer that chunk cg - 1's finished product
        // read (an empty group past the last, so that each step waits for
        // its own)
        if (cg + 2 < n_t)
          cc.start(buf(cg + 2), bias(cg + 2), chunk(cg + 2));
        else
          pieces_commit();
        wait_all();
        fence_operand(acc);
        step = cg + 1;
      }
      const float* bs = bias(step - 1);
      if (c < n_v) {  // dt[s, q] += dmsg[s, o] V[s, o, q]
        const int o0 = c * G, gc = min(G, c_out - o0);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          if (gg >= gc) continue;
          const float da = __bfloat162float(ad_sm[kmajor(r0, o0 + gg, dpo)]);
          const float db = __bfloat162float(ad_sm[kmajor(r0 + 8, o0 + gg, dpo)]);
#pragma unroll
          for (int u = 0; u < 4 * R8; ++u) {
            const int j = 4 * R8 * gg + u;
            const float uv = acc[j] + bs[gg * R + q_of<R8>(j)];
            dq[(u >> 1) & 1][u >> 2][u & 1] += ((u >> 1) & 1 ? db : da) * uv;
          }
        }
      } else if (c < n_v + n_u) {  // t += x U; dx_src[s, i] = sum_q U dt
        const int i0 = (c - n_v) * G, gc = min(G, c_in - i0);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          if (gg >= gc) continue;
          const float xa = __bfloat162float(ax_sm[kmajor(r0, i0 + gg, dpi)]);
          const float xb = __bfloat162float(ax_sm[kmajor(r0 + 8, i0 + gg, dpi)]);
          float pa = 0.f, pb = 0.f;
#pragma unroll
          for (int u = 0; u < 4 * R8; ++u) {
            const int j = 4 * R8 * gg + u;
            const float uv = acc[j] + bs[gg * R + q_of<R8>(j)];
            if ((u >> 1) & 1) {
              tq[1][u >> 2][u & 1] += xb * uv;
              pb += uv * dq[1][u >> 2][u & 1];
            } else {
              tq[0][u >> 2][u & 1] += xa * uv;
              pa += uv * dq[0][u >> 2][u & 1];
            }
          }
          pa = quad_sum(pa);
          pb = quad_sum(pb);
          if (writer) {
            add(dx_src + (slot0 + r0) * c_in + i0 + gg, pa);
            add(dx_src + (slot0 + r0 + 8) * c_in + i0 + gg, pb);
          }
        }
      } else {  // dh[s, k] = sum_q dt[s, q] P[s, k, q] + sum_q t[s, q] Q[s, k, q]
        const bool p_half = ch.kind == kP;
        const int k0 = ch.lo / R, gk = ch.cw / R;
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          if (gg >= gk) continue;
          float pa = 0.f, pb = 0.f;
#pragma unroll
          for (int u = 0; u < 4 * R8; ++u) {
            const int j = 4 * R8 * gg + u;
            const int hf = (u >> 1) & 1;
            const float w = p_half ? dq[hf][u >> 2][u & 1] : tq[hf][u >> 2][u & 1];
            if (hf) pb += acc[j] * w; else pa += acc[j] * w;
          }
          if (p_half) {
            dhp_sm[2 * gg * kWarpgroup] = pa;
            dhp_sm[(2 * gg + 1) * kWarpgroup] = pb;
            continue;
          }
          pa = quad_sum(dhp_sm[2 * gg * kWarpgroup] + pa);
          pb = quad_sum(dhp_sm[(2 * gg + 1) * kWarpgroup] + pb);
          if (writer) {
            add(dh + (slot0 + r0) * K + k0 + gg, pa);
            add(dh + (slot0 + r0 + 8) * K + k0 + gg, pb);
          }
        }
      }
    }

    // ---- the slab's t and dt, scratch for the weights kernel ----
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int m = 0; m < R8; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const long at =
              (slot0 + r0 + 8 * hf) * rp + sl * R + q_of<R8>(4 * m + u);
          t_out[at] = tq[hf][m][u];
          dt_out[at] = dq[hf][m][u];
        }
  }
}

// Adds the weights kernel's tensor-core sums into its partial (stores them
// the first time) and restarts them from zero: row k0 + i of its row tile,
// padded column c of ncolp at the model's column of ncol (none at q >= r).
__device__ __forceinline__ void promote(float (&acc)[kCols / 2], float* dst,
                                        bool& first, int k0, int n0, int K,
                                        int ncolp, int rp, int r, int ncol) {
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) {
    const int k = k0 + acc_row(j), c = n0 + acc_col(j);
    const int rc = c < ncolp ? real_col(c, rp, r) : -1;
    if (k < K && rc >= 0) {
      float* p = dst + static_cast<long>(k) * ncol + rc;
      *p = first ? acc[j] : *p + acc[j];
    }
    acc[j] = 0.f;
  }
  first = false;
}

// Byte offsets of the weights kernel's shared memory: duv's three parts,
// then two sets of staged operands (chunk n of a split in set n % 2), or
// one where two do not fit (past a width of 128: at c_in = c_out = 256 two
// sets take 229 KB at rank 32 and 262 KB at 64, one 156 KB); within a
// set, the offsets of its arrays.  With one set each chunk is copied after
// the last one's products completed.
struct WeightsLayout {
  long sets, x, m, t, dt, set, total;
  int nsets;
  // one_set: one set of staged operands (weights_one_set)
  __host__ __device__ WeightsLayout(int c_in, int c_out, int r,
                                    bool one_set) {
    sets = 2L * 3 * kCols * kTile;           // d1, d2, d3 [3][128][64 e]
    x = 2L * kTile * kTile;                  // a: h^T [64 k][64 e]
    m = x + 2L * kTile * c_in;               // x_src [64][c_in] bf16
    t = m + 2L * kTile * c_out;              // dmsg [64][c_out] bf16
    dt = t + 4L * kTile * r;                 // t [64][r] f32
    set = dt + 4L * kTile * r;               // dt [64][r] f32
    nsets = one_set ? 1 : 2;
    total = sets + nsets * set;
  }
};

// Whether two sets of the weights kernel's staged operands do not fit.
__host__ __device__ inline bool weights_one_set(int c_in, int c_out, int r) {
  return WeightsLayout(c_in, c_out, r, false).total > kSmemMax;
}

// Asynchronous 16-byte copy from device to shared memory (cp.async), its
// group commit and the wait for all but the newest group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies n bytes from src to dst: 16-byte cp.async pieces (async: both
// ends 16-byte aligned, n a multiple of 16), else 2-byte loads and stores.
__device__ __forceinline__ void copy_bytes(void* dst, const void* src, int n,
                                           bool async) {
  if (async) {
    for (int e = threadIdx.x; e < n / 16; e += kWarpgroup)
      cp_async16(static_cast<uint4*>(dst) + e, static_cast<const uint4*>(src) + e);
  } else {
    for (int e = threadIdx.x; e < n / 2; e += kWarpgroup)
      reinterpret_cast<uint16_t*>(dst)[e] = reinterpret_cast<const uint16_t*>(src)[e];
  }
}

// Copies `rows` rows of n bytes, row r from src + r * stride bytes, to dst
// contiguous: 16-byte cp.async pieces (async: both ends and the stride
// 16-byte aligned, n a multiple of 16), else 4-byte loads and stores.
__device__ __forceinline__ void copy_rows(void* dst, const void* src,
                                          int rows, int n, int stride,
                                          bool async) {
  const int per = async ? n / 16 : n / 4;
  for (int e = threadIdx.x; e < rows * per; e += kWarpgroup) {
    const int r = e / per, p = e - r * per;
    const unsigned char* from =
        static_cast<const unsigned char*>(src) + static_cast<long>(r) * stride;
    if (async)
      cp_async16(static_cast<uint4*>(dst) + e,
                 reinterpret_cast<const uint4*>(from) + p);
    else
      static_cast<float*>(dst)[e] = reinterpret_cast<const float*>(from)[p];
  }
}

// ---------------------------------------------------------------------------
// (b) partial[split, k, c] = sum over the split's slots e of h[e, k] duv[e, c]
// for the block's 128 padded columns c of rp (c_in + c_out) and 64 rows k,
// and (first row tile) row K: db3, at the model's columns.  kOneSet: one
// set of staged operands (WeightsLayout), a separate instance; kSlab: a
// rank past 64 (R8 = 8), each 64-column half of the block's columns one
// slab of one channel, whose t or dt ([64][64]) takes the place of t (the
// first half) or of dt (the second) in a set.
template <int R8, bool kOneSet, bool kSlab>
__global__ void __launch_bounds__(kWarpgroup)
lowrank_bwd_weights_wgmma(const bf16* __restrict__ h,
                          const bf16* __restrict__ x_src,
                          const bf16* __restrict__ dmsg,
                          const float* __restrict__ t_vec,
                          const float* __restrict__ dt_vec,
                          const int* __restrict__ slot_rows,
                          float* __restrict__ partial, long num_chunks,
                          long chunks_per_split, int K, int c_in, int c_out,
                          int rank) {
  constexpr int R = 8 * R8;
  extern __shared__ __align__(128) unsigned char smem[];
  const WeightsLayout L(c_in, c_out, R, kOneSet);
  bf16* d_sm = reinterpret_cast<bf16*>(smem);
  unsigned char* sets = smem + L.sets;
  const int tid = threadIdx.x;
  const int rp = kSlab ? padded_rank(rank) : R;  // t's and dt's columns
  const int ru = rp * c_in, ncol = rp * (c_in + c_out);
  const int n0 = blockIdx.x * kCols, k0 = blockIdx.z * kTile;
  const long split = blockIdx.y;
  const long c_lo = split * chunks_per_split;
  const long c_hi = c_lo + chunks_per_split < num_chunks
                        ? c_lo + chunks_per_split
                        : num_chunks;
  const bf16 zero = __float2bfloat16(0.f);
  // this thread's column of duv: col = n0 + tid (none past ncol): U column
  // (channel i, q) = x_src[:, i] dt[:, q], or V column (o, q) = dmsg[:, o]
  // t[:, q]; the block stages only the factors its columns use
  const int col = n0 + tid;
  const bool has_col = col < ncol;
  const bool u_col = col < ru;
  const bool need_u = n0 < ru, need_v = n0 + kCols > ru;
  const int ch = has_col ? (u_col ? col : col - ru) / rp : 0;
  const int q = has_col ? col % rp : 0;
  const long f_off = (u_col ? L.x : L.m) + 2L * ch;  // the channel factor
  const int f_stride = u_col ? c_in : c_out;
  // the rank factor (row stride R): kSlab, the half's slab
  const long v_off = kSlab ? (tid < kTile ? L.t : L.dt) + 4L * (q % R)
                           : (u_col ? L.dt : L.t) + 4L * q;

  // columns past ncol, and h^T's rows past K - k0, stay zero
  for (int e = tid; e < 3 * kCols * kTile; e += kWarpgroup) d_sm[e] = zero;
  for (int e = tid; e < (kOneSet ? 1 : 2) * kTile * kTile; e += kWarpgroup)
    reinterpret_cast<bf16*>(sets + (e >= kTile * kTile ? L.set : 0))
        [e % (kTile * kTile)] = zero;
  float acc[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) acc[j] = 0.f;
  float dbias = 0.f;
  // The tensor cores' float32 sum is moved into the split's partial in
  // device memory every kPromote chunks and restarted from zero (as B2's
  // weights kernel); each thread adds to its own entries, in chunk order.
  const int ncol_r = rank * (c_in + c_out);  // the model's columns
  float* dst = partial + split * (K + 1) * static_cast<long>(ncol_r);
  int pending = 0;
  bool first = true;

  // With every operand 16-byte aligned and K a multiple of 8 the operands
  // are copied by cp.async (else with plain loads), with two sets the next
  // chunk's into the other set while this chunk's run (pipelined);
  // otherwise each chunk is staged after the last one.
  const bool async =
      K % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(x_src) |
       reinterpret_cast<uintptr_t>(dmsg) | reinterpret_cast<uintptr_t>(t_vec) |
       reinterpret_cast<uintptr_t>(dt_vec)) % 16 == 0;
  const bool pipelined = async && !kOneSet;
  auto stage = [&](unsigned char* set, long s0) {
    // A = h^T over the row tile's k0 .. k0 + 63, MN-major: 8 consecutive
    // k of one slot are a 16-byte piece of an h row (zeros past K, written
    // above); 8 consecutive threads take 8 slots' pieces of one k, 128
    // contiguous bytes of A
    bf16* a = reinterpret_cast<bf16*>(set);
    if (async) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = tid + kWarpgroup * m;
        const int s = p % 8 + 8 * (p / 64), k = 8 * ((p / 8) % 8);
        if (k0 + k < K)
          cp_async16(a + mnmajor(k, s, kTile), h + (s0 + s) * K + k0 + k);
      }
    } else {
      for (int e = tid; e < kTile * kTile; e += kWarpgroup) {
        const int s = e >> 6, k = e & 63;
        if (k0 + k < K) a[mnmajor(k, s, kTile)] = h[(s0 + s) * K + k0 + k];
      }
    }
    if (need_u) {
      copy_bytes(set + L.x, x_src + s0 * c_in, 2 * kTile * c_in, async);
      if (!kSlab) copy_bytes(set + L.dt, dt_vec + s0 * R, 4 * kTile * R, async);
    }
    if (need_v) {
      copy_bytes(set + L.m, dmsg + s0 * c_out, 2 * kTile * c_out, async);
      if (!kSlab) copy_bytes(set + L.t, t_vec + s0 * R, 4 * kTile * R, async);
    }
    if constexpr (kSlab) {  // each half's slab of dt (U) or t (V)
      for (int hh = 0; hh < 2; ++hh) {
        const int c0 = n0 + kTile * hh;
        if (c0 >= ncol) continue;
        const float* src = (c0 < ru ? dt_vec : t_vec) + s0 * rp + c0 % rp;
        copy_rows(set + (hh ? L.dt : L.t), src, kTile, 4 * kTile, 4 * rp,
                  async);
      }
    }
  };

  // CompactS: chunks of padding only are skipped; each chunk loads the
  // next one's flags, so that the test waits on no load
  const bool compact = slot_rows != nullptr;
  int real_next = 0;
  if (compact && tid < kTile && c_lo < c_hi)
    real_next = slot_rows[c_lo * kTile + tid] >= 0;
  uint64_t da[2], dd[3];
#pragma unroll
  for (int st = 0; st < 2; ++st) da[st] = desc_mn(sets + st * L.set, kTile);
#pragma unroll
  for (int p = 0; p < 3; ++p) dd[p] = desc(d_sm + p * kCols * kTile, kTile);
  __syncthreads();  // the zeros land before the first copies
  if (pipelined && c_lo < c_hi) stage(sets, c_lo * kTile);
  cp_async_commit();

  for (long chk = c_lo; chk < c_hi; ++chk) {
    const long s0 = chk * kTile;
    const int cur = static_cast<int>(chk - c_lo) & (kOneSet ? 0 : 1);
    unsigned char* set = sets + cur * L.set;
    if (pipelined) {  // the next chunk into the other set (last read by the
                  // chunk before this one, whose products have completed)
      if (chk + 1 < c_hi) stage(sets + (cur ^ 1) * L.set, s0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's copies have landed
      fence_async_smem();
    }
    const int real = real_next;
    if (compact && tid < kTile && chk + 1 < c_hi)
      real_next = slot_rows[s0 + kTile + tid] >= 0;
    if (compact) {
      if (!__syncthreads_or(real)) continue;
    } else {
      __syncthreads();
    }
    if (!pipelined) {  // after the barrier: the last chunk's products are
                       // done with the set
      stage(set, s0);
      if (kOneSet && async) {
        cp_async_commit();
        cp_async_wait<0>();
        fence_async_smem();
      }
      __syncthreads();
    }
    const bf16* f_sm = reinterpret_cast<const bf16*>(set + f_off);
    const float* v_sm = reinterpret_cast<const float*>(set + v_off);

    // ---- per 16 slots: form duv's three parts, then issue their products
    // (which run while the next 16 are formed) ----
#pragma unroll
    for (int sl = 0; sl < kTile / kSlice; ++sl) {
      if (has_col) {
#pragma unroll
        for (int s = kSlice * sl; s < kSlice * (sl + 1); s += 8) {
          uint32_t p1[4], p2[4], p3[4];
#pragma unroll
          for (int pr = 0; pr < 4; ++pr) {
            float z[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int e = s + 2 * pr + u;
              z[u] = __bfloat162float(f_sm[e * f_stride]) * v_sm[e * R];
              dbias += z[u];
            }
            const __nv_bfloat162 z1 = __floats2bfloat162_rn(z[0], z[1]);
            const float2 f1 = __bfloat1622float2(z1);
            const float ra = z[0] - f1.x, rb = z[1] - f1.y;
            const __nv_bfloat162 z2 = __floats2bfloat162_rn(ra, rb);
            const float2 f2 = __bfloat1622float2(z2);
            p1[pr] = as_u32(z1);
            p2[pr] = as_u32(z2);
            p3[pr] = as_u32(__floats2bfloat162_rn(ra - f2.x, rb - f2.y));
          }
          const int at = kmajor(tid, s, kTile);
          *reinterpret_cast<uint4*>(d_sm + at) = make_uint4(p1[0], p1[1], p1[2], p1[3]);
          *reinterpret_cast<uint4*>(d_sm + kCols * kTile + at) =
              make_uint4(p2[0], p2[1], p2[2], p2[3]);
          *reinterpret_cast<uint4*>(d_sm + 2 * kCols * kTile + at) =
              make_uint4(p3[0], p3[1], p3[2], p3[3]);
        }
      }
      fence_async_smem();
      __syncthreads();
      fence_operand(acc);
      fence();
#pragma unroll
      for (int p = 0; p < 3; ++p)
        Mma<kCols, 1>::run(acc, da[cur] + 16 * sl, dd[p] + 16 * sl, 1);
      commit();
      fence_operand(acc);
    }
    wait_all();
    fence_operand(acc);
    if (++pending == kPromote) {
      promote(acc, dst, first, k0, n0, K, ncol, rp, rank, ncol_r);
      pending = 0;
    }
  }
  cp_async_wait<0>();
  if (pending > 0 || first)
    promote(acc, dst, first, k0, n0, K, ncol, rp, rank, ncol_r);
  const int rc = has_col && k0 == 0 ? real_col(col, rp, rank) : -1;
  if (rc >= 0) dst[static_cast<long>(K) * ncol_r + rc] = dbias;
}

template <int R8, bool kSlab>
cudaError_t launch(const void* g, const void* h, const void* x_src,
                   const void* w3, const void* b3, const void* slot_rows,
                   const void* row_weight, const void* s_dense, void* pad,
                   void* dh, void* dx_src, void* dmsg, void* t_vec,
                   void* dt_vec, void* partial, int num_blocks, int blk, int K,
                   int c_in, int c_out, int r, int num_splits,
                   cudaStream_t stream) {
  constexpr int R = 8 * R8;
  const long num_tiles = static_cast<long>(num_blocks) * blk / kTile;
  const bool deep = rows_deep(K, c_in, c_out);
  const size_t smem = static_cast<size_t>(RowsLayout(K, c_in, c_out, R,
                                                     deep).total);
  auto rows = kSlab ? (deep ? lowrank_bwd_rows_slab_wgmma<true>
                             : lowrank_bwd_rows_slab_wgmma<false>)
                    : (deep ? lowrank_bwd_rows_wgmma<R8, true>
                            : lowrank_bwd_rows_wgmma<R8, false>);
  cudaError_t err = allow_smem(rows, smem);
  if (err != cudaSuccess) return err;
  const bf16* w = static_cast<const bf16*>(w3);
  const int rp = padded_rank(r);
  if (r != rp) {  // the zero-padded copy of w3 at rank rp
    err = launch_pad_head(w, static_cast<bf16*>(pad), K, c_in + c_out, r,
                          stream);
    if (err != cudaSuccess) return err;
    w = static_cast<const bf16*>(pad);
  }
  rows<<<static_cast<unsigned>(num_tiles), kWarpgroup, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const bf16*>(h),
      static_cast<const bf16*>(x_src), w,
      static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
      static_cast<const float*>(row_weight),
      static_cast<const float*>(s_dense), static_cast<float*>(dh),
      static_cast<float*>(dx_src), static_cast<bf16*>(dmsg),
      static_cast<float*>(t_vec), static_cast<float*>(dt_vec), blk, K, c_in,
      c_out, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // column tiles x slot splits x row tiles (as ops/fused_conv.py:
  // lowrank_weight_tiles)
  const int tiles = (rp * (c_in + c_out) + kCols - 1) / kCols;
  const int row_tiles = (K + kTile - 1) / kTile;
  const long per_split = (num_tiles + num_splits - 1) / num_splits;
  const bool one_set = weights_one_set(c_in, c_out, R);
  const size_t wsmem = static_cast<size_t>(WeightsLayout(c_in, c_out, R,
                                                         one_set).total);
  auto weights = one_set ? lowrank_bwd_weights_wgmma<R8, true, kSlab>
                         : lowrank_bwd_weights_wgmma<R8, false, kSlab>;
  err = allow_smem(weights, wsmem);
  if (err != cudaSuccess) return err;
  weights<<<dim3(tiles, num_splits, row_tiles), kWarpgroup, wsmem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(x_src),
      static_cast<const bf16*>(dmsg), static_cast<const float*>(t_vec),
      static_cast<const float*>(dt_vec), static_cast<const int*>(slot_rows),
      static_cast<float*>(partial), num_tiles, per_split, K, c_in, c_out, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the rows kernel needs.
long fused_edge_conv_lowrank_bwd_wgmma_smem_bytes(int K, int c_in, int c_out,
                                                  int r) {
  return RowsLayout(K, c_in, c_out, slab_rank(r),
                    rows_deep(K, c_in, c_out)).total;
}

// Blocks one SM holds at once at these widths: the rows kernel's
// (weights = 0) or the weights kernel's (-1 if they are not taken).
int fused_edge_conv_lowrank_bwd_wgmma_blocks_per_sm(int K, int c_in,
                                                    int c_out, int r,
                                                    int weights) {
  return with_rank(r, [&](auto r8) {
    constexpr int R8 = decltype(r8)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    constexpr int R = 8 * R8;
    if (weights) {
      const bool one_set = weights_one_set(c_in, c_out, R);
      const size_t smem = static_cast<size_t>(
          WeightsLayout(c_in, c_out, R, one_set).total);
      return one_set
          ? blocks_per_sm(lowrank_bwd_weights_wgmma<R8, true, kSlab>, smem)
          : blocks_per_sm(lowrank_bwd_weights_wgmma<R8, false, kSlab>, smem);
    }
    const bool deep = rows_deep(K, c_in, c_out);
    const size_t smem = static_cast<size_t>(
        RowsLayout(K, c_in, c_out, R, deep).total);
    if constexpr (kSlab)
      return deep ? blocks_per_sm(lowrank_bwd_rows_slab_wgmma<true>, smem)
                  : blocks_per_sm(lowrank_bwd_rows_slab_wgmma<false>, smem);
    return deep ? blocks_per_sm(lowrank_bwd_rows_wgmma<R8, true>, smem)
                : blocks_per_sm(lowrank_bwd_rows_wgmma<R8, false>, smem);
  }, -1);
}

// Launches the bfloat16 backward on `stream`: the rows kernel, then the
// weights kernel.  Pointers are device pointers; h, x_src and w3 bfloat16;
// g, b3, row_weight, s_dense, dh, dx_src, t_vec, dt_vec and partial
// float32; dmsg bfloat16 (written by the first launch, read by the second,
// as t_vec and dt_vec [slots, rp], rp the padded rank: 8*ceil(r/8) up to
// 64, 64*ceil(r/64) past it); slot_rows int32.  Exactly one of s_dense and
// (slot_rows, row_weight) is non-null.  w3 is [K, r*(c_in+c_out)] in the
// model's column layout; 1 <= K, c_in, c_out <= 256 and 1 <= r <= 256.  At
// a rank other than rp, pad is bfloat16 scratch of K*rp*(c_in+c_out)
// elements, 16-byte aligned (ops/fused_conv.py:lowrank_pad_numel; unused
// otherwise).  partial is
// [num_splits, K+1, r*(c_in+c_out)] (dw3 rows then the db3 row, the
// model's columns, summed over splits by the caller).  Returns the
// cudaError_t of the launches (0 on success).
int fused_edge_conv_lowrank_bwd_wgmma_backward(
    const void* g, const void* h, const void* x_src, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* pad, void* dh, void* dx_src, void* dmsg,
    void* t_vec, void* dt_vec, void* partial, int num_blocks, int blk, int K,
    int c_in, int c_out, int r, int num_splits, void* stream) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      num_splits < 1 ||
      (r != padded_rank(r) &&
       (pad == nullptr || reinterpret_cast<uintptr_t>(pad) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_rank(r, [&](auto r8) {
    return launch<decltype(r8)::value, decltype(r8)::slab>(g, h, x_src, w3, b3, slot_rows,
                                       row_weight, s_dense, pad, dh, dx_src,
                                       dmsg, t_vec, dt_vec, partial,
                                       num_blocks, blk, K, c_in, c_out, r,
                                       num_splits, s);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
