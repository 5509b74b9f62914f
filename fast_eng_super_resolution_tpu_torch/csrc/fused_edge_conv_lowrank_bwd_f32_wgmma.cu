// Fused edge-conditioned conv layer with rank-r factorized edge kernels,
// backward, in float32 on Hopper's tensor cores (wgmma, sm_90a), exact to
// float32 through split bf16 operands: the gradients of
// fused_edge_conv_lowrank_f32_wgmma.cu's forward.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_lowrank_bwd_jit
// for float32 operands at every rank 1 .. 256 and K, c_in, c_out 1 .. 256
// (fused_edge_conv_lowrank_bwd_wgmma.cu is the bfloat16 instance) and
// computes the same function, w3's and b3's gradients in the model's column
// layout.  With the
// forward's notation and g the gradient of its output, per slot e:
//
//   dmsg[o]   = sum_r S[r, e] g[r, o]                 (0 on padding)
//   dt[q]     = sum_o V[o, q] dmsg[o]
//   dx_src[i] = sum_q U[i, q] dt[q]
//   duv[i r + q]         = x_src[i] dt[q]             (the U columns)
//   duv[r c_in + o r + q] = dmsg[o] t[q]              (the V columns)
//   dh[k]     = sum_j duv[j] w3[k, j]
//   dw3[k, j] = sum_e h[e, k] duv[e, j],  db3[j] = sum_e duv[e, j]
//
// Numbers.  Every operand and every sum is float32, as in the plain version
// (ops/fused_conv.py:fused_edge_conv_lowrank_bwd_plain, whose dmsg is not
// rounded at float32).  Every float32 operand of a product is split exactly
// into three bf16 parts and the six products of order >= 2^-16 run smallest
// first into a float32 accumulator (f32_wgmma.cuh); no operand is a
// rounding of a product:
//
//  (a) rows kernel.  uv is recomputed as the forward does (h split, the
//      kUv chunks of lowrank_f32_wgmma.cuh's stage image).  dh = duv w3^T
//      is not formed from duv but factored,
//        dh[k] = sum_q dt[q] P[k, q] + sum_q t[q] Q[k, q],
//        P = x_src @ W3U,  Q = dmsg @ W3V,
//      W3U[i, (k, q)] = w3[k, i r + q], W3V[o, (k, q)] = w3[k, r c_in + o r
//      + q] (the kP and kQ chunks): x_src is an input; dmsg = row_weight
//      g[slot_rows] is a float32 product, so it is split in three like the
//      rest (the bfloat16 instance rounds it once, as its plain version
//      does).
//  (b) weights kernel.  dw3 = h^T duv with duv = [x_src (x) dt, dmsg (x) t]
//      formed in float32, exactly as the plain version forms it, then h and
//      duv each split in three: six products per chunk of 64 slots.  db3 is
//      summed from duv itself in float32 by the thread that forms its
//      column.
//
// Design.  Both kernels run at the padded rank rp (lowrank_f32_wgmma.cuh: 8
// ceil(r / 8) up to 64, 64 ceil(r / 64) past it): the stage image holds
// w3's chunks and b3 padded with zeros at q >= r, t and dt are scratch
// [slots, rp] (zero at q >= r), and the weights kernel writes only the
// model's columns of dw3 and db3.  Past rank 64 both run slabs of 64
// (kSlab): (a) forms dmsg and the tiles once, then walks the slabs in turn
// (the three walks of each over its slab's chunks, t and dt in registers
// for one slab at a time and written at the slab's end, dx_src and dh
// added slab after slab by the thread that writes them); in (b) each
// 64-column half of a block's 128 columns is one slab of one channel, so a
// block stages only those two slabs' t or dt ([64][64] each) and its
// shared memory stays the rank-64 one.
//  (a) one block per 64-slot tile: one consumer warpgroup and one producer
//      warp.  The producer streams the stage image (V, U, P, Q chunks, laid
//      out once per call by a first launch) into f32_wgmma.cuh's 4-stage
//      ring.  Each warp forms its 16 rows of dmsg in float32 (row_weight
//      g[slot_rows] in CompactS form; the dense form sums S^T g), writes them
//      once (for (b)) and stages them and its x_src rows in shared memory.
//      The warpgroup then walks three times with two chunks' products in
//      flight: A = split h over the V and U chunks (dt in registers; t in
//      registers and dx_src as quad sums), A = split x_src over the P chunks
//      (dh's P half, a quad sum per k, waits in shared memory), A = split
//      dmsg over the Q chunks (dh = P half + Q half).  Past a depth of 64
//      each A is split into shared memory and each chunk is dp / 32 stages
//      (lowrank_f32_wgmma.cuh DeepWalk), one chunk's products at a time.
//      t and dt are written as float32 scratch for (b).  Tiles of padding
//      only write zeros in CompactS form.
//  (b) grid (128-column tiles of rp (c_in + c_out), slot splits, 64-row
//      tiles of K).  Per 64-slot chunk a block splits its 64 columns of the
//      h rows into three MN-major A parts (h^T), forms duv for its columns
//      (each
//      thread one column, in slot order) from the chunk's x_src or dmsg
//      channels and t or dt rows, splits it into three K-major B parts, then
//      runs 6 x 4 m64n128k16 products into a fresh accumulator, which it adds
//      into its float32 sum.  The next chunk's rows (h, the block's channels
//      of x_src and dmsg, t, dt) are copied into shared memory by cp.async
//      while the products run.  Each split writes its partial [K+1, r (c_in +
//      c_out)] (row K: db3, from the first row tile) once; the wrapper sums
//      the partials in a fixed
//      order.  No atomics anywhere: two launches on the same inputs give the
//      same bits.
//
// Bound.  Per real slot about 2 K r (c_in + c_out) operations for the uv
// recompute, 2 K r (c_in + c_out) for dh and 2 (K+1) r (c_in + c_out) for
// dw3 and db3, against (K + c_in) 4 + c_out 4 bytes of inputs and the
// outputs: bounded by operations, on the tensor cores six bf16 passes at 989
// TFLOP/s (against float32 FMAs at 67).  The padded instance does rp / r
// of that work, so it reaches at most r / rp of the bound.  What stands in
// the way: the ring's per-stage barriers, the epilogues on the CUDA cores,
// each tile's start (one tile per block in (a)), and in (b) the splits of h
// and duv on the CUDA cores before each chunk's products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_lowrank_bwd_f32_wgmma.so
//        fused_edge_conv_lowrank_bwd_f32_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lowrank_f32_wgmma.cuh"

namespace {

using namespace lowrank_f32;

constexpr int kRows = 64;   // receiver rows per block (rows_blk)
constexpr int kThreads = kWarpgroup + 32;  // rows kernel: + the producer warp
constexpr int kCols = 128;  // weights kernel: output columns per block
constexpr int kF = 18;      // weights kernel: channel factors per slot

// Byte offsets of the rows kernel's shared memory: the 2 kRing mbarriers,
// the ring of stages ([3][N][sd] bf16 each, dp the largest of K, c_in and
// c_out, image_depth, sd stage_depth), past a depth of 64 the A operand's
// split parts [3][64][dp] bf16, the x_src, dmsg and dh tiles [64][odd
// stride] f32.  At width 48, K 48, rank 16: 111 KB (two blocks per SM); at
// 128, rank 64: 198 KB.
//
// Wide (the widest of K, c_in and c_out past 128; lowrank_f32_wgmma.cuh
// wide_dims; then dp > 128 and S = kDeep): no x_src tile (the U chunks'
// epilogues and the split of A for the P chunks read the tile's rows of
// x_src, contiguous, from device memory) and no dh tile (the P half is
// written to dh, and the Q half's writer adds to it): the ring, A's parts
// and the dmsg tile, 213 KB at K = c_in = c_out = 256 (ranks 8, 16, 32,
// 64; 195 KB at 40), 160 KB at K 256 with widths 48, 213 KB at K 48 with
// widths 256 (rank 16).
struct RowsLayout {
  int n, dp, sd, xs, ds, hs;
  bool wide;
  long stage, ring, a, x, d, dh, total;
  // wide: wide_dims(K, c_in, c_out), the instance's
  __host__ __device__ RowsLayout(int K, int c_in, int c_out, int r,
                                 bool wide_) {
    n = chunk_cols(r);
    const int widest = K > c_in ? (K > c_out ? K : c_out)
                                : (c_in > c_out ? c_in : c_out);
    dp = image_depth(widest);
    sd = stage_depth(dp);
    wide = wide_;
    xs = c_in | 1;
    ds = c_out | 1;
    hs = K | 1;
    stage = 3 * 2L * n * sd;
    ring = 128;
    a = ring + kRing * stage;
    x = a + (dp > 64 ? 3 * 2L * kTile * dp : 0);
    d = wide ? x : x + 4L * kTile * xs;     // wide: no x_src tile
    dh = d + 4L * kTile * ds;
    total = wide ? dh : dh + 4L * kTile * hs;  // wide: no dh tile
  }
};

// ---------------------------------------------------------------------------
// (a) dmsg, t, dt, dx_src and dh for one 64-slot tile.  R8 = rp / 8 (rp the
// padded rank), S = dp / 16 (the k16 steps of every A operand: h, x_src and
// dmsg, zero padded) up to 4, kDeep past it (the A operands in shared
// memory); kWide (with kDeep only): the wide layout, a separate instance.
template <int R8, int S, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks<R8, S>)
lowrank_bwd_rows_f32_wgmma(const float* __restrict__ g,
                           const float* __restrict__ h,
                           const float* __restrict__ x_src,
                           const bf16* __restrict__ image,
                           const float* __restrict__ b3,
                           const int* __restrict__ slot_rows,
                           const float* __restrict__ row_weight,
                           const float* __restrict__ s_dense,
                           float* __restrict__ dh, float* __restrict__ dx_src,
                           float* __restrict__ dmsg_out,
                           float* __restrict__ t_out,
                           float* __restrict__ dt_out, int blk, int K,
                           int c_in, int c_out) {
  constexpr int R = 8 * R8, N = kN<R8>, G = N / R;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(K, c_in, c_out, R, kWide);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const long slot0 = static_cast<long>(blockIdx.x) * kTile;
  const long b = slot0 / blk;
  const long row_base = b * kRows;
  const bool compact = s_dense == nullptr;
  const int lane = threadIdx.x % 32;
  const int n_v = cdiv(c_out, G), n_u = cdiv(c_in, G), n_k = cdiv(K, G);
  // every warp decides by itself whether the tile holds a real slot
  const bool real = !compact ||
                    __any_sync(0xffffffffu, slot_rows[slot0 + lane] >= 0 ||
                                                slot_rows[slot0 + lane + 32] >= 0);

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // ---- producer ----
    if (real && lane == 0) {
      uint32_t j = 0;
      produce(full, empty, ring, reinterpret_cast<const unsigned char*>(image),
              static_cast<uint32_t>(L.stage),
              (n_v + n_u + 2 * n_k) * (L.dp / L.sd) - 1, j);
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x, warp = tid / 32;
  if (!real) {  // padding only: every gradient is 0
    for (int e = tid; e < kTile * K; e += kWarpgroup) dh[slot0 * K + e] = 0.f;
    for (int e = tid; e < kTile * c_in; e += kWarpgroup)
      dx_src[slot0 * c_in + e] = 0.f;
    for (int e = tid; e < kTile * c_out; e += kWarpgroup)
      dmsg_out[slot0 * c_out + e] = 0.f;
    for (int e = tid; e < kTile * R; e += kWarpgroup) {
      t_out[slot0 * R + e] = 0.f;
      dt_out[slot0 * R + e] = 0.f;
    }
    return;
  }
  const int xs = L.xs, ds = L.ds, hs = L.hs;
  float* x_sm = reinterpret_cast<float*>(smem + L.x);
  float* d_sm = reinterpret_cast<float*>(smem + L.d);
  float* dh_sm = reinterpret_cast<float*>(smem + L.dh);

  // this warp's 16 rows of dmsg (float32, written once for the weights
  // kernel) and of x_src; every later read of them is by this warp
  const int s_lo = 16 * warp;
  for (int e = lane; e < 16 * c_out; e += 32) {
    const int s = s_lo + e / c_out, o = e % c_out;
    float d = 0.f;
    if (compact) {
      const int r = slot_rows[slot0 + s];
      if (r >= 0) d = row_weight[row_base + r] * g[(row_base + r) * c_out + o];
    } else {
      const float* s_col = s_dense + row_base * blk + (slot0 - b * blk) + s;
      for (int r = 0; r < kRows; ++r)
        d = fmaf(s_col[static_cast<long>(r) * blk], g[(row_base + r) * c_out + o], d);
    }
    dmsg_out[(slot0 + s) * c_out + o] = d;
    d_sm[s * ds + o] = d;
  }
  if (!kWide)
    for (int e = lane; e < 16 * c_in; e += 32) {
      const int s = s_lo + e / c_in, i = e % c_in;
      x_sm[s * xs + i] = x_src[(slot0 + s) * c_in + i];
    }
  __syncwarp();
  // the tile's rows of x_src: the x_src tile, or (wide) device memory
  const float* x_rows = kWide ? x_src + slot0 * c_in : x_sm;
  const int x_stride = kWide ? c_in : xs;

  const int r0 = acc_row(0);  // this thread's rows: r0 and r0 + 8
  const bool writer = tid % 4 == 0;
  const int ru = R * c_in;
  const uint64_t d0 = desc(ring, L.sd);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = dstage / 3;
  uint32_t j = 0;  // the ring's step, counted as the producer counts it
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  // past a depth of 64: the walk over chunks 0 .. n - 1 with A = the three
  // parts of the 64 rows of `src` [width] split into shared memory, once
  // every warp is done with the last walk's
  auto deep = [&](const float* src, long stride, int width, int n, auto& fin) {
    warpgroup_sync(0);
    split_smem(a_sm, src, stride, width, L.dp);
    fence_async_smem();
    warpgroup_sync(0);
    const DeepWalk<N, std::remove_reference_t<decltype(fin)>> walk{
        desc(a_sm, L.dp), static_cast<uint32_t>(2 * kTile * L.dp >> 4),
        L.dp / L.sd, full, empty, d0, dstage, dpart, lane, fin};
    walk.all(n, j);
  };
  // t and dt of this thread's rows r0, r0 + 8 at its 2 R8 values of q
  float tq[2][R8][2], dq[2][R8][2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int m = 0; m < R8; ++m)
      tq[hf][m][0] = tq[hf][m][1] = dq[hf][m][0] = dq[hf][m][1] = 0.f;

  {  // ---- uv: dt from the V chunks, t and dx_src from the U chunks ----
    auto fin = [&](const float (&acc)[N / 2], int c) {
      if (c < n_v) {  // dt[s, q] += dmsg[s, o] V[s, o, q]
        const int o0 = c * G, gc = lesser(G, c_out - o0);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          if (gg >= gc) continue;
          const float da = d_sm[r0 * ds + o0 + gg];
          const float db = d_sm[(r0 + 8) * ds + o0 + gg];
          const float* bias = b3 + ru + (o0 + gg) * R;
#pragma unroll
          for (int u = 0; u < 4 * R8; ++u) {
            const int jj = 4 * R8 * gg + u;
            const float v = acc[jj] + __ldg(bias + q_of<R8>(jj));
            float& dv = dq[(u >> 1) & 1][u >> 2][u & 1];
            dv = fmaf((u >> 1) & 1 ? db : da, v, dv);
          }
        }
      } else {  // t += x U; dx_src[s, i] = sum_q U[s, i, q] dt[s, q]
        const int i0 = (c - n_v) * G, gc = lesser(G, c_in - i0);
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          if (gg >= gc) continue;
          const float xa = x_rows[r0 * x_stride + i0 + gg];
          const float xb = x_rows[(r0 + 8) * x_stride + i0 + gg];
          const float* bias = b3 + (i0 + gg) * R;
          float pa = 0.f, pb = 0.f;
#pragma unroll
          for (int u = 0; u < 4 * R8; ++u) {
            const int jj = 4 * R8 * gg + u;
            const float uv = acc[jj] + __ldg(bias + q_of<R8>(jj));
            const int hf = (u >> 1) & 1, m = u >> 2, bb = u & 1;
            tq[hf][m][bb] = fmaf(hf ? xb : xa, uv, tq[hf][m][bb]);
            if (hf)
              pb = fmaf(uv, dq[1][m][bb], pb);
            else
              pa = fmaf(uv, dq[0][m][bb], pa);
          }
          pa = quad_sum(pa);
          pb = quad_sum(pb);
          if (writer) {
            dx_src[(slot0 + r0) * c_in + i0 + gg] = pa;
            dx_src[(slot0 + r0 + 8) * c_in + i0 + gg] = pb;
          }
        }
      }
    };
    if constexpr (S > 4) {
      deep(h + slot0 * K, K, K, n_v + n_u, fin);
    } else {
      uint32_t ha[3][S][4];
      split_rows<S>(ha, h + slot0 * K, K, K);
      const Walk<N, S, decltype(fin)> walk{ha, full, empty, d0, dstage,
                                           dpart, lane, fin};
      walk.all(n_v + n_u - 1, j);
    }
  }

  // dh[s, k] over the P (Q) chunks: the sums over q of this thread's
  // accumulator values weighted by w (dt, then t), one quad sum per k
  auto dh_half = [&](const float (&acc)[N / 2], int c, const float (&w)[2][R8][2],
                     bool q_half) {
    const int k0 = c * G, gk = lesser(G, K - k0);
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      if (gg >= gk) continue;
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int u = 0; u < 4 * R8; ++u) {
        const int jj = 4 * R8 * gg + u;
        if ((u >> 1) & 1)
          pb = fmaf(acc[jj], w[1][u >> 2][u & 1], pb);
        else
          pa = fmaf(acc[jj], w[0][u >> 2][u & 1], pa);
      }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (!writer) continue;
      // where the P half waits: the dh tile, or (wide) dh itself
      float* ha_ = dh_sm + r0 * hs + k0 + gg;
      float* hb_ = dh_sm + (r0 + 8) * hs + k0 + gg;
      if constexpr (kWide) {
        ha_ = dh + (slot0 + r0) * K + k0 + gg;
        hb_ = dh + (slot0 + r0 + 8) * K + k0 + gg;
      }
      if (q_half) {
        dh[(slot0 + r0) * K + k0 + gg] = *ha_ + pa;
        dh[(slot0 + r0 + 8) * K + k0 + gg] = *hb_ + pb;
      } else {
        *ha_ = pa;
        *hb_ = pb;
      }
    }
  };
  {  // ---- dh's P half: P = x_src @ W3U weighted by dt ----
    auto fin = [&](const float (&acc)[N / 2], int c) { dh_half(acc, c, dq, false); };
    if constexpr (S > 4) {
      deep(x_rows, x_stride, c_in, n_k, fin);
    } else {
      uint32_t xa[3][S][4];
      split_rows<S>(xa, x_sm, xs, c_in);
      const Walk<N, S, decltype(fin)> walk{xa, full, empty, d0, dstage,
                                           dpart, lane, fin};
      walk.all(n_k - 1, j);
    }
  }
  {  // ---- dh = P half + Q half: Q = dmsg @ W3V weighted by t ----
    auto fin = [&](const float (&acc)[N / 2], int c) { dh_half(acc, c, tq, true); };
    if constexpr (S > 4) {
      deep(d_sm, ds, c_out, n_k, fin);
    } else {
      uint32_t da[3][S][4];
      split_rows<S>(da, d_sm, ds, c_out);
      const Walk<N, S, decltype(fin)> walk{da, full, empty, d0, dstage,
                                           dpart, lane, fin};
      walk.all(n_k - 1, j);
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

// (a) past rank 64: lowrank_bwd_rows_f32_wgmma's tile at R8 = 8 walked
// slab by slab (the stage image holds each slab's V, U, P and Q chunks in
// turn, and b3 slab by slab): dmsg and the x_src tile formed once, then
// per slab the three walks from t and dt zero in registers, written to
// t_out / dt_out at the slab's columns at its end, and this slab's terms
// of dx_src and dh added to the earlier slabs' by the thread that writes
// them.  A kernel of its own, so that the instances up to rank 64 keep
// their code.
template <int S, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks<8, S>)
lowrank_bwd_rows_slab_f32_wgmma(const float* __restrict__ g,
                                const float* __restrict__ h,
                                const float* __restrict__ x_src,
                                const bf16* __restrict__ image,
                                const float* __restrict__ b3,
                                const int* __restrict__ slot_rows,
                                const float* __restrict__ row_weight,
                                const float* __restrict__ s_dense,
                                float* __restrict__ dh,
                                float* __restrict__ dx_src,
                                float* __restrict__ dmsg_out,
                                float* __restrict__ t_out,
                                float* __restrict__ dt_out, int blk, int K,
                                int c_in, int c_out, int slabs) {
  constexpr int R8 = 8, R = 8 * R8, N = kN<R8>, G = N / R;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(K, c_in, c_out, R, kWide);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const long slot0 = static_cast<long>(blockIdx.x) * kTile;
  const long b = slot0 / blk;
  const long row_base = b * kRows;
  const bool compact = s_dense == nullptr;
  const int lane = threadIdx.x % 32;
  const int n_v = cdiv(c_out, G), n_u = cdiv(c_in, G), n_k = cdiv(K, G);
  const int rp = slabs * R;  // t's and dt's columns
  // every warp decides by itself whether the tile holds a real slot
  const bool real = !compact ||
                    __any_sync(0xffffffffu, slot_rows[slot0 + lane] >= 0 ||
                                                slot_rows[slot0 + lane + 32] >= 0);

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  if (threadIdx.x >= kWarpgroup) {  // ---- producer ----
    if (real && lane == 0) {
      uint32_t j = 0;
      produce(full, empty, ring, reinterpret_cast<const unsigned char*>(image),
              static_cast<uint32_t>(L.stage),
              slabs * (n_v + n_u + 2 * n_k) * (L.dp / L.sd) - 1, j);
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x, warp = tid / 32;
  if (!real) {  // padding only: every gradient is 0
    for (int e = tid; e < kTile * K; e += kWarpgroup) dh[slot0 * K + e] = 0.f;
    for (int e = tid; e < kTile * c_in; e += kWarpgroup)
      dx_src[slot0 * c_in + e] = 0.f;
    for (int e = tid; e < kTile * c_out; e += kWarpgroup)
      dmsg_out[slot0 * c_out + e] = 0.f;
    for (int e = tid; e < kTile * rp; e += kWarpgroup) {
      t_out[slot0 * rp + e] = 0.f;
      dt_out[slot0 * rp + e] = 0.f;
    }
    return;
  }
  const int xs = L.xs, ds = L.ds, hs = L.hs;
  float* x_sm = reinterpret_cast<float*>(smem + L.x);
  float* d_sm = reinterpret_cast<float*>(smem + L.d);
  float* dh_sm = reinterpret_cast<float*>(smem + L.dh);

  // this warp's 16 rows of dmsg (float32, written once for the weights
  // kernel) and of x_src; every later read of them is by this warp
  const int s_lo = 16 * warp;
  for (int e = lane; e < 16 * c_out; e += 32) {
    const int s = s_lo + e / c_out, o = e % c_out;
    float d = 0.f;
    if (compact) {
      const int r = slot_rows[slot0 + s];
      if (r >= 0) d = row_weight[row_base + r] * g[(row_base + r) * c_out + o];
    } else {
      const float* s_col = s_dense + row_base * blk + (slot0 - b * blk) + s;
      for (int r = 0; r < kRows; ++r)
        d = fmaf(s_col[static_cast<long>(r) * blk], g[(row_base + r) * c_out + o], d);
    }
    dmsg_out[(slot0 + s) * c_out + o] = d;
    d_sm[s * ds + o] = d;
  }
  if (!kWide)
    for (int e = lane; e < 16 * c_in; e += 32) {
      const int s = s_lo + e / c_in, i = e % c_in;
      x_sm[s * xs + i] = x_src[(slot0 + s) * c_in + i];
    }
  __syncwarp();
  // the tile's rows of x_src: the x_src tile, or (wide) device memory
  const float* x_rows = kWide ? x_src + slot0 * c_in : x_sm;
  const int x_stride = kWide ? c_in : xs;

  const int r0 = acc_row(0);  // this thread's rows: r0 and r0 + 8
  const bool writer = tid % 4 == 0;
  const int ru = R * c_in;
  const uint64_t d0 = desc(ring, L.sd);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = dstage / 3;
  uint32_t j = 0;  // the ring's step, counted as the producer counts it
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  // past a depth of 64: the walk over chunks 0 .. n - 1 with A = the three
  // parts of the 64 rows of `src` [width] split into shared memory, once
  // every warp is done with the last walk's
  auto deep = [&](const float* src, long stride, int width, int n, auto& fin) {
    warpgroup_sync(0);
    split_smem(a_sm, src, stride, width, L.dp);
    fence_async_smem();
    warpgroup_sync(0);
    const DeepWalk<N, std::remove_reference_t<decltype(fin)>> walk{
        desc(a_sm, L.dp), static_cast<uint32_t>(2 * kTile * L.dp >> 4),
        L.dp / L.sd, full, empty, d0, dstage, dpart, lane, fin};
    walk.all(n, j);
  };
  for (int sl = 0; sl < slabs; ++sl) {
    const float* b3s = b3 + sl * R * (c_in + c_out);  // slab sl's b3
    // dx_src's and dh's entries: this slab's terms added to the earlier
    // slabs' (by the thread that wrote them)
    auto add = [&](float* at, float v) {
      if (sl > 0) v += *at;
      *at = v;
    };
    // t and dt of this thread's rows r0, r0 + 8 at its 2 R8 values of q
    float tq[2][R8][2], dq[2][R8][2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int m = 0; m < R8; ++m)
        tq[hf][m][0] = tq[hf][m][1] = dq[hf][m][0] = dq[hf][m][1] = 0.f;

    {  // ---- uv: dt from the V chunks, t and dx_src from the U chunks ----
      auto fin = [&](const float (&acc)[N / 2], int c) {
        if (c < n_v) {  // dt[s, q] += dmsg[s, o] V[s, o, q]
          const int o0 = c * G, gc = lesser(G, c_out - o0);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            if (gg >= gc) continue;
            const float da = d_sm[r0 * ds + o0 + gg];
            const float db = d_sm[(r0 + 8) * ds + o0 + gg];
            const float* bias = b3s + ru + (o0 + gg) * R;
#pragma unroll
            for (int u = 0; u < 4 * R8; ++u) {
              const int jj = 4 * R8 * gg + u;
              const float v = acc[jj] + __ldg(bias + q_of<R8>(jj));
              float& dv = dq[(u >> 1) & 1][u >> 2][u & 1];
              dv = fmaf((u >> 1) & 1 ? db : da, v, dv);
            }
          }
        } else {  // t += x U; dx_src[s, i] = sum_q U[s, i, q] dt[s, q]
          const int i0 = (c - n_v) * G, gc = lesser(G, c_in - i0);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            if (gg >= gc) continue;
            const float xa = x_rows[r0 * x_stride + i0 + gg];
            const float xb = x_rows[(r0 + 8) * x_stride + i0 + gg];
            const float* bias = b3s + (i0 + gg) * R;
            float pa = 0.f, pb = 0.f;
#pragma unroll
            for (int u = 0; u < 4 * R8; ++u) {
              const int jj = 4 * R8 * gg + u;
              const float uv = acc[jj] + __ldg(bias + q_of<R8>(jj));
              const int hf = (u >> 1) & 1, m = u >> 2, bb = u & 1;
              tq[hf][m][bb] = fmaf(hf ? xb : xa, uv, tq[hf][m][bb]);
              if (hf)
                pb = fmaf(uv, dq[1][m][bb], pb);
              else
                pa = fmaf(uv, dq[0][m][bb], pa);
            }
            pa = quad_sum(pa);
            pb = quad_sum(pb);
            if (writer) {
              add(dx_src + (slot0 + r0) * c_in + i0 + gg, pa);
              add(dx_src + (slot0 + r0 + 8) * c_in + i0 + gg, pb);
            }
          }
        }
      };
      if constexpr (S > 4) {
        deep(h + slot0 * K, K, K, n_v + n_u, fin);
      } else {
        uint32_t ha[3][S][4];
        split_rows<S>(ha, h + slot0 * K, K, K);
        const Walk<N, S, decltype(fin)> walk{ha, full, empty, d0, dstage,
                                             dpart, lane, fin};
        walk.all(n_v + n_u - 1, j);
      }
    }

    // dh[s, k] over the P (Q) chunks: the sums over q of this thread's
    // accumulator values weighted by w (dt, then t), one quad sum per k
    auto dh_half = [&](const float (&acc)[N / 2], int c,
                       const float (&w)[2][R8][2], bool q_half) {
      const int k0 = c * G, gk = lesser(G, K - k0);
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if (gg >= gk) continue;
        float pa = 0.f, pb = 0.f;
#pragma unroll
        for (int u = 0; u < 4 * R8; ++u) {
          const int jj = 4 * R8 * gg + u;
          if ((u >> 1) & 1)
            pb = fmaf(acc[jj], w[1][u >> 2][u & 1], pb);
          else
            pa = fmaf(acc[jj], w[0][u >> 2][u & 1], pa);
        }
        pa = quad_sum(pa);
        pb = quad_sum(pb);
        if (!writer) continue;
        float* da_ = dh + (slot0 + r0) * K + k0 + gg;
        float* db_ = dh + (slot0 + r0 + 8) * K + k0 + gg;
        // where the P half waits: the dh tile, or (wide) dh itself
        float* ha_ = dh_sm + r0 * hs + k0 + gg;
        float* hb_ = dh_sm + (r0 + 8) * hs + k0 + gg;
        if constexpr (kWide) {
          ha_ = da_;
          hb_ = db_;
        }
        if (!q_half) {  // the P half waits (wide: added into dh)
          if constexpr (kWide) {
            add(ha_, pa);
            add(hb_, pb);
          } else {
            *ha_ = pa;
            *hb_ = pb;
          }
        } else if constexpr (kWide) {  // dh holds the earlier slabs' + P
          *da_ = *ha_ + pa;
          *db_ = *hb_ + pb;
        } else {
          add(da_, *ha_ + pa);
          add(db_, *hb_ + pb);
        }
      }
    };
    {  // ---- dh's P half: P = x_src @ W3U weighted by dt ----
      auto fin = [&](const float (&acc)[N / 2], int c) { dh_half(acc, c, dq, false); };
      if constexpr (S > 4) {
        deep(x_rows, x_stride, c_in, n_k, fin);
      } else {
        uint32_t xa[3][S][4];
        split_rows<S>(xa, x_sm, xs, c_in);
        const Walk<N, S, decltype(fin)> walk{xa, full, empty, d0, dstage,
                                             dpart, lane, fin};
        walk.all(n_k - 1, j);
      }
    }
    {  // ---- dh = P half + Q half: Q = dmsg @ W3V weighted by t ----
      auto fin = [&](const float (&acc)[N / 2], int c) { dh_half(acc, c, tq, true); };
      if constexpr (S > 4) {
        deep(d_sm, ds, c_out, n_k, fin);
      } else {
        uint32_t da[3][S][4];
        split_rows<S>(da, d_sm, ds, c_out);
        const Walk<N, S, decltype(fin)> walk{da, full, empty, d0, dstage,
                                             dpart, lane, fin};
        walk.all(n_k - 1, j);
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

// ---------------------------------------------------------------------------
// (b) partial[split, k, c] = sum over the split's slots e of h[e, k] duv[e, c]
// for the block's 128 padded columns c of rp (c_in + c_out) and 64 rows k
// (k0 ..), and (first row tile) row K: db3, at the model's columns.  Shared
// memory: h^T's and duv's parts, then the raw rows of a chunk: h [64][64]
// (its columns k0 .., zeros past K), the block's channels of x_src (U
// columns) and dmsg (V columns) [64][kF], t and dt [64][R] (R the padded
// rank; past 64, kSlab, 64: the slab of dt (U) or t (V) of the block's
// first and of its second 64 columns).  102 KB at rank 16 (two blocks per
// SM), 110 KB at 32, 127 KB at 64 and past it.
struct WeightsLayout {
  long a, z, hraw, f, t, dt, total;
  __host__ __device__ WeightsLayout(int r) {
    a = 0;                                   // h^T parts [3][64 k][64 e]
    z = a + 3 * 2L * kTile * kTile;          // duv parts [3][kCols][64 e]
    hraw = z + 3 * 2L * kCols * kTile;       // h [64 e][64 k] f32
    f = hraw + 4L * kTile * kTile;           // channel factors [64 e][kF]
    t = f + 4L * kTile * kF;                 // t [64][r] f32
    dt = t + 4L * kTile * r;                 // dt [64][r] f32
    total = dt + 4L * kTile * r;
  }
};

template <int R8, bool kSlab>
__global__ void __launch_bounds__(kWarpgroup)
lowrank_bwd_weights_f32_wgmma(const float* __restrict__ h,
                              const float* __restrict__ x_src,
                              const float* __restrict__ dmsg,
                              const float* __restrict__ t_vec,
                              const float* __restrict__ dt_vec,
                              const int* __restrict__ slot_rows,
                              float* __restrict__ partial, long num_chunks,
                              long chunks_per_split, int K, int c_in,
                              int c_out, int rank) {
  constexpr int R = 8 * R8;
  extern __shared__ __align__(128) unsigned char smem[];
  const WeightsLayout L(R);
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  bf16* z_sm = reinterpret_cast<bf16*>(smem + L.z);
  float* h_sm = reinterpret_cast<float*>(smem + L.hraw);
  float* f_sm = reinterpret_cast<float*>(smem + L.f);
  float* t_sm = reinterpret_cast<float*>(smem + L.t);
  float* dt_sm = reinterpret_cast<float*>(smem + L.dt);
  const int tid = threadIdx.x;
  const int rp = kSlab ? padded_rank(rank) : R;  // t's and dt's columns
  const int ru = rp * c_in, ncol = rp * (c_in + c_out);
  const int n0 = blockIdx.x * kCols, k0 = blockIdx.z * kTile;
  const long split = blockIdx.y;
  const long c_lo = split * chunks_per_split;
  const long c_hi = c_lo + chunks_per_split < num_chunks
                        ? c_lo + chunks_per_split
                        : num_chunks;
  // the channels the block's columns use: x_src's iu0 .. iu0 + nu - 1 (U
  // columns n0 .. u_hi - 1), dmsg's ov0 .. ov0 + nv - 1 (V columns v_lo ..
  // v_hi - 1); nu + nv <= 128 / R + 2 <= kF
  const int u_hi = lesser(n0 + kCols, ru);
  const int v_lo = n0 > ru ? n0 : ru, v_hi = lesser(n0 + kCols, ncol);
  const int iu0 = n0 / rp, nu = n0 < u_hi ? (u_hi - 1) / rp - iu0 + 1 : 0;
  const int ov0 = (v_lo - ru) / rp;
  const int nv = v_lo < v_hi ? (v_hi - 1 - ru) / rp - ov0 + 1 : 0;
  const int nf = nu + nv;
  // this thread's column of duv: col = n0 + tid (none past ncol): U column
  // (channel i, q) = x_src[:, i] dt[:, q], or V column (o, q) = dmsg[:, o]
  // t[:, q]
  const int col = n0 + tid;
  const bool has_col = col < ncol;
  const bool u_col = col < ru;
  const int ch = has_col ? (u_col ? col : col - ru) / rp : 0;
  const int q = has_col ? col % rp : 0;
  const int fi = u_col ? ch - iu0 : nu + ch - ov0;
  // the rank factor [64][R]: kSlab, the slab of the thread's half at q % R
  const float* v_sm = kSlab ? (tid < kTile ? t_sm : dt_sm)
                            : (u_col ? dt_sm : t_sm);
  const int vq = kSlab ? q % R : q;
  const int zpart = kCols * kTile, apart = kTile * kTile;  // elements

  // rows of duv past ncol stay zero
  for (int e = tid; e < 3 * zpart / 8; e += kWarpgroup)
    reinterpret_cast<uint4*>(z_sm)[e] = make_uint4(0u, 0u, 0u, 0u);
  float sum[kCols / 2], acc[kCols / 2];
#pragma unroll
  for (int v = 0; v < kCols / 2; ++v) sum[v] = 0.f;
  float dbias = 0.f;

  // the first chunk from c on (c_hi if none) that holds a real slot (every
  // chunk in the dense form): chunks of padding only (dmsg 0) are skipped
  // in CompactS form
  auto next_real = [&](long c) {
    if (slot_rows == nullptr) return c;
    for (; c < c_hi; ++c)
      if (__syncthreads_or(tid < kTile && slot_rows[c * kTile + tid] >= 0))
        break;
    return c;
  };
  // chunk c's rows into shared memory by cp.async: h (columns k0 .. k0 +
  // 63, zeros past K), the block's channels of x_src and dmsg, t and dt
  // (16-byte pieces where the rows allow them); nothing waits for them here
  const bool vec_h = K % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const bool vec_r = (reinterpret_cast<uintptr_t>(t_vec) |
                      reinterpret_cast<uintptr_t>(dt_vec)) % 16 == 0;
  auto fetch = [&](long c) {
    const long s0 = c * kTile;
    if (vec_h) {
      for (int p = tid; p < kTile * kTile / 4; p += kWarpgroup) {
        const int s = p >> 4, k = k0 + 4 * (p & 15);
        const int bytes = k < K ? 4 * lesser(4, K - k) : 0;
        cp_async16(h_sm + 4 * p, bytes ? h + (s0 + s) * K + k : h, bytes);
      }
    } else {
      for (int p = tid; p < kTile * kTile; p += kWarpgroup) {
        const int s = p >> 6, k = k0 + (p & 63);
        cp_async4(h_sm + p, k < K ? h + (s0 + s) * K + k : h, k < K ? 4 : 0);
      }
    }
    for (int p = tid; p < kTile * nf; p += kWarpgroup) {
      const int s = p / nf, e = p - s * nf;
      cp_async4(f_sm + s * kF + e,
                e < nu ? x_src + (s0 + s) * c_in + iu0 + e
                       : dmsg + (s0 + s) * c_out + ov0 + e - nu, 4);
    }
    for (int half = 0; half < 2; ++half) {
      float* dst;
      const float* src;
      if constexpr (kSlab) {  // the 64 columns' slab of dt (U) or t (V)
        const int c0 = n0 + kTile * half;
        if (c0 >= ncol) continue;
        dst = half == 0 ? t_sm : dt_sm;
        src = (c0 < ru ? dt_vec : t_vec) + s0 * rp + c0 % rp;
      } else {
        if (half == 0 ? nu == 0 : nv == 0) continue;
        dst = half == 0 ? dt_sm : t_sm;
        src = (half == 0 ? dt_vec : t_vec) + s0 * R;
      }
      // [64][R] (kSlab: from rows of rp)
      if (vec_r) {
        for (int p = tid; p < kTile * R / 4; p += kWarpgroup)
          cp_async16(dst + 4 * p,
                     kSlab ? src + p / (R / 4) * rp + 4 * (p % (R / 4))
                           : src + 4 * p,
                     16);
      } else {
        for (int p = tid; p < kTile * R; p += kWarpgroup)
          cp_async4(dst + p, kSlab ? src + p / R * rp + p % R : src + p, 4);
      }
    }
    cp_async_commit();
  };
  const uint64_t dA = desc_mn(a_sm, kTile), dZ = desc(z_sm, kTile);
  const uint32_t dApart = 2 * apart >> 4, dZpart = 2 * zpart >> 4;
  long c = next_real(c_lo);
  if (c < c_hi) fetch(c);
  while (c < c_hi) {
    cp_async_wait_all();
    __syncthreads();  // the chunk's rows have landed, and every thread is
                      // done with the last chunk's products
    // A = h^T, MN-major: 8 consecutive k of one slot are a 16-byte piece of
    // each part; thread t splits the pieces t + 128 m
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int p = tid + kWarpgroup * m, s = p >> 3, kk = 8 * (p & 7);
      const float4 lo = *reinterpret_cast<const float4*>(h_sm + s * kTile + kk);
      const float4 hi = *reinterpret_cast<const float4*>(h_sm + s * kTile + kk + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint4 pt[3];
      split3_8(v, pt);
      const int at = mnmajor(kk, s, kTile);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        *reinterpret_cast<uint4*>(a_sm + r * apart + at) = pt[r];
    }
    if (has_col) {
      for (int s = 0; s < kTile; s += 8) {  // 8 slots: a 16-byte piece each
        float z[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          z[u] = f_sm[(s + u) * kF + fi] * v_sm[(s + u) * R + vq];
          dbias += z[u];
        }
        uint4 pt[3];
        split3_8(z, pt);
        const int at = kmajor(tid, s, kTile);
#pragma unroll
        for (int r = 0; r < 3; ++r)
          *reinterpret_cast<uint4*>(z_sm + r * zpart + at) = pt[r];
      }
    }
    fence_async_smem();
    __syncthreads();  // the parts are in place; the raw rows are free
    fence_operand(acc);
    fence();
#pragma unroll
    for (int qq = 0; qq < 6; ++qq)
#pragma unroll
      for (int st = 0; st < kTile / 16; ++st)
        Mma<kCols, 1>::run(acc, dA + a_part(qq) * dApart + 16 * st,
                           dZ + b_part(qq) * dZpart + 16 * st, qq + st > 0);
    commit();
    c = next_real(c + 1);
    if (c < c_hi) fetch(c);  // while the products run
    wait_all();
    fence_operand(acc);
#pragma unroll
    for (int v = 0; v < kCols / 2; ++v) sum[v] += acc[v];
  }
  // the model's columns only (none at q >= r)
  const int ncol_r = rank * (c_in + c_out);
  float* dst = partial + split * (K + 1) * static_cast<long>(ncol_r);
#pragma unroll
  for (int v = 0; v < kCols / 2; ++v) {
    const int k = k0 + acc_row(v), cc = n0 + acc_col(v);
    const int rc = cc < ncol ? real_col(cc, rp, rank) : -1;
    if (k < K && rc >= 0) dst[static_cast<long>(k) * ncol_r + rc] = sum[v];
  }
  const int rc = has_col && k0 == 0 ? real_col(col, rp, rank) : -1;
  if (rc >= 0) dst[static_cast<long>(K) * ncol_r + rc] = dbias;
}

template <int R8, int S, bool kWide, bool kSlab>
cudaError_t launch(const float* g, const float* h, const float* x_src,
                   const float* w3, const float* b3, const int* slot_rows,
                   const float* row_weight, const float* s_dense, bf16* image,
                   float* dh, float* dx_src, float* dmsg, float* t_vec,
                   float* dt_vec, float* partial, int num_blocks, int blk,
                   int K, int c_in, int c_out, int r, int num_splits,
                   cudaStream_t stream) {
  constexpr int R = 8 * R8;
  const long num_tiles = static_cast<long>(num_blocks) * blk / kTile;
  const RowsLayout L(K, c_in, c_out, R, kWide);
  const int rp = padded_rank(r), slabs = rp / R;
  const size_t smem = static_cast<size_t>(L.total);
  cudaError_t err = kSlab
      ? allow_smem(lowrank_bwd_rows_slab_f32_wgmma<S, kWide>, smem)
      : allow_smem(lowrank_bwd_rows_f32_wgmma<R8, S, kWide>, smem);
  if (err != cudaSuccess) return err;
  const float* b3p;
  err = launch_lowrank_image(w3, b3, image,
                             slabs * bwd_chunks(L.n / R, K, c_in, c_out),
                             L.n, L.dp, rp, r, K, c_in, c_out, true, &b3p,
                             stream);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(num_tiles);
  if constexpr (kSlab)
    lowrank_bwd_rows_slab_f32_wgmma<S, kWide><<<grid, kThreads, smem, stream>>>(
        g, h, x_src, image, b3p, slot_rows, row_weight, s_dense, dh, dx_src,
        dmsg, t_vec, dt_vec, blk, K, c_in, c_out, slabs);
  else
    lowrank_bwd_rows_f32_wgmma<R8, S, kWide><<<grid, kThreads, smem, stream>>>(
        g, h, x_src, image, b3p, slot_rows, row_weight, s_dense, dh, dx_src,
        dmsg, t_vec, dt_vec, blk, K, c_in, c_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // column tiles x slot splits x row tiles (as ops/fused_conv.py:
  // lowrank_weight_tiles)
  const int tiles = (rp * (c_in + c_out) + kCols - 1) / kCols;
  const int row_tiles = (K + kTile - 1) / kTile;
  const long per_split = (num_tiles + num_splits - 1) / num_splits;
  const size_t wsmem = static_cast<size_t>(WeightsLayout(R).total);
  auto weights = lowrank_bwd_weights_f32_wgmma<R8, kSlab>;
  err = allow_smem(weights, wsmem);
  if (err != cudaSuccess) return err;
  weights<<<dim3(tiles, num_splits, row_tiles), kWarpgroup, wsmem, stream>>>(
      h, x_src, dmsg, t_vec, dt_vec, slot_rows, partial, num_tiles, per_split,
      K, c_in, c_out, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the rows kernel needs.
long fused_edge_conv_lowrank_bwd_f32_wgmma_smem_bytes(int K, int c_in,
                                                      int c_out, int r) {
  return RowsLayout(K, c_in, c_out, slab_rank(r),
                    wide_dims(K, c_in, c_out)).total;
}

// Blocks one SM holds at once at these widths: the rows kernel's
// (weights = 0) or the weights kernel's (-1 if they are not taken).
int fused_edge_conv_lowrank_bwd_f32_wgmma_blocks_per_sm(int K, int c_in,
                                                        int c_out, int r,
                                                        int weights) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim)
    return -1;
  const RowsLayout L(K, c_in, c_out, slab_rank(r),
                     wide_dims(K, c_in, c_out));
  return with_rank_depth(r, L.dp, [&](auto r8, auto s) {
    constexpr int R8 = decltype(r8)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    if (weights)
      return blocks_on_sm(lowrank_bwd_weights_f32_wgmma<R8, kSlab>, kWarpgroup,
                          static_cast<size_t>(WeightsLayout(8 * R8).total));
    constexpr int S = decltype(s)::value;
    const size_t smem = static_cast<size_t>(L.total);
    if constexpr (S > 4) {  // a wide layout is deep
      if (L.wide)
        return kSlab ? blocks_on_sm(lowrank_bwd_rows_slab_f32_wgmma<S, true>,
                                    kThreads, smem)
                     : blocks_on_sm(lowrank_bwd_rows_f32_wgmma<R8, S, true>,
                                    kThreads, smem);
    }
    return kSlab ? blocks_on_sm(lowrank_bwd_rows_slab_f32_wgmma<S, false>,
                                kThreads, smem)
                 : blocks_on_sm(lowrank_bwd_rows_f32_wgmma<R8, S, false>,
                                kThreads, smem);
  }, -1);
}

// Launches the float32 backward on `stream`: the stage image of w3, the
// rows kernel, then the weights kernel.  Pointers are device pointers to
// float32 arrays but slot_rows (int32) and image (bfloat16 scratch of
// ops/fused_conv.py:lowrank_image_numel elements, 16-byte aligned); dmsg
// [slots, c_out], t_vec and dt_vec [slots, rp] (rp the padded rank:
// 8*ceil(r/8) up to 64, 64*ceil(r/64) past it) are
// written by the rows kernel and read by the weights kernel.  Exactly one
// of s_dense and (slot_rows, row_weight) is non-null.  w3 is [K,
// r*(c_in+c_out)] in the model's column layout; 1 <= K, c_in, c_out <= 256
// and 1 <= r <= 256.  partial is [num_splits, K+1, r*(c_in+c_out)] (dw3
// rows then the db3 row, the model's columns, summed over splits by the
// caller).  Returns the cudaError_t of the
// launches (0 on success).
int fused_edge_conv_lowrank_bwd_f32_wgmma_backward(
    const void* g, const void* h, const void* x_src, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* image, void* dh, void* dx_src, void* dmsg,
    void* t_vec, void* dt_vec, void* partial, int num_blocks, int blk, int K,
    int c_in, int c_out, int r, int num_splits, void* stream) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      num_splits < 1 || reinterpret_cast<uintptr_t>(image) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowsLayout L(K, c_in, c_out, slab_rank(r),
                     wide_dims(K, c_in, c_out));
  return static_cast<int>(with_rank_depth(r, L.dp, [&](auto r8, auto s) {
    constexpr int R8 = decltype(r8)::value, S = decltype(s)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    auto go = [&](auto kernel_launch) {
      return kernel_launch(
          static_cast<const float*>(g), static_cast<const float*>(h),
          static_cast<const float*>(x_src), static_cast<const float*>(w3),
          static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
          static_cast<const float*>(row_weight),
          static_cast<const float*>(s_dense), static_cast<bf16*>(image),
          static_cast<float*>(dh), static_cast<float*>(dx_src),
          static_cast<float*>(dmsg), static_cast<float*>(t_vec),
          static_cast<float*>(dt_vec), static_cast<float*>(partial),
          num_blocks, blk, K, c_in, c_out, r, num_splits, st);
    };
    if constexpr (S > 4) {  // a wide layout is deep
      if (L.wide) return go(launch<R8, S, true, kSlab>);
    }
    return go(launch<R8, S, false, kSlab>);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
