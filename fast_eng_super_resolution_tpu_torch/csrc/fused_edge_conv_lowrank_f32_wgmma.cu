// Fused edge-conditioned conv layer with rank-r factorized edge kernels,
// forward, in float32 on Hopper's tensor cores (wgmma, sm_90a), exact to
// float32 through split bf16 operands.
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_lowrank_jit
// for float32 operands (the JAX function at gemm_dtype="float32", on the
// TPU's matrix unit at Precision.HIGHEST) at every rank 1 .. 256 and K,
// c_in, c_out 1 .. 256 (fused_edge_conv_lowrank_wgmma.cu is the bfloat16
// instance) and computes
// the same function.  Slots are grouped as for the full-rank layer: block b
// holds the slots whose receivers lie in rows [64 b, 64 b + 64).  Per slot
// e:
//
//   uv_e      = h_e w3 + b3                     [r (c_in + c_out)]
//   t_e[q]    = sum_i U_e[i, q] x[senders_perm[e], i]
//   msg_e[o]  = sum_q V_e[o, q] t_e[q]
//   out[r, o] = sum_{e in block(r)} S[r, e] msg_e[o]
//
// with U[i, q] = uv[i r + q], V[o, q] = uv[r c_in + o r + q] (the model's
// column layout) and S dense or given by its CompactS generators.
//
// Numbers.  Every operand and every sum is float32, as in the plain version
// (ops/fused_conv.py:fused_edge_conv_lowrank_plain).  The tensor cores see
// only h and w3, both inputs, each split exactly into three bf16 parts; per
// chunk of uv one float32 accumulator sums the six products of order >=
// 2^-16, smallest first (f32_wgmma.cuh), so uv is float32-exact.  b3 is
// added to the accumulator in float32; t, msg and the scatter run on the
// CUDA cores in float32.  (B1's factored form, P = X W3U then Q = t W3V,
// does about the same tensor-core work but twice the CUDA cores' work per
// slot and would have to split t, a float32 product.)
//
// Design.
//  - A block is one consumer warpgroup and one producer warp and owns one
//    part of one receiver block's slot walk: grid (num_blocks, parts), the
//    parts from the wrapper's planner (ops/fused_conv.py:conv_parts).
//  - Every rank runs at the padded rank rp (8 ceil(r / 8) up to 64, 64
//    ceil(r / 64) past it): the stage image below holds w3's chunks and
//    b3 padded with zeros at q >= r (lowrank_f32_wgmma.cuh), so t's padded
//    entries stay zero.
//  - Past rank 64 (kSlab) each tile walks the rp / 64 slabs in turn, each
//    the rank-64 walk on its slab's columns (the image holds the slabs'
//    chunks one after the other), h split once per tile: t in registers
//    for one slab at a time, the slab's messages scattered into the part's
//    sums at the slab's end, slab after slab.  In the wide layout, where
//    the x and message tiles share one, the x rows are fetched again for
//    each slab after the first.
//  - Per 64-slot tile the consumers split h's rows into register-A
//    fragments once (K up to 64; past it into shared memory, each chunk
//    then in K / 32 stages: lowrank_f32_wgmma.cuh DeepWalk), then walk uv in
//    chunks of N = G rp columns of whole channels (64 at most): the U
//    chunks, then the V chunks.  w3's chunks come from a stage image laid
//    out once per call by a first launch; the producer streams them by
//    bulk copy onto the mbarrier ring of f32_wgmma.cuh (4 stages), the
//    warpgroup walks them with two chunks' products in flight (up to K 64;
//    runs of 4, all waited for by each run's end: ptxas serializes every
//    wgmma of a loop that carries one in flight across its back edge).  Chunks of N = 64, not 128: two
//    accumulators of 32 values fit the registers of two blocks per SM
//    beside the 36 of split h, and the ring four stages in under half the
//    SM's shared memory.
//  - While chunk c + 1's products run, chunk c's epilogue: a U chunk adds
//    its channels' terms to t in registers (each thread holds the same q of
//    every channel, lowrank_wgmma.cuh); a V chunk gives its channels' msg as
//    per-thread partials and one quad shuffle.  b3 (the image's padded
//    copy) is read through L1.
//  - Each warp gathers its own 16 rows of x (cp.async), the next tile's
//    while this tile's messages scatter.  The scatter is B1's: a segmented
//    sum over receiver-sorted slots in CompactS form (tiles of padding only
//    skipped, by the producer too), the 64 x 64 S product in dense form.
//    Each part writes its own [64, c_out] partial; the wrapper sums the
//    partials in a fixed order.  No atomics: two launches give the same
//    bits.
//
// Bound.  Per real slot 2 K r (c_in + c_out) operations for uv plus 4 r c
// for t and msg, against (K + c_in) 4 + 8 bytes: bounded by operations, on
// the tensor cores six bf16 passes at 989 TFLOP/s (against float32 FMAs at
// 67).  The padded instance does rp / r of that work, so it reaches at
// most r / rp of the bound.  What stands in the way: the ring's per-stage
// barriers and the epilogues on the CUDA cores, which the second
// accumulator hides only in part; the split of h before each tile's walk;
// the scatter.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_lowrank_f32_wgmma.so
//        fused_edge_conv_lowrank_f32_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lowrank_f32_wgmma.cuh"

namespace {

using namespace lowrank_f32;

constexpr int kRows = 64;  // receiver rows per block (rows_blk)
constexpr int kThreads = kWarpgroup + 32;  // consumers + the producer warp

// Byte offsets of the shared memory: the 2 kRing mbarriers, the ring of
// stages ([3][N][sd] bf16 each), past a depth of 64 split h's parts
// [3][64][dp] bf16, the x tile [64][xs] and the message tile [64][ms] f32
// (odd strides: the 8 rows a warp reads at one column fall in 8 banks), the
// part's row sums [64][c_out] and the tile's slot_rows.  At width 48, K 48,
// rank 16: 111 KB (two blocks per SM); at 128, rank 64: 198 KB.
//
// Wide (a K, c_in or c_out past 128; lowrank_f32_wgmma.cuh wide_dims): the
// x and message tiles share one [64][max(c_in, c_out) | 1] tile (a row of
// messages is written only by the quad that read that row of x, after its
// last U chunk; the next tile's x rows land after the scatter), and the
// part sums are added into the part's partial in device memory, each entry
// by one thread in tile order.  The ring (4 stages of 32 deep past a K of
// 64), h's parts past 64 and the shared tile: 214 KB at K = c_in = c_out =
// 256 (ranks 8, 16, 32, 64; 195 KB at 40), 160 KB at K 256 with widths 48,
// 140 KB at K 48 with widths 256 (rank 16), against the 232 KB a block may
// take.
struct Layout {
  int n, dp, sd, xs, ms;
  bool wide;
  long stage, ring, a, x, m, acc, srow, total;
  // wide: wide_dims(K, c_in, c_out), the instance's
  __host__ __device__ Layout(int K, int c_in, int c_out, int r, bool wide_) {
    n = chunk_cols(r);
    dp = image_depth(K);
    sd = stage_depth(dp);
    wide = wide_;
    xs = c_in | 1;
    ms = c_out | 1;
    if (wide) xs = ms = (c_in > c_out ? c_in : c_out) | 1;
    stage = 3 * 2L * n * sd;
    ring = 128;
    a = ring + kRing * stage;
    x = a + (dp > 64 ? 3 * 2L * kTile * dp : 0);
    m = wide ? x : x + 4L * kTile * xs;
    acc = m + 4L * kTile * ms;
    srow = wide ? acc : acc + 4L * kRows * c_out;  // wide: no part sums
    total = srow + 4L * kTile;
  }
};

// R8 = R / 8 (R the padded rank, or past 64 the slab's 64), S = K rounded
// up to 16, over 16 (h's k16 steps) up to 4, kDeep past it (h's parts in
// shared memory); kWide: the wide layout (a separate instance, so that the
// one up to 128 stays as it was); kSlab: a rank past 64 in `slabs` slabs
// (R8 = 8).
template <int R8, int S, bool kWide, bool kSlab>
__global__ void __launch_bounds__(kThreads, kMinBlocks<R8, S>)
lowrank_fwd_f32_wgmma(const float* __restrict__ h, const float* __restrict__ x,
                      const int* __restrict__ senders_perm,
                      const bf16* __restrict__ image,
                      const float* __restrict__ b3,
                      const int* __restrict__ slot_rows,
                      const float* __restrict__ row_weight,
                      const float* __restrict__ s_dense,
                      float* __restrict__ out, int blk, int K, int c_in,
                      int c_out, int n_nodes, int slabs) {
  constexpr int R = 8 * R8, N = kN<R8>, G = N / R;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(K, c_in, c_out, R, kWide);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRing;
  unsigned char* ring = smem + L.ring;
  const int b = blockIdx.x, part = blockIdx.y, parts = gridDim.y;
  const int tiles = blk / kTile;
  const int t_lo = part * tiles / parts, t_hi = (part + 1) * tiles / parts;
  const long row_base = static_cast<long>(b) * kRows;
  const long blk0 = static_cast<long>(b) * blk;
  const bool compact = s_dense == nullptr;
  const int lane = threadIdx.x % 32;
  const int n_u = cdiv(c_in, G), n_c = n_u + cdiv(c_out, G);
  const int ns = kSlab ? slabs : 1;

  // the first tile from t on (t_hi if none) that holds a real slot (every
  // tile in the dense form): each warp finds it by itself, so that the
  // producer and the consumers walk the same tiles
  auto next_real = [&](int t) {
    if (!compact) return t;
    for (; t < t_hi; ++t) {
      const int* sr = slot_rows + blk0 + static_cast<long>(t) * kTile;
      if (__any_sync(0xffffffffu, sr[lane] >= 0 || sr[lane + 32] >= 0)) break;
    }
    return t;
  };

  if (threadIdx.x == 0) ring_init(full, empty);
  __syncthreads();

  // ---- producer: the ns n_c D stages of every real tile of the part ----
  if (threadIdx.x >= kWarpgroup) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(image);
    uint32_t j = 0;
    for (int t = next_real(t_lo); t < t_hi; t = next_real(t + 1)) {
      if (lane == 0)
        produce(full, empty, ring, src, static_cast<uint32_t>(L.stage),
                ns * n_c * (L.dp / L.sd) - 1, j);
      __syncwarp();
    }
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x, warp = tid / 32;
  const int r0 = acc_row(0);  // this thread's rows: r0 and r0 + 8
  const int xs = L.xs, ms = L.ms;
  float* x_sm = reinterpret_cast<float*>(smem + L.x);
  float* m_sm = reinterpret_cast<float*>(smem + L.m);
  float* acc_sm = reinterpret_cast<float*>(smem + L.acc);
  int* srow = reinterpret_cast<int*>(smem + L.srow);
  // the part's partial (the output itself when parts == 1); wide: the part
  // sums themselves (formed where it is used, so that no register holds it
  // across the walk)
  auto partial = [&]() {
    return out + (static_cast<long>(part) * gridDim.x * kRows + row_base) * c_out;
  };
  for (int e = tid; e < kRows * c_out; e += kWarpgroup)
    (kWide ? partial() : acc_sm)[e] = 0.f;
  bf16* a_sm = reinterpret_cast<bf16*>(smem + L.a);
  const uint64_t d0 = desc(ring, L.sd);
  const uint32_t dstage = static_cast<uint32_t>(L.stage >> 4);
  const uint32_t dpart = dstage / 3;
  const int ru = R * c_in;
  uint32_t j = 0;  // the ring's step, counted as the producer counts it

  // this warp's 16 rows of the x tile x[senders_perm] by cp.async (zeros
  // for a sender outside the graph); nothing waits for them here
  auto fetch_x = [&](int t) {
    const long tile = blk0 + static_cast<long>(t) * kTile + 16 * warp;
    int src = lane < 16 ? senders_perm[tile + lane] : -1;
    if (src < 0 || src >= n_nodes) src = -1;
    for (int e0 = 0; e0 < 16 * c_in; e0 += 32) {
      const int e = e0 + lane, s = e / c_in, i = e - s * c_in;
      const int sr = __shfl_sync(0xffffffffu, src, s < 16 ? s : 0);
      if (e < 16 * c_in)
        cp_async4(x_sm + (16 * warp + s) * xs + i,
                  sr >= 0 ? x + static_cast<long>(sr) * c_in + i : x,
                  sr >= 0 ? 4 : 0);
    }
    cp_async_commit();
  };

  int t = next_real(t_lo);
  if (t < t_hi) fetch_x(t);
  while (t < t_hi) {
    const long tile = blk0 + static_cast<long>(t) * kTile;
    // h's parts at this thread's fragment rows and columns (past a depth of
    // 64: in shared memory)
    uint32_t ha[3][S > 4 ? 1 : S][4];
    if constexpr (S > 4) {
      split_smem(a_sm, h + tile * K, K, K, L.dp);
      fence_async_smem();
    } else {
      split_rows<S>(ha, h + tile * K, K, K);
    }
    cp_async_wait_all();
    warpgroup_sync(0);  // the tile's x rows have landed, and every thread is
                        // done with the last tile's scatter
    if (compact && tid < kTile) srow[tid] = slot_rows[tile + tid];
    const int next = next_real(t + 1);

    // scatter the tile's (slab's) messages into the part's row sums
    auto scatter = [&](float* sums) {
      if (compact) {
        for (int o = tid; o < c_out; o += kWarpgroup) {
          int cur = -1;
          float run = 0.f;
          for (int s = 0; s < kTile; ++s) {
            const int r = srow[s];
            if (r != cur) {
              if (cur >= 0) sums[cur * c_out + o] += run;
              cur = r;
              run = 0.f;
            }
            if (r >= 0) run += m_sm[s * ms + o];
          }
          if (cur >= 0) sums[cur * c_out + o] += run;
        }
      } else {
        const float* s_tile = s_dense + row_base * blk + static_cast<long>(t) * kTile;
        for (int e = tid; e < kRows * c_out; e += kWarpgroup) {
          const int r = e / c_out, o = e - r * c_out;
          float v = 0.f;
          for (int s = 0; s < kTile; ++s)
            v = fmaf(s_tile[static_cast<long>(r) * blk + s], m_sm[s * ms + o], v);
          sums[e] += v;
        }
      }
    };
    for (int sl = 0; sl < ns; ++sl) {
      // ---- uv chunk by chunk: t from the U chunks, msg from the V chunks
      // (of slab sl: its b3 at b3s) ----
      const float* b3s = b3 + sl * R * (c_in + c_out);
      float tq[2][R8][2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int m = 0; m < R8; ++m) tq[hf][m][0] = tq[hf][m][1] = 0.f;
      auto fin = [&](const float (&acc)[N / 2], int c) {
        if (c < n_u) {  // t[s, q] += x[s, i] U[s, i, q]
          const int i0 = c * G, gc = lesser(G, c_in - i0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g >= gc) continue;
            const float xa = x_sm[r0 * xs + i0 + g];
            const float xb = x_sm[(r0 + 8) * xs + i0 + g];
            const float* bias = b3s + (i0 + g) * R;
#pragma unroll
            for (int u = 0; u < 4 * R8; ++u) {
              const int jj = 4 * R8 * g + u;
              const float uv = acc[jj] + __ldg(bias + q_of<R8>(jj));
              float& tv = tq[(u >> 1) & 1][u >> 2][u & 1];
              tv = fmaf((u >> 1) & 1 ? xb : xa, uv, tv);
            }
          }
        } else {  // msg[s, o] = sum_q V[s, o, q] t[s, q]
          const int o0 = (c - n_u) * G, gc = lesser(G, c_out - o0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g >= gc) continue;
            const float* bias = b3s + ru + (o0 + g) * R;
            float pa = 0.f, pb = 0.f;
#pragma unroll
            for (int u = 0; u < 4 * R8; ++u) {
              const int jj = 4 * R8 * g + u;
              const float v = acc[jj] + __ldg(bias + q_of<R8>(jj));
              if ((u >> 1) & 1)
                pb = fmaf(v, tq[1][u >> 2][u & 1], pb);
              else
                pa = fmaf(v, tq[0][u >> 2][u & 1], pa);
            }
            pa = quad_sum(pa);
            pb = quad_sum(pb);
            if (tid % 4 == 0) {
              m_sm[r0 * ms + o0 + g] = pa;
              m_sm[(r0 + 8) * ms + o0 + g] = pb;
            }
          }
        }
      };
      if constexpr (S > 4) {
        const DeepWalk<N, decltype(fin)> walk{
            desc(a_sm, L.dp), static_cast<uint32_t>(2 * kTile * L.dp >> 4),
            L.dp / L.sd, full, empty, d0, dstage, dpart, lane, fin};
        walk.all(n_c, j);
      } else {
        const Walk<N, S, decltype(fin)> walk{ha, full, empty, d0, dstage,
                                             dpart, lane, fin};
        walk.all(n_c - 1, j);
      }
      const bool last = sl + 1 == ns;
      // this warp is done with its x rows: the next tile's land meanwhile
      // (wide: once the scatter has read the messages that share their tile)
      if (!kWide && last && next < t_hi) fetch_x(next);

      // ---- scatter the slab's messages into the part's row sums ----
      warpgroup_sync(0);
      if constexpr (kWide) {
        scatter(partial());
        warpgroup_sync(0);
        // the next slab's x rows are this tile's again
        const int nx = last ? next : t;
        if (nx < t_hi) fetch_x(nx);
        if (!last) {
          cp_async_wait_all();
          warpgroup_sync(0);
        }
      } else {
        scatter(acc_sm);
        if (!last) warpgroup_sync(0);  // before the next slab's messages
      }
    }
    t = next;
  }
  warpgroup_sync(0);

  // ---- the part's partial: its sums scaled by row_weight in CompactS
  // form ----
  float* dst = partial();
  if (!kWide || compact)
    for (int e = tid; e < kRows * c_out; e += kWarpgroup) {
      const float v = kWide ? dst[e] : acc_sm[e];
      dst[e] = compact ? row_weight[row_base + e / c_out] * v : v;
    }
}

template <int R8, int S, bool kWide, bool kSlab>
cudaError_t launch(const float* h, const float* x, const int* senders_perm,
                   const float* w3, const float* b3, const int* slot_rows,
                   const float* row_weight, const float* s_dense, bf16* image,
                   float* out, int num_blocks, int blk, int K, int c_in,
                   int c_out, int r, int n_nodes, int parts,
                   cudaStream_t stream) {
  constexpr int R = 8 * R8;
  const Layout L(K, c_in, c_out, R, kWide);
  const size_t smem = static_cast<size_t>(L.total);
  const int rp = padded_rank(r), slabs = rp / R;
  auto kernel = lowrank_fwd_f32_wgmma<R8, S, kWide, kSlab>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float* b3p;
  err = launch_lowrank_image(w3, b3, image,
                             slabs * fwd_chunks(L.n / R, c_in, c_out), L.n,
                             L.dp, rp, r, K, c_in, c_out, false, &b3p,
                             stream);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(num_blocks, parts), kThreads, smem, stream>>>(
      h, x, senders_perm, image, b3p, slot_rows, row_weight, s_dense, out,
      blk, K, c_in, c_out, n_nodes, slabs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_conv_lowrank_f32_wgmma_smem_bytes(int K, int c_in, int c_out,
                                                  int r) {
  return Layout(K, c_in, c_out, slab_rank(r),
                wide_dims(K, c_in, c_out)).total;
}

// Blocks one SM holds at once at these widths (-1 if they are not taken).
int fused_edge_conv_lowrank_f32_wgmma_blocks_per_sm(int K, int c_in,
                                                    int c_out, int r) {
  const Layout L(K, c_in, c_out, slab_rank(r), wide_dims(K, c_in, c_out));
  return with_rank_depth(r, K, [&](auto r8, auto s) {
    constexpr int R8 = decltype(r8)::value, S = decltype(s)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    const size_t smem = static_cast<size_t>(L.total);
    return L.wide ? blocks_on_sm(lowrank_fwd_f32_wgmma<R8, S, true, kSlab>,
                                 kThreads, smem)
                  : blocks_on_sm(lowrank_fwd_f32_wgmma<R8, S, false, kSlab>,
                                 kThreads, smem);
  }, -1);
}

// Launches the float32 forward on `stream`: the stage image of w3, then the
// layer.  Pointers are device pointers; h, x, w3, b3, row_weight, s_dense and
// out float32; senders_perm and slot_rows int32; image bfloat16 scratch of
// ops/fused_conv.py:lowrank_image_numel elements, 16-byte aligned.
// Exactly one of s_dense and (slot_rows, row_weight) is non-null.  w3 is
// [K, r*(c_in+c_out)] in the model's column layout; 1 <= K, c_in, c_out <=
// 256 and 1 <= r <= 256.  out is [num_blocks*64, c_out] when parts
// == 1, else the partials [parts, num_blocks*64, c_out].  Returns the
// cudaError_t of the launches (0 on success).
int fused_edge_conv_lowrank_f32_wgmma_forward(
    const void* h, const void* x, const void* senders_perm, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* image, void* out, int num_blocks, int blk,
    int K, int c_in, int c_out, int r, int n_nodes, int parts, void* stream) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      parts < 1 || parts > blk / kTile ||
      reinterpret_cast<uintptr_t>(image) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_dims(K, c_in, c_out);
  return static_cast<int>(with_rank_depth(r, K, [&](auto r8, auto s) {
    constexpr int R8 = decltype(r8)::value, S = decltype(s)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    return (wide ? launch<R8, S, true, kSlab> : launch<R8, S, false, kSlab>)(
        static_cast<const float*>(h), static_cast<const float*>(x),
        static_cast<const int*>(senders_perm), static_cast<const float*>(w3),
        static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
        static_cast<const float*>(row_weight),
        static_cast<const float*>(s_dense), static_cast<bf16*>(image),
        static_cast<float*>(out), num_blocks, blk, K, c_in, c_out, r,
        n_nodes, parts, st);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
