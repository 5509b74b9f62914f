// Fused edge-conditioned conv layer with rank-r factorized edge kernels,
// forward, in bfloat16 on Hopper's tensor cores (wgmma, sm_90a).
//
// Replaces the TPU Pallas kernel
//   fast_eng_super_resolution_tpu/ops/fused_conv.py:_fused_lowrank_jit
// for bfloat16 operands at every rank 1 .. 256 and K, c_in, c_out 1 .. 256
// (fused_edge_conv_lowrank_f32_wgmma.cu is the float32 instance) and
// computes the same function.  Slots are grouped as for the full-rank
// layer: block b holds the slots whose receivers lie in rows [64 b, 64 b +
// 64).  Per slot e:
//
//   uv_e      = h_e w3 + b3                     [r (c_in + c_out)]
//   t_e[q]    = sum_i U_e[i, q] x[senders_perm[e], i]
//   msg_e[o]  = sum_q V_e[o, q] t_e[q]
//   out[r, o] = sum_{e in block(r)} S[r, e] msg_e[o]
//
// with U[i, q] = uv[i r + q], V[o, q] = uv[r c_in + o r + q] (the model's
// column layout) and S dense or given by its CompactS generators.
//
// Numbers.  h, x and w3 arrive as bfloat16 (the plain version,
// ops/fused_conv.py:fused_edge_conv_lowrank_plain, rounds the same three);
// b3, uv, t, msg and every sum are float32.  The tensor cores see only h and
// w3 and accumulate uv in float32; b3 is added to the accumulator, and t,
// msg and the scatter (about 1/49 of the work at width 48, K 48) run on the
// CUDA cores in float32.
//
// Design.  At a rank other than its padded rank rp (8 ceil(r / 8) up to
// 64, 64 ceil(r / 64) past it) a first launch lays out the zero-padded copy
// of w3 at rp (lowrank_wgmma.cuh pad_head), so that the chunks below keep
// their 16-byte loads; the layer then runs at rp, b3's columns copied
// padded from its real ones.  A block
// is one warpgroup and owns one part of one receiver block's slot walk
// (grid (num_blocks, parts), parts from the wrapper's ops/fused_conv.py:
// conv_parts, as B1).  Per 64-slot tile it stages h (the A operand,
// K-major, K padded to 16 with zeros) and the gathered x rows (float32),
// then walks uv in 128-column chunks of whole channels (lowrank_wgmma.cuh):
// each chunk is one m64n128 product over K.  w3's columns (and a chunk's
// b3) stream by cp.async through a ring of three buffers, two chunks ahead
// of the running product, across the part's tiles (ChunkCopy).  A U chunk
// adds its channels' terms to t in registers (each thread holds the same q
// of every channel); once t is whole, a V chunk gives its channels' msg as
// per-thread partials and one quad shuffle, into a message tile that
// shares its memory with the x tile (x is read by the U chunks only, which
// come first).  The scatter is B1's: a segmented sum over receiver-sorted
// slots in CompactS form (tiles of padding only skipped), the 64 x 64 S
// product in dense form.  Each part writes its own [64, c_out] partial;
// the wrapper sums the partials in a fixed order.  No atomics: two
// launches on the same inputs give the same bits.
//
// Slabs (ranks past 64; lowrank_wgmma.cuh).  Per tile, h is staged once and
// the slabs run in turn, each the rank-64 walk on its slab's columns (the
// ring's sequence runs on from slab to slab and from tile to tile): x
// gathered (again past the first slab: the message tile holds the last
// slab's messages), t in registers, the messages, and their scatter into
// the part's row sums, slab after slab in order.  The shared memory stays
// the rank-64 instance's; the x rows are read again per slab, from L2
// (64 c_in bf16 per tile and slab, against the slab's K 64 (c_in + c_out)
// of w3).
//
// Shared memory (any rank; Layout, ops/fused_conv.py:lowrank_smem_bytes):
// h [64][K], the ring, the x / message tile [64][max(c_in, c_out) | 1]
// f32 and the part sums [64][c_out] f32.  Up to a K of 128 a ring buffer
// holds a whole chunk [128][K] bf16 (70 KB at width 48, K 48, three blocks
// per SM; 183 KB at 128, one).  Past a K of 128 the three whole chunks
// would take 194 KB at 256, so each buffer holds 64 deep and a chunk runs
// as K / 64 stages into one accumulator (lowrank_wgmma.cuh staged,
// product_stage), 51 KB of ring: 215 KB at K = c_in = c_out = 256, 109 KB
// at K 256 with widths 48, 176 KB at K 48 with widths 256 (whole chunks)
// against the 232 KB a block may take (kSmemMax).
//
// Bound.  Per real slot 2 (K+1) r (c_in + c_out) operations for uv plus
// 4 r c for t and msg, against (K + c_in) 2 + 8 bytes: at width 48, rank 16
// ~150 kFLOP against ~200 B, far above the card's ridge, so it is bounded by
// operations on the tensor cores.  The padded instance does rp / r of that
// work, so it reaches at most r / rp of the bound.  What stands in the way
// here: each tile re-reads w3 from L2 (K rp (c_in + c_out) 2 bytes), one
// product at a time is waited on, and the t / msg epilogues run on the CUDA
// cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_edge_conv_lowrank_wgmma.so
//        fused_edge_conv_lowrank_wgmma.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lowrank_wgmma.cuh"

namespace {

using namespace lowrank_wgmma;

constexpr int kRows = 64;  // receiver rows per block (rows_blk)

// Byte offsets of the shared-memory regions: h, the ring of kBufs
// buffers (a w3 chunk [128][kp] bf16, then its b3 [128] f32), the x tile
// [64][xs] f32 (later the message tile [64][ms]), the part's row sums and
// the tile's slot_rows and senders.  The float32 x and message tiles have
// an odd row stride, so that the 8 rows a warp reads at one column fall in
// 8 different banks.
struct Layout {
  int kp, bd, xs, ms;
  long buf, ring, xm, acc, srow, total;
  // deep: the chunks in stages (fwd_deep)
  __host__ __device__ Layout(int K, int c_in, int c_out, bool deep) {
    kp = round_up(K, 16);
    bd = deep ? kStage : kp;  // a buffer's depth
    xs = c_in | 1;
    ms = c_out | 1;
    buf = 2L * kCols * bd + 4L * kCols;
    ring = 2L * kTile * kp;                  // a: h [64][kp]
    xm = ring + kBufs * buf;
    acc = xm + 4L * kTile * (xs > ms ? xs : ms);
    srow = acc + 4L * kRows * c_out;         // part sums [64][c_out] f32
    total = srow + 4L * 2 * kTile;           // slot_rows, senders of the tile
  }
};

// Whether B3 walks each chunk in stages of 64 (K past 128).
__host__ __device__ constexpr bool fwd_deep(int K) {
  return staged(round_up(K, 16));
}

// kDeep: K past 128, each chunk in stages of 64 (a separate instance, so
// that the one up to 128 stays the whole-chunk walk); kSlab: a rank past
// 64 in slabs (R8 = 8).
template <int R8, bool kDeep, bool kSlab>
__global__ void __launch_bounds__(kWarpgroup)
lowrank_fwd_wgmma(const bf16* __restrict__ h, const bf16* __restrict__ x,
                  const int* __restrict__ senders_perm,
                  const bf16* __restrict__ w3, const float* __restrict__ b3,
                  const int* __restrict__ slot_rows,
                  const float* __restrict__ row_weight,
                  const float* __restrict__ s_dense, float* __restrict__ out,
                  int blk, int K, int c_in, int c_out, int rank,
                  int n_nodes) {
  constexpr int R = 8 * R8, G = kCols / R;  // padded rank, channels per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(K, c_in, c_out, kDeep);
  const int kp = L.kp, bd = L.bd, xs = L.xs, ms = L.ms;
  bf16* a_sm = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L.ring;
  float* x_sm = reinterpret_cast<float*>(smem + L.xm);
  float* m_sm = x_sm;
  float* acc_sm = reinterpret_cast<float*>(smem + L.acc);
  int* srow = reinterpret_cast<int*>(smem + L.srow);
  int* ssrc = srow + kTile;

  const int tid = threadIdx.x;
  const bool writer = tid % 4 == 0;
  const int b = blockIdx.x, part = blockIdx.y, parts = gridDim.y;
  const int tiles = blk / kTile;
  const int t_lo = part * tiles / parts, t_hi = (part + 1) * tiles / parts;
  const long row_base = static_cast<long>(b) * kRows;
  const bool compact = s_dense == nullptr;
  const int ru = R * c_in;
  const int n_u = (c_in + G - 1) / G, n_c = n_u + (c_out + G - 1) / G;
  const int ns = kDeep ? (kp + bd - 1) / bd : 1;  // stages per chunk
  const int slabs = kSlab ? padded_rank(rank) / R : 1;
  const bool x_vec = c_in % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  for (int e = tid; e < kRows * c_out; e += kWarpgroup) acc_sm[e] = 0.f;

  // chunk c: the U chunks (input channels G c ..), then the V chunks
  auto chunk = [&](int c) {
    const bool u = c < n_u;
    const int ch0 = (u ? c : c - n_u) * G;
    const int gc = min(G, (u ? c_in : c_out) - ch0);
    return Chunk{kUv, (u ? 0 : ru) + ch0 * R, gc * R, kp, K};
  };
  const int n_p = n_c * ns;  // pieces per slab
  const int n_t = n_p * slabs;  // per tile
  // piece n of a tile's walk: stage n % ns of chunk n / ns (kDeep), else
  // chunk n; kSlab: of slab n / n_p
  auto piece = [&](int n) {
    int sl = 0;
    if constexpr (kSlab) {
      sl = n / n_p;
      n -= sl * n_p;
    }
    Chunk c = chunk(kDeep ? n / ns : n);
    if constexpr (kDeep) c = stage_of(c, n % ns, bd);
    if constexpr (kSlab) c.s0 = sl * R;
    return c;
  };
  // w3's chunks stream through the ring in one sequence of steps (one
  // piece each) over the part's tiles: step n reads buffer n % 3 while the
  // pieces of steps n + 1 and n + 2 land in the other two
  auto buf = [&](int n) {
    return reinterpret_cast<bf16*>(ring + (n % kBufs) * L.buf);
  };
  auto bias = [&](int n) {
    return reinterpret_cast<float*>(ring + (n % kBufs) * L.buf + 2L * kCols * bd);
  };
  const ChunkCopy<R8, kSlab> cc(w3, b3, c_in, c_out, rank);
  cc.start(buf(0), bias(0), piece(0));
  cc.start(buf(1), bias(1), piece(1));
  int step = 0;

  const int r0 = acc_row(0);
  for (int t = t_lo; t < t_hi; ++t) {
    const long tile = static_cast<long>(b) * blk + static_cast<long>(t) * kTile;
    int real = !compact;  // CompactS: the tile's slots vote
    if (tid < kTile) {
      const int src = senders_perm[tile + tid];
      ssrc[tid] = src >= 0 && src < n_nodes ? src : -1;
      if (compact) {
        srow[tid] = slot_rows[tile + tid];
        real = srow[tid] >= 0;
      }
    }
    if (!__syncthreads_or(real)) continue;  // padding only (CompactS)

    // ---- stage h (A); per slab, the gathered x rows (float32; 16-byte
    // pieces of the rows where they are aligned, every load of a thread in
    // flight); the first step's barrier publishes them ----
    stage_rows(a_sm, h + tile * K, K, kp);
    for (int sl = 0; sl < slabs; ++sl) {
      if (x_vec) {
        const int per = c_in / 8;
#pragma unroll 4
        for (int p = tid; p < kTile * per; p += kWarpgroup) {
          const int s = p / per, i = 8 * (p - s * per), src = ssrc[s];
          Pack8 v;
          v.u = src >= 0 ? *reinterpret_cast<const uint4*>(
                               x + static_cast<long>(src) * c_in + i)
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int u = 0; u < 8; ++u) x_sm[s * xs + i + u] = __bfloat162float(v.e[u]);
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < kTile * c_in; e += kWarpgroup) {
          const int s = e / c_in, i = e - s * c_in, src = ssrc[s];
          x_sm[s * xs + i] =
              src >= 0 ? __bfloat162float(x[static_cast<long>(src) * c_in + i]) : 0.f;
        }
      }

      // t of this thread's rows r0, r0 + 8 at its 2 R8 values of q
      float tq[2][R8][2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int m = 0; m < R8; ++m) tq[hf][m][0] = tq[hf][m][1] = 0.f;

      for (int c = 0; c < n_c; ++c) {
        float acc[kCols / 2];
        if constexpr (kDeep) {
          for (int st = 0; st < ns; ++st, ++step) {
            pieces_wait<1>();  // this step's piece has landed
            fence_async_smem();
            __syncthreads();
            product_stage(acc, a_sm, kp, st * bd, buf(step),
                          min(bd, kp - st * bd), st > 0);
            // the piece two steps on (this tile's, or the next one's), into
            // the buffer that step - 1's finished product read
            cc.start(buf(step + 2), bias(step + 2),
                     piece((sl * n_p + c * ns + st + 2) % n_t));
            wait_all();
            fence_operand(acc);
          }
        } else {
          pieces_wait<1>();  // this step's chunk has landed
          fence_async_smem();
          __syncthreads();
          product<kCols, 1>(acc, a_sm, buf(step), kp);
          // the chunk two steps on (this tile's, or the next one's), into the
          // buffer that step - 1's finished product read
          cc.start(buf(step + 2), bias(step + 2),
                   piece((sl * n_p + c + 2) % n_t));
          wait_all();
          fence_operand(acc);
          ++step;
        }
        const float* bs = bias(step - 1);
        if (c < n_u) {  // t[s, q] += x[s, i] U[s, i, q]
          const int i0 = c * G, gc = min(G, c_in - i0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g >= gc) continue;
            const float xa = x_sm[r0 * xs + i0 + g];
            const float xb = x_sm[(r0 + 8) * xs + i0 + g];
#pragma unroll
            for (int u = 0; u < 4 * R8; ++u) {
              const int j = 4 * R8 * g + u;
              const float uv = acc[j] + bs[g * R + q_of<R8>(j)];
              tq[(u >> 1) & 1][u >> 2][u & 1] += ((u >> 1) & 1 ? xb : xa) * uv;
            }
          }
        } else {  // msg[s, o] = sum_q V[s, o, q] t[s, q]
          const int o0 = (c - n_u) * G, gc = min(G, c_out - o0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g >= gc) continue;
            float pa = 0.f, pb = 0.f;
#pragma unroll
            for (int u = 0; u < 4 * R8; ++u) {
              const int j = 4 * R8 * g + u;
              const float v = (acc[j] + bs[g * R + q_of<R8>(j)]) *
                              tq[(u >> 1) & 1][u >> 2][u & 1];
              if ((u >> 1) & 1) pb += v; else pa += v;
            }
            pa = quad_sum(pa);
            pb = quad_sum(pb);
            if (writer) {
              m_sm[r0 * ms + o0 + g] = pa;
              m_sm[(r0 + 8) * ms + o0 + g] = pb;
            }
          }
        }
      }
      __syncthreads();  // the tile's (slab's) messages are whole

      // ---- scatter the tile's (slab's) messages into the part's row sums ----
      if (compact) {
        for (int o = tid; o < c_out; o += kWarpgroup)
          for (int s = 0; s < kTile; ++s) {
            const int r = srow[s];
            if (r >= 0) acc_sm[r * c_out + o] += m_sm[s * ms + o];
          }
      } else {
        const float* s_tile = s_dense + row_base * blk + static_cast<long>(t) * kTile;
        for (int e = tid; e < kRows * c_out; e += kWarpgroup) {
          const int r = e / c_out, o = e - r * c_out;
          float v = 0.f;
          for (int s = 0; s < kTile; ++s)
            v += s_tile[static_cast<long>(r) * blk + s] * m_sm[s * ms + o];
          acc_sm[e] += v;
        }
      }
      __syncthreads();  // the next tile (slab) overwrites srow and the operands
    }
  }
  pieces_wait<0>();  // the copies ahead of the last step

  // ---- the part's partial (the output itself when parts == 1) ----
  float* dst = out + (static_cast<long>(part) * gridDim.x * kRows + row_base) * c_out;
  for (int e = tid; e < kRows * c_out; e += kWarpgroup) {
    const float v = acc_sm[e];
    dst[e] = compact ? row_weight[row_base + e / c_out] * v : v;
  }
}

template <int R8, bool kDeep, bool kSlab>
cudaError_t launch(const void* h, const void* x, const void* senders_perm,
                   const void* w3, const void* b3, const void* slot_rows,
                   const void* row_weight, const void* s_dense, void* pad,
                   void* out, int num_blocks, int blk, int K, int c_in,
                   int c_out, int r, int n_nodes, int parts,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout(K, c_in, c_out, kDeep).total);
  auto kernel = lowrank_fwd_wgmma<R8, kDeep, kSlab>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bf16* w = static_cast<const bf16*>(w3);
  if (r != padded_rank(r)) {  // the zero-padded copy of w3 at rank rp
    err = launch_pad_head(w, static_cast<bf16*>(pad), K, c_in + c_out, r,
                          stream);
    if (err != cudaSuccess) return err;
    w = static_cast<const bf16*>(pad);
  }
  kernel<<<dim3(num_blocks, parts), kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(x),
      static_cast<const int*>(senders_perm), w,
      static_cast<const float*>(b3), static_cast<const int*>(slot_rows),
      static_cast<const float*>(row_weight),
      static_cast<const float*>(s_dense), static_cast<float*>(out), blk, K,
      c_in, c_out, r, n_nodes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long fused_edge_conv_lowrank_wgmma_smem_bytes(int K, int c_in, int c_out,
                                              int r) {
  return Layout(K, c_in, c_out, fwd_deep(K)).total;
}

// Blocks one SM holds at once at these widths (-1 if they are not taken).
int fused_edge_conv_lowrank_wgmma_blocks_per_sm(int K, int c_in, int c_out,
                                                int r) {
  const bool deep = fwd_deep(K);
  const size_t smem = static_cast<size_t>(Layout(K, c_in, c_out, deep).total);
  return with_rank(r, [&](auto r8) {
    constexpr int R8 = decltype(r8)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    return deep ? blocks_per_sm(lowrank_fwd_wgmma<R8, true, kSlab>, smem)
                : blocks_per_sm(lowrank_fwd_wgmma<R8, false, kSlab>, smem);
  }, -1);
}

// Launches the bfloat16 forward on `stream`.  Pointers are device pointers;
// h, x and w3 bfloat16; b3, row_weight, s_dense and out float32;
// senders_perm and slot_rows int32.  Exactly one of s_dense and (slot_rows,
// row_weight) is non-null.  w3 is [K, r*(c_in+c_out)] in the model's column
// layout; 1 <= K, c_in, c_out <= 256 and 1 <= r <= 256.  At a rank other
// than its padded rank rp (8*ceil(r/8) up to 64, 64*ceil(r/64) past it),
// pad is bfloat16 scratch of K*rp*(c_in+c_out) elements, 16-byte aligned
// (ops/fused_conv.py:lowrank_pad_numel; unused otherwise).  out is
// [num_blocks*64, c_out] when parts == 1, else the partials [parts,
// num_blocks*64, c_out].  Returns the cudaError_t of the launch (0 on
// success).
int fused_edge_conv_lowrank_wgmma_forward(
    const void* h, const void* x, const void* senders_perm, const void* w3,
    const void* b3, const void* slot_rows, const void* row_weight,
    const void* s_dense, void* pad, void* out, int num_blocks, int blk, int K,
    int c_in, int c_out, int r, int n_nodes, int parts, void* stream) {
  if (K < 1 || K > kMaxDim || c_in < 1 || c_in > kMaxDim || c_out < 1 ||
      c_out > kMaxDim || blk % kTile != 0 || blk < kTile || num_blocks < 1 ||
      parts < 1 || parts > blk / kTile ||
      (r != padded_rank(r) &&
       (pad == nullptr || reinterpret_cast<uintptr_t>(pad) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool deep = fwd_deep(K);
  return static_cast<int>(with_rank(r, [&](auto r8) {
    constexpr int R8 = decltype(r8)::value;
    constexpr bool kSlab = decltype(r8)::slab;
    return (deep ? launch<R8, true, kSlab> : launch<R8, false, kSlab>)(
        h, x, senders_perm, w3, b3, slot_rows, row_weight, s_dense, pad, out,
        num_blocks, blk, K, c_in, c_out, r, n_nodes, parts, s);
  }, cudaErrorInvalidValue));
}

}  // extern "C"
