// Tensor-core (wgmma) pieces shared by the bfloat16 rank-r kernels: B3's
// forward (fused_edge_conv_lowrank_wgmma.cu) and B4's rows kernel
// (fused_edge_conv_lowrank_bwd_wgmma.cu); the rank dispatch, the padded
// column map and the slab map also serve the float32 pair
// (lowrank_f32_wgmma.cuh).
//
// Padded rank.  Every kernel runs at the padded rank rp of r (padded_rank):
// 8 ceil(r / 8) up to 64 (an instance per R8 = rp / 8 = 1 .. 8,
// with_rank), 64 ceil(r / 64) past it (ranks 65 .. 256), the real rank r
// beside it at run time: channel i's columns are i rp .. i rp + rp - 1 of
// a padded head whose column i rp + q is the model's column i r + q for q
// < r, and zero for q >= r (w3 and b3 alike; real_col below).  With the
// padded columns zero, uv, t, dt and duv are zero there, so the rank-r
// result is the rank-rp instance's on the zero-padded head; dw3 and db3 go
// back to the model's columns only.  The bfloat16 kernels read a padded
// copy of w3 that pad_head lays out once per call (at a rank other than
// rp), so that every chunk still loads in 16-byte pieces; b3's columns are
// copied padded from its real ones, chunk by chunk.
//
// Slabs.  Past a rank of 64 a kernel runs rp / 64 slabs, one after the
// other inside each tile, on the R8 = 8 instance's walk with a template
// flag of its own (kSlab, so that the instances up to 64 keep their code):
// slab s is the rank-64 layer on the head's columns i rp + 64 s .. i rp +
// 64 s + 63 of every channel i (slab_col).  Every term splits over slabs
// exactly: t and dt of q in slab s depend on slab s's columns alone, msg,
// dx_src and dh are sums over the slabs of each slab's terms (added in
// slab order, so that repeats give the same bits), and duv, dw3 and db3
// fall on disjoint columns.  t and dt of one slab at a time sit in
// registers, as at rank 64.
//
// Chunks.  Both kernels run m64n128k16 products whose B operand is a
// 128-column chunk of the (padded) edge MLP's head w3 [K, rp (c_in +
// c_out)] (column layout: U[i, q] = uv[i rp + q], V[o, q] = uv[rp c_in + o
// rp + q]), read in one of three ways:
//
//   kUv: uv columns lo .. lo + 127 over depth k < K          (uv = h w3)
//   kP:  (k, q) columns lo .. over depth i < c_in, the entry
//        w3[k, i rp + q]: W3U, so that P = x_src @ W3U
//   kQ:  the same over depth o < c_out, w3[k, rp c_in + o rp + q]: W3V
//
// A chunk holds whole channels (or whole k for kP/kQ): G = floor(128 / rp)
// of them, cw = (channels) rp columns (128 at rp 8, 16, 32 and 64; 120 at
// 24 and 40, 96 at 48, 112 at 56); columns past cw and depth rows past the
// real depth are staged as zeros.  With rp a multiple of 8, 8 consecutive
// columns of one depth row are 16 contiguous bytes of w3 in all three
// readings, so a chunk copies in 16-byte pieces into the MN-major layout of
// wgmma_tile.cuh (columns contiguous).  ChunkCopy issues them by cp.async
// into a ring of three buffers, two steps ahead of the running product, so
// that they land while it runs and cost no registers (at K, c_in or c_out
// 128 a chunk is 16 pieces a thread); a kUv chunk's buffer also takes its
// 128 columns of b3, padded, which the epilogue adds.
//
// Stages.  Up to a depth of 128 a buffer holds a whole chunk [128][depth]
// and each chunk is one product.  Past it three such buffers alone would
// take 194 KB at a depth of 256, so a buffer holds [128][kStage] and a
// chunk of depth d runs as ceil(d / 64) stages, each a product of its 64
// depth rows into the chunk's one accumulator (product_stage), waited for
// before the next stage's, so that no product is in flight across a loop's
// back edge (staged; such kernels are instances of their own).  A stage is
// one step of the ring: the buffer of each step of a kUv chunk takes the
// chunk's b3 again.  ptxas still serializes these instances' wgmma
// (C7520), the ones up to 128 not.
//
// Accumulator -> (channel, q).  Value j of a thread's m64n128 accumulator
// sits at column 8 (j / 4) + 2 (lane % 4) + j % 2 (wgmma_tile.cuh).  With
// rp = 8 R8, column group cg = j / 4 is channel g = cg / R8 of the chunk at
// q = 8 (cg % R8) + 2 (lane % 4) + j % 2.  So every thread holds the same
// 2 R8 values of q for every channel of a chunk, for its two rows: a sum
// over channels into a per-slot vector of rp (t, dt) accumulates in its
// registers, and a sum over q (msg, dx_src, dh) is a per-thread partial plus
// a quad shuffle.  q_of / channel_of below spell it out;
// tests/test_torch_lowrank_wgmma_host.py checks the mapping against plain
// indexing.

#pragma once

#include "wgmma_tile.cuh"

namespace lowrank_wgmma {

using namespace wgmma_tile;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;    // slots per tile
constexpr int kCols = 128;   // columns per chunk
constexpr int kMaxDim = 256;  // K, c_in, c_out <= 256
constexpr int kBufs = 3;      // chunks (stages) in the ring of B buffers
constexpr int kStage = 64;    // a stage's depth past a depth of 128
constexpr int kSlabRank = 64;  // a slab's rank (ranks past 64)
constexpr int kMaxRank = 256;  // r <= 256

// Whether chunks of depth up to dmax (a multiple of 16) run in stages of
// kStage (past 128) rather than whole.
__host__ __device__ constexpr bool staged(int dmax) { return dmax > 128; }

enum ChunkKind { kUv = 0, kP = 1, kQ = 2 };

// The padded rank of r: 8 ceil(r / 8) up to 64, 64 ceil(r / 64) past it.
__host__ __device__ constexpr int padded_rank(int r) {
  return r <= kSlabRank ? (r + 7) / 8 * 8
                        : (r + kSlabRank - 1) / kSlabRank * kSlabRank;
}

// The rank of the instance that runs r: rp up to 64, a slab's past it.
__host__ __device__ constexpr int slab_rank(int r) {
  return padded_rank(r) < kSlabRank ? padded_rank(r) : kSlabRank;
}

// The head's column (padded to rp) of column c of slab s's head at rank R
// (the slab rank): channel c / R, q = R s + c % R.  Up to rank 64 (R = rp,
// s = 0) the column itself.
__host__ __device__ __forceinline__ int slab_col(int c, int s, int R, int rp) {
  const int ch = c / R;
  return ch * rp + s * R + (c - ch * R);
}

// The model's column of padded column c of a head at rank r padded to rp
// (channel c / rp, q = c % rp), or -1 for a padded column (q >= r).
__host__ __device__ __forceinline__ int real_col(int c, int rp, int r) {
  const int ch = c / rp, q = c - ch * rp;
  return q < r ? ch * r + q : -1;
}

// Channel (or k) of the chunk and q that accumulator value j of this thread
// holds, for r = 8 R8.
template <int R8>
__device__ __forceinline__ int channel_of(int j) {
  return (j >> 2) / R8;
}
template <int R8>
__device__ __forceinline__ int q_of(int j) {
  return 8 * ((j >> 2) % R8) + 2 * (threadIdx.x % 4) + (j & 1);
}

// Eight bf16 values as one 16-byte piece.
union Pack8 {
  uint4 u;
  bf16 e[8];
};

struct Chunk {
  int kind;    // ChunkKind
  int lo;      // first column (kUv: of uv; kP, kQ: of the (k, q) columns)
  int cw;      // real columns, a multiple of 8
  int depth;   // padded depth (of the stage), a multiple of 16
  int real;    // real depth: K, c_in or c_out
  int d0 = 0;  // the stage's first depth row
  int s0 = 0;  // the slab's first q (64 s; past rank 64 only)
};

// Stage st of chunk c in buffers of depth bd (kStage): its depth rows
// st bd .. , at most bd of them.
__device__ __forceinline__ Chunk stage_of(Chunk c, int st, int bd) {
  c.d0 = st * bd;
  c.depth = min(bd, c.depth - c.d0);
  return c;
}

// Copies of 16 bytes (`bytes` 16) or of 4 (`bytes` 4) from global to
// shared memory that run while the thread goes on (cp.async through L1, so
// that the blocks on one SM share the w3 chunks they all read); with `fill`
// false they read nothing and write zeros.
template <int bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "n"(bytes), "r"(fill ? bytes : 0)
               : "memory");
}

// A chunk on its way from w3 into a B operand of the ring: start(buf,
// bias, c) issues chunk c's pieces (and a kUv chunk's 128 padded b3 values
// into `bias`) and closes one group of this thread's copies
// (pieces_wait counts them); nothing waits for them here.  Thread t takes
// the pieces of columns 8 (t / 8) .. at depth rows 8 m + t % 8: 8
// consecutive threads write 128 contiguous bytes of the MN-major operand
// (no bank conflict), and each 32-byte sector of w3 is read by two threads
// of a warp.  Pieces outside the chunk's real columns or depth are zeros;
// pieces past its padded depth are not written.  When w3 is not 16-byte
// aligned, the pieces are copied element by element before start returns.
// kSlab (R8 = 8 past rank 64): the chunk's columns are those of its slab
// (c.s0 = 64 s) in a head padded to rp = padded_rank(rank), slab_col.
template <int R8, bool kSlab = false>
struct ChunkCopy {
  static constexpr int kR = 8 * R8;
  const bf16* w3;
  const float* b3;
  int ncol, ru, rank;
  int rp;    // kSlab: the head's padded rank
  bool vec;  // w3 16-byte aligned: one cp.async per piece

  __device__ __forceinline__ ChunkCopy(const bf16* w3_, const float* b3_,
                                       int c_in, int c_out, int rank_)
      : w3(w3_), b3(b3_), ncol(kR * (c_in + c_out)), ru(kR * c_in),
        rank(rank_) {
    if constexpr (kSlab) {
      rp = padded_rank(rank_);
      ncol = rp * (c_in + c_out);
      ru = rp * c_in;
    }
    vec = reinterpret_cast<uintptr_t>(w3) % 16 == 0;
  }

  __device__ __forceinline__ void start(bf16* buf, float* bias,
                                        const Chunk& c) const {
    const int n = 8 * (threadIdx.x / 8);
    // w3's offset of the piece at depth row d: base + d * stride
    long base;
    int stride;
    if (c.kind == kUv) {
      base = c.lo + n;
      if constexpr (kSlab) base = slab_col(c.lo + n, c.s0 / kR, kR, rp);
      stride = ncol;
    } else {
      const int col = c.lo + n, k = col / kR;
      base = static_cast<long>(k) * ncol + (c.kind == kQ ? ru : 0) + col -
             k * kR;
      if constexpr (kSlab) base += c.s0;
      stride = kSlab ? rp : kR;
    }
    const bool col_ok = n < c.cw;
    for (int d = threadIdx.x % 8; d < c.depth; d += 8) {
      bf16* dst = buf + mnmajor(n, d, c.depth);
      const bool ok = col_ok && c.d0 + d < c.real;
      const bf16* src =
          w3 + (ok ? base + static_cast<long>(c.d0 + d) * stride : 0);
      if (vec) {
        copy_async<16>(dst, src, ok);
      } else {
        Pack8 e;
#pragma unroll
        for (int u = 0; u < 8; ++u) e.e[u] = ok ? src[u] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = e.u;
      }
    }
    if (c.kind == kUv) {
      const int t = threadIdx.x;
      int rc = t < c.cw ? real_col(c.lo + t, kR, rank) : -1;
      if constexpr (kSlab)
        rc = t < c.cw ? real_col(slab_col(c.lo + t, c.s0 / kR, kR, rp), rp,
                                 rank)
                      : -1;
      copy_async<4>(bias + t, b3 + (rc >= 0 ? rc : 0), rc >= 0);
    }
    pieces_commit();
  }
};

// 64 rows of `width` bf16 values (row s at src + s * width) as a K-major
// operand of depth `depth` (a multiple of 16) at dst, zeros past width.
// Piece p (8 values) is row 8 (p / (8 per)) + p % 8 at depth 8 ((p / 8) %
// per): 8 consecutive threads write 128 contiguous bytes.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int width, int depth) {
  const bool vec =
      width % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int per = depth / 8;
#pragma unroll 4
  for (int p = threadIdx.x; p < kTile * per; p += kWarpgroup) {
    const int s = p % 8 + 8 * (p / (8 * per)), d = 8 * ((p / 8) % per);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (d < width) {
      const bf16* row = src + static_cast<long>(s) * width + d;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(row);
      } else {
        Pack8 e;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          e.e[u] = d + u < width ? row[u] : __float2bfloat16(0.f);
        v = e.u;
      }
    }
    *reinterpret_cast<uint4*>(dst + kmajor(s, d, depth)) = v;
  }
}

// D (+)= A[:, d0 .. d0 + depth) B as one committed group: A K-major of
// depth a_depth at a, B MN-major [128][depth] at b (one stage of a chunk,
// d0 and depth multiples of 16); the first k16 step overwrites D unless
// `more` (the wgmma's scale-d predicate).  The caller may work on, then
// wait_all() and fence_operand(d).
__device__ __forceinline__ void product_stage(float (&d)[kCols / 2],
                                              const void* a, int a_depth,
                                              int d0, const void* b,
                                              int depth, bool more) {
  const uint64_t da = desc(a, a_depth) + static_cast<uint64_t>(d0);
  const uint64_t db = desc_mn(b, depth);
  fence_operand(d);
  fence();
  for (int s = 0; s < depth / 16; ++s)
    Mma<kCols, 0, 1>::run(d, da + 16 * s, db + 16 * s, s > 0 || more);
  commit();
}

// Sums v over the 4 lanes of a quad (the 4 threads that hold one row's
// columns of an accumulator).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Writes the padded copy of w3 [K, r nch] (nch = c_in + c_out channels) as
// [K, rp nch], zeros at q >= r; consecutive threads take consecutive
// padded columns of one row.
template <typename T>
__global__ void pad_head(const T* __restrict__ w3, T* __restrict__ w3p,
                         int K, int nch, int r, int rp) {
  const int ncol = r * nch, ncolp = rp * nch;
  const long total = static_cast<long>(K) * ncolp;
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e / ncolp), c = static_cast<int>(e % ncolp);
    const int rc = real_col(c, rp, r);
    w3p[e] = rc >= 0 ? w3[static_cast<long>(k) * ncol + rc] : T(0.f);
  }
}

template <typename T>
inline cudaError_t launch_pad_head(const T* w3, T* w3p, int K, int nch,
                                   int r, cudaStream_t stream) {
  const long cells = static_cast<long>(K) * padded_rank(r) * nch;
  pad_head<T><<<static_cast<unsigned>((cells + 255) / 256), 256, 0, stream>>>(
      w3, w3p, K, nch, r, padded_rank(r));
  return cudaGetLastError();
}

// The instance of a rank: R8 = slab_rank(r) / 8 and whether it walks
// slabs (kSlab: r past 64, R8 = 8).
template <int R8, bool kSlab>
struct RankInstance {
  static constexpr int value = R8;
  static constexpr bool slab = kSlab;
};

// f(RankInstance<R8, kSlab>()) for a rank r of 1 .. 256: R8 = ceil(r / 8)
// up to 64, the slab instance (R8 = 8) past it; `otherwise` for any other
// rank.
template <typename F, typename R>
R with_rank(int r, F&& f, R otherwise) {
  if (r < 1 || r > kMaxRank) return otherwise;
  switch (padded_rank(r)) {
    case 8: return f(RankInstance<1, false>());
    case 16: return f(RankInstance<2, false>());
    case 24: return f(RankInstance<3, false>());
    case 32: return f(RankInstance<4, false>());
    case 40: return f(RankInstance<5, false>());
    case 48: return f(RankInstance<6, false>());
    case 56: return f(RankInstance<7, false>());
    case 64: return f(RankInstance<8, false>());
  }
  return f(RankInstance<8, true>());
}

}  // namespace lowrank_wgmma
