// Tensor-core (wgmma) pieces shared by the bfloat16 rank-r kernels: B3's
// forward (fused_edge_conv_lowrank_wgmma.cu) and B4's rows kernel
// (fused_edge_conv_lowrank_bwd_wgmma.cu).
//
// Chunks.  Both kernels run m64n128k16 products whose B operand is a
// 128-column chunk of the edge MLP's head w3 [K, r (c_in + c_out)] (model
// column layout: U[i, q] = uv[i r + q], V[o, q] = uv[r c_in + o r + q]),
// read in one of three ways:
//
//   kUv: uv columns lo .. lo + 127 over depth k < K          (uv = h w3)
//   kP:  (k, q) columns lo .. over depth i < c_in, the entry
//        w3[k, i r + q]: W3U, so that P = x_src @ W3U
//   kQ:  the same over depth o < c_out, w3[k, r c_in + o r + q]: W3V
//
// A chunk holds whole channels (or whole k for kP/kQ): G = 128 / r of them,
// cw = (channels) r columns; columns past cw and depth rows past the real
// depth are staged as zeros.  With r a multiple of 8, 8 consecutive columns
// of one depth row are 16 contiguous bytes of w3 in all three readings, so
// a chunk copies in 16-byte pieces into the MN-major layout of
// wgmma_tile.cuh (columns contiguous).
//
// Accumulator -> (channel, q).  Value j of a thread's m64n128 accumulator
// sits at column 8 (j / 4) + 2 (lane % 4) + j % 2 (wgmma_tile.cuh).  With
// r = 8 R8, column group cg = j / 4 is channel g = cg / R8 of the chunk at
// q = 8 (cg % R8) + 2 (lane % 4) + j % 2.  So every thread holds the same
// 2 R8 values of q for every channel of a chunk, for its two rows: a sum
// over channels into a per-slot vector of r (t, dt) accumulates in its
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
constexpr int kMaxDim = 64;  // K, c_in, c_out <= 64
constexpr int kPieces = kMaxDim * (kCols / 8) / kWarpgroup;  // per thread

enum ChunkKind { kUv = 0, kP = 1, kQ = 2 };

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
  int kind;   // ChunkKind
  int lo;     // first column (kUv: of uv; kP, kQ: of the (k, q) columns)
  int cw;     // real columns, a multiple of 8
  int depth;  // padded depth, a multiple of 16
  int real;   // real depth: K, c_in or c_out
};

// A chunk on its way from w3 into a B operand: thread t owns the pieces of
// columns 8 (t / 8) .. at depth rows 8 m + t % 8 and carries them in
// registers from load() to store(), so that their loads overlap a running
// product.  8 consecutive threads hold 8 consecutive depth rows of one
// column group: 128 contiguous bytes of the MN-major operand (no bank
// conflict), and each 32-byte sector of w3 is read by two threads of a
// warp.  Pieces outside the chunk's real columns or depth are zeros;
// pieces past its padded depth are not stored.
template <int R8>
struct ChunkStage {
  static constexpr int kR = 8 * R8;
  const bf16* w3;
  int ncol, ru;
  bool vec;  // w3 16-byte aligned: one 16-byte load per piece
  int depth;  // the loaded chunk's padded depth
  uint4 v[kPieces];

  __device__ __forceinline__ ChunkStage(const bf16* w3_, int c_in, int c_out)
      : w3(w3_), ncol(kR * (c_in + c_out)), ru(kR * c_in) {
    vec = reinterpret_cast<uintptr_t>(w3) % 16 == 0;
  }

  __device__ __forceinline__ void load(const Chunk& c) {
    depth = c.depth;
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      const int d = 8 * m + threadIdx.x % 8, n = 8 * (threadIdx.x / 8);
      v[m] = make_uint4(0u, 0u, 0u, 0u);
      if (d < c.real && n < c.cw) {
        long off;
        if (c.kind == kUv) {
          off = static_cast<long>(d) * ncol + c.lo + n;
        } else {
          const int col = c.lo + n, k = col / kR, q = col - k * kR;
          off = static_cast<long>(k) * ncol + (c.kind == kQ ? ru : 0) +
                d * kR + q;
        }
        if (vec) {
          v[m] = *reinterpret_cast<const uint4*>(w3 + off);
        } else {
          Pack8 e;
#pragma unroll
          for (int u = 0; u < 8; ++u) e.e[u] = w3[off + u];
          v[m] = e.u;
        }
      }
    }
  }

  __device__ __forceinline__ void store(bf16* buf) const {
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      const int d = 8 * m + threadIdx.x % 8, n = 8 * (threadIdx.x / 8);
      if (d < depth) *reinterpret_cast<uint4*>(buf + mnmajor(n, d, depth)) = v[m];
    }
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

// Sums v over the 4 lanes of a quad (the 4 threads that hold one row's
// columns of an accumulator).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// f(std::integral_constant<int, R8>()) for a rank r = 8 R8 (R8 = 1 .. 4);
// `otherwise` for any other rank.
template <typename F, typename R>
R with_rank(int r, F&& f, R otherwise) {
  switch (r) {
    case 8: return f(std::integral_constant<int, 1>());
    case 16: return f(std::integral_constant<int, 2>());
    case 24: return f(std::integral_constant<int, 3>());
    case 32: return f(std::integral_constant<int, 4>());
    default: return otherwise;
  }
}

}  // namespace lowrank_wgmma
