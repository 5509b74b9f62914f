// Tensor-core (wgmma) pieces shared by the bfloat16 rank-r kernels: B3's
// forward (fused_edge_conv_lowrank_wgmma.cu) and B4's rows kernel
// (fused_edge_conv_lowrank_bwd_wgmma.cu); the rank dispatch and the padded
// column map also serve the float32 pair (lowrank_f32_wgmma.cuh).
//
// Padded rank.  Every kernel runs at rp = 8 R8, R8 = ceil(r / 8), the real
// rank r beside it at run time: channel i's columns are i rp .. i rp + rp -
// 1 of a padded head whose column i rp + q is the model's column i r + q
// for q < r, and zero for q >= r (w3 and b3 alike; real_col below).  With
// the padded columns zero, uv, t, dt and duv are zero there, so the rank-r
// result is the rank-rp instance's on the zero-padded head; dw3 and db3 go
// back to the model's columns only.  The bfloat16 kernels read a padded
// copy of w3 that pad_head lays out once per call (at a rank that is not a
// multiple of 8), so that every chunk still loads in 16-byte pieces; b3 is
// staged padded from its real columns.
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
// A chunk holds whole channels (or whole k for kP/kQ): G = 128 / rp of
// them, cw = (channels) rp columns; columns past cw and depth rows past the
// real depth are staged as zeros.  With rp a multiple of 8, 8 consecutive
// columns of one depth row are 16 contiguous bytes of w3 in all three
// readings, so a chunk copies in 16-byte pieces into the MN-major layout of
// wgmma_tile.cuh (columns contiguous).
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

// The padded rank of r: 8 ceil(r / 8).
__host__ __device__ constexpr int padded_rank(int r) { return (r + 7) / 8 * 8; }

// The model's column of padded column c of a head at rank r padded to rp
// (channel c / rp, q = c % rp), or -1 for a padded column (q >= r).
__host__ __device__ __forceinline__ int real_col(int c, int rp, int r) {
  const int ch = c / rp, q = c - ch * rp;
  return q < r ? ch * r + q : -1;
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

// b3 [r nch] staged padded into shared memory [rp nch], zeros at q >= r.
__device__ __forceinline__ void stage_bias(float* dst, const float* b3,
                                           int ncolp, int rp, int r) {
  for (int e = threadIdx.x; e < ncolp; e += kWarpgroup) {
    const int rc = real_col(e, rp, r);
    dst[e] = rc >= 0 ? b3[rc] : 0.f;
  }
}

// f(std::integral_constant<int, R8>()) for a rank r of 1 .. 32, R8 =
// ceil(r / 8) (the padded rank over 8); `otherwise` for any other rank.
template <typename F, typename R>
R with_rank(int r, F&& f, R otherwise) {
  switch (padded_rank(r)) {
    case 8: return f(std::integral_constant<int, 1>());
    case 16: return f(std::integral_constant<int, 2>());
    case 24: return f(std::integral_constant<int, 3>());
    case 32: return f(std::integral_constant<int, 4>());
  }
  return otherwise;
}

}  // namespace lowrank_wgmma
