// Float32-exact rank-r products on Hopper's bf16 tensor cores, shared by the
// float32 instances of B3 (fused_edge_conv_lowrank_f32_wgmma.cu) and of B4's
// rows kernel (fused_edge_conv_lowrank_bwd_f32_wgmma.cu).  The split, the
// register-A product, the bulk-copy ring and its walk are f32_wgmma.cuh's
// (float32 B1/B2); the accumulator -> (channel, q) map is lowrank_wgmma.cuh's
// (bfloat16 B3/B4).  This header adds the chunk walks and their stage image.
//
// Chunks.  Every kernel runs at the padded rank rp of lowrank_wgmma.cuh (8
// ceil(r / 8) up to 64, 64 ceil(r / 64) past it, r 1 .. 256; columns i rp +
// q of the head are the model's i r + q for q < r, zeros for q >= r), past
// 64 as rp / 64 slabs of 64 (lowrank_wgmma.cuh slab_col), each the rank-64
// walk on its slab's columns; R below is the rank of one slab's head (rp
// up to 64, else 64).  Every product is 64 slots x N columns of the (k, q)
// or uv space, N = G R with G = floor(64 / R) whole channels of R columns:
// 64 at R 8, 16, 32 and 64, 48 at 24, and one channel of 40, 48 or 56 past
// 32.  A chunk reads the edge
// MLP's head w3 [K, r (c_in + c_out)] (model column layout: U[i, q] = uv[i
// r + q], V[o, q] = uv[r c_in + o r + q]) padded, in one of three ways,
// lowrank_wgmma.cuh's:
//
//   kUv: uv columns lo .. lo + N - 1 over depth k < K      (uv = h w3)
//   kP:  (k, q) columns over depth i < c_in, w3[k, i r + q] (P = x_src W3U)
//   kQ:  (k, q) columns over depth o < c_out, w3[k, r c_in + o r + q]
//                                                           (Q = dmsg W3V)
//
// The forward walks the U chunks then the V chunks of uv (fwd_chunk); B4's
// rows kernel the V chunks, the U chunks, then the P chunks and the Q chunks
// over k (bwd_chunk); past rank 64 each slab's walk in turn.  The sequence
// is the same for every tile, so the stage image (lowrank_image) lays it
// out once per call: chunk c is the three bf16 parts of the chunk as
// K-major B operands [N][dp] (wgmma_tile.cuh kmajor), dp the largest depth
// rounded up to 16 (past 64: to 32, image_depth), zeros past a chunk's
// columns and depth and at q >= r, the slabs' chunks one slab after the
// other (the image grows with the slabs); after the stages, b3 padded the
// same way (float32), each slab's [R (c_in + c_out)] in turn, which the
// kernels' epilogues read.  A
// producer warp streams the stages through f32_wgmma.cuh's ring (produce).
//
// Depth.  Up to a depth of 64 a chunk is one stage and the consumer
// warpgroup walks the stages (f32_wgmma.cuh Walk) with A (h, x_src or dmsg)
// split once per tile into register fragments (12 registers per 16 of
// depth), two chunks' products in flight.  Past 64 the fragments would take
// 72 or 96 registers beside the accumulators, and a chunk's stage 36 or 48
// KB, so A's three parts are split once per tile into shared memory
// instead (split_smem) and a chunk is dp / 32 stages of 32 deep (12 KB at N
// 64, the ring four of them): f32_wgmma.cuh's DeepWalk, which B1 and B2 walk
// past a depth of 128, issues each stage's products into the chunk's one
// accumulator as it lands and releases it once they completed; one
// instance (S = kDeep) serves every depth of 80 .. 256.
//
// Wide.  Past a K, c_in or c_out of 128 (wide) A's parts take 96 KB at a
// depth of 256 and each float32 tile [64][256] 64 KB, so the kernels keep
// only the tiles whose lives overlap: B3 shares one tile between x and the
// messages and adds its part sums into its partial in device memory; B4's
// rows kernel reads x_src from device memory and keeps dh's P half in dh
// until the Q half completes it (each kernel's Layout says how much).
// Every operand of a product is an input or a float32 value split in
// three; per stage, the six products of order >= 2^-16 run smallest first
// into one float32 accumulator.

#pragma once

#include "f32_wgmma.cuh"
#include "lowrank_wgmma.cuh"

namespace lowrank_f32 {

using namespace f32_wgmma;
using lowrank_wgmma::padded_rank;
using lowrank_wgmma::q_of;
using lowrank_wgmma::quad_sum;
using lowrank_wgmma::real_col;
using lowrank_wgmma::slab_col;
using lowrank_wgmma::slab_rank;
using lowrank_wgmma::with_rank;

constexpr int kTile = 64;    // slots per tile
constexpr int kMaxDim = 256;  // K, c_in, c_out <= 256

// Whether the kernels take the wide layout (a K, c_in or c_out past 128).
__host__ __device__ constexpr bool wide_dims(int K, int c_in, int c_out) {
  return K > 128 || c_in > 128 || c_out > 128;
}

enum Reading { kUv = 0, kP = 1, kQ = 2 };

// Columns of a chunk at a slab's rank R = 8 R8 (lowrank_wgmma.cuh
// slab_rank): whole channels, at most 64.
__host__ __device__ constexpr int chunk_cols(int R) { return 64 / R * R; }
template <int R8>
constexpr int kN = chunk_cols(8 * R8);

// The padded depth of the A operands and of the image's chunks: depth
// rounded up to 16, past 64 to 32; and the depth of one stage: all of it
// up to 64, else 32.
__host__ __device__ constexpr int image_depth(int depth) {
  return round_up(depth, 16) <= 64 ? round_up(depth, 16) : round_up(depth, 32);
}
__host__ __device__ constexpr int stage_depth(int dp) {
  return dp <= 64 ? dp : 32;
}

// Blocks per SM the launch bounds of B3 and of B4's rows kernel hold the
// registers to (168 a thread for two): two up to a depth of 48 and a
// padded rank of 32, where the ring and tiles also fit two blocks' shared
// memory at width 48; one past either, whose registers (t and dt take 4 R8
// each) would spill under two's bound.
template <int R8, int S>
constexpr int kMinBlocks = S < 4 && R8 <= 4 ? 2 : 1;

// The template depth of every A operand past 64: S = kDeep stands for the
// deep walk (DeepWalk) at any padded depth dp of 80 .. 256, dp / 32 stages
// per chunk.
constexpr int kDeep = 8;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int lesser(int a, int b) { return a < b ? a : b; }

struct Chunk {
  int kind;  // Reading
  int lo;    // first column (kUv: of uv; kP, kQ: of the (k, q) columns)
  int cw;    // real columns, whole channels
};

// Chunk c of the forward walk: the U chunks, then the V chunks, G channels
// each.
__host__ __device__ inline Chunk fwd_chunk(int c, int g, int r, int c_in,
                                           int c_out) {
  const int n_u = cdiv(c_in, g);
  if (c < n_u) return {kUv, c * g * r, lesser(g, c_in - c * g) * r};
  c -= n_u;
  return {kUv, r * c_in + c * g * r, lesser(g, c_out - c * g) * r};
}

// Chunk c of B4's rows walk: the V chunks, the U chunks, the P chunks, then
// the Q chunks.
__host__ __device__ inline Chunk bwd_chunk(int c, int g, int r, int K,
                                           int c_in, int c_out) {
  const int n_v = cdiv(c_out, g), n_u = cdiv(c_in, g), n_k = cdiv(K, g);
  if (c < n_v) return {kUv, r * c_in + c * g * r, lesser(g, c_out - c * g) * r};
  c -= n_v;
  if (c < n_u) return {kUv, c * g * r, lesser(g, c_in - c * g) * r};
  c -= n_u;
  const int kind = c < n_k ? kP : kQ;
  if (c >= n_k) c -= n_k;
  return {kind, c * g * r, lesser(g, K - c * g) * r};
}

// Stages of the forward's (B4 rows kernel's) walk.
__host__ __device__ inline int fwd_chunks(int g, int c_in, int c_out) {
  return cdiv(c_in, g) + cdiv(c_out, g);
}
__host__ __device__ inline int bwd_chunks(int g, int K, int c_in, int c_out) {
  return cdiv(c_in, g) + cdiv(c_out, g) + 2 * cdiv(K, g);
}

// The stage image: stage c D + l (D = dp / sd stages per chunk, sd
// stage_depth) holds depth rows l sd .. l sd + sd - 1 of chunk c's three
// bf16 parts, each a K-major [n][sd] operand (n = N, the chunk's columns as
// rows), chunk c being chunk c % cps of slab c / cps (cps the chunks of one
// slab's walk), over the head padded to rp; then b3 padded [rp (c_in +
// c_out)] float32, slab by slab ([R (c_in + c_out)] each, R the slab's
// rank: rp up to 64).  Consecutive threads take consecutive columns, so
// that w3's kUv rows coalesce.
__global__ void lowrank_image(const float* __restrict__ w3,
                              const float* __restrict__ b3,
                              bf16* __restrict__ image, int stages, int n,
                              int dp, int rp, int r, int K, int c_in,
                              int c_out, int backward) {
  const int sd = stage_depth(dp), slices = dp / sd;
  const int R = rp < 64 ? rp : 64, nch = c_in + c_out;
  const int per = n * sd, g = n / R, ncol = r * nch;
  const int cps = backward ? bwd_chunks(g, K, c_in, c_out)
                           : fwd_chunks(g, c_in, c_out);
  const long cells = static_cast<long>(stages) * per;
  const long total = cells + rp * nch;
  for (long q = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<long>(gridDim.x) * blockDim.x) {
    if (q >= cells) {  // b3, padded, slab by slab
      const int e = static_cast<int>(q - cells), sl = e / (R * nch);
      const int rc = real_col(slab_col(e - sl * R * nch, sl, R, rp), rp, r);
      reinterpret_cast<float*>(image + 3 * cells)[e] = rc >= 0 ? b3[rc] : 0.f;
      continue;
    }
    const int st = static_cast<int>(q / per), e = static_cast<int>(q % per);
    const int c = st / slices, row = e % n, dl = e / n;
    const int d = (st - c * slices) * sd + dl;
    const int sl = c / cps;
    const Chunk ch = backward ? bwd_chunk(c - sl * cps, g, R, K, c_in, c_out)
                              : fwd_chunk(c - sl * cps, g, R, c_in, c_out);
    const int depth = ch.kind == kUv ? K : ch.kind == kP ? c_in : c_out;
    float v = 0.f;
    if (row < ch.cw && d < depth) {
      const int col = ch.lo + row;
      if (ch.kind == kUv) {
        const int rc = real_col(slab_col(col, sl, R, rp), rp, r);
        if (rc >= 0) v = w3[static_cast<long>(d) * ncol + rc];
      } else {
        const int k = col / R, qq = col - k * R + sl * R;
        if (qq < r)
          v = w3[static_cast<long>(k) * ncol + (ch.kind == kQ ? r * c_in : 0) +
                 d * r + qq];
      }
    }
    const bf16 v1 = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(v1);
    const bf16 v2 = __float2bfloat16_rn(r1);
    const bf16 v3 = __float2bfloat16_rn(r1 - __bfloat162float(v2));
    bf16* at = image + static_cast<long>(st) * 3 * per + kmajor(row, dl, sd);
    at[0] = v1;
    at[per] = v2;
    at[2 * per] = v3;
  }
}

// Lays out the stage image of `chunks` chunks (every slab's) of depth dp
// (image_depth) and returns the padded b3 after them (through `b3p`).
inline cudaError_t launch_lowrank_image(const float* w3, const float* b3,
                                        bf16* image, int chunks, int n,
                                        int dp, int rp, int r, int K,
                                        int c_in, int c_out, bool backward,
                                        const float** b3p,
                                        cudaStream_t stream) {
  const int stages = chunks * (dp / stage_depth(dp));
  const long cells = static_cast<long>(stages) * n * stage_depth(dp);
  const long total = cells + rp * (c_in + c_out);
  lowrank_image<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                  stream>>>(w3, b3, image, stages, n, dp, rp, r, K, c_in,
                            c_out, backward ? 1 : 0);
  *b3p = reinterpret_cast<const float*>(image + 3 * cells);
  return cudaGetLastError();
}

// f(R8, S) for a rank r of 1 .. 256 (R8 lowrank_wgmma.cuh with_rank's
// RankInstance: ceil(r / 8) up to 64, the slab instance past it), and S
// the k16 steps of a kernel's A operands up to a depth of 64 (1 .. 4),
// kDeep past it, for a depth of 1 .. 256; `otherwise` outside them.
template <typename F, typename Ret>
Ret with_rank_depth(int r, int depth, F&& f, Ret otherwise) {
  if (depth < 1 || depth > kMaxDim) return otherwise;
  return with_rank(r, [&](auto r8) {
    switch (cdiv(depth, 16)) {
      case 1: return f(r8, std::integral_constant<int, 1>());
      case 2: return f(r8, std::integral_constant<int, 2>());
      case 3: return f(r8, std::integral_constant<int, 3>());
      case 4: return f(r8, std::integral_constant<int, 4>());
      default: return f(r8, std::integral_constant<int, kDeep>());
    }
  }, otherwise);
}

// The three parts of 64 rows [width] (row s at src + s * stride, columns
// past width zero) as this thread's register-A fragments over S k16 steps.
template <int S>
__device__ __forceinline__ void split_rows(uint32_t (&a)[3][S][4],
                                           const float* src, long stride,
                                           int width) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = src + a_row(2 * u) * stride;
      const int col = 16 * s + a_col(2 * u);
      const float va = col < width ? row[col] : 0.f;
      const float vb = col + 1 < width ? row[col + 1] : 0.f;
      split3(va, vb, a[0][s][u], a[1][s][u], a[2][s][u]);
    }
}

// The three parts of 64 rows [width] (row s at src + s * stride, columns
// past width zero) as K-major operands [64][dp] in shared memory, part p at
// dst + p 64 dp; 8 consecutive columns of a row are a 16-byte piece of each
// part.  The threads of one warpgroup; the caller fences and synchronises
// before a product reads them.
__device__ __forceinline__ void split_smem(bf16* dst, const float* src,
                                           long stride, int width, int dp) {
  const int per = dp / 8;
  for (int p = threadIdx.x % kWarpgroup; p < kTile * per; p += kWarpgroup) {
    const int s = p / per, d = 8 * (p - s * per);
    const float* row = src + s * stride;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = d + u < width ? row[d + u] : 0.f;
    put_split8(dst, dp, s, d, v);
  }
}

}  // namespace lowrank_f32
