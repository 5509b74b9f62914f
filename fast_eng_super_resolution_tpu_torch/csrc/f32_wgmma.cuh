// Float32-exact products on Hopper's bf16 tensor cores, shared by the
// float32 instances of B1 (fused_edge_conv_f32_wgmma.cu) and B2
// (fused_edge_conv_bwd_f32_wgmma.cu) and by B5
// (fused_edge_messages_wgmma.cu), B1's forward without the gather and the
// scatter.  The register-A product, the mbarrier and bulk-copy primitives
// and the fragment maps are messages_wgmma.cuh's; this header adds the
// split, the stage image and its column chunks, the ring and the walk.
//
// The split.  A float32 value v is three bf16 values v1 + v2 + v3 == v
// exactly: v1 = bf16(v), v2 = bf16(v - v1), v3 = bf16(v - v1 - v2), each
// remainder exact in float32, and 8 + 8 + 8 significant bits cover float32's
// 24 (ops/pallas_mp.py:split3 is its plain version).  Of the nine products
// of two split operands, the six of order >= 2^-16 carry what float32 keeps;
// they run smallest first into one float32 accumulator (a_part / b_part):
// A3 B1, A2 B2, A1 B3, A2 B1, A1 B2, A1 B1.  Bits are lost only where a part
// falls below bf16's normal range (|v| < 2^-110 or so).
//
// The stage image.  W~ = [w3; b3] as [K+1, c_in, c_out] is laid out once
// per call (stage_image) as stages, each the three bf16 parts of one column
// chunk of W~_k as K-major B operands (wgmma_tile.cuh, kmajor) of N rows x
// a stage's depth, zero padded: rows o and depth i for B1's and B5's P_k =
// X @ W~_k, rows i and depth o for B2's R_k = D @ W~_k^T.  The rows (c_out
// for B1 and B5, c_in for B2, up to 256) are cut into Chunks: one chunk of
// all of them at most 64 wide, else chunks of at most 64 (32 at a depth of
// 65..128), so that a stage stays within 24 KB and the registers hold the
// depth's A fragments beside two accumulators.  Up to a depth of 128 a
// stage holds all of it: stage c (K+1) + k is chunk c of W~_k.  One producer
// thread streams the stages by bulk copy into a ring of kRing shared-memory
// stages (ring_init, produce); each consumer warpgroup walks them (Walk), a
// pass over k per chunk, six products per stage, two stages in flight.
//
// Past a depth of 128 X's parts would take 12 registers per 16 of depth,
// 192 at 256: A's three parts go to shared memory instead, split there once
// per tile (put_split8), and W~_k's chunk is depth / 32 stages of 32 deep,
// stage (c (K+1) + k) slices + l (12 KB at N 64).  DeepWalk issues each
// stage's twelve products into the one accumulator of W~_k as it lands and
// releases it once they completed; B3/B4 (lowrank_f32_wgmma.cuh) walk their
// chunks past a depth of 64 the same way.

#pragma once

#include "messages_wgmma.cuh"

namespace f32_wgmma {

using namespace messages_wgmma;

constexpr int kRing = 4;  // stages in flight (a power of 2)
constexpr int kRun = 4;   // stages per run of Walk::run

// The three bf16 parts of the pair (a, b), each a bf16x2 word, .x (a) in
// the lower half: hi + mid + lo == (a, b) exactly.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  union Pair {
    __nv_bfloat162 v;
    uint32_t u;
  } p1, p2, p3;
  p1.v = __floats2bfloat162_rn(a, b);
  const float2 f1 = __bfloat1622float2(p1.v);
  const float ra = a - f1.x, rb = b - f1.y;
  p2.v = __floats2bfloat162_rn(ra, rb);
  const float2 f2 = __bfloat1622float2(p2.v);
  p3.v = __floats2bfloat162_rn(ra - f2.x, rb - f2.y);
  hi = p1.u;
  mid = p2.u;
  lo = p3.u;
}

// Eight consecutive values split into three 16-byte pieces, one per part.
__device__ __forceinline__ void split3_8(const float (&v)[8], uint4 (&p)[3]) {
  uint32_t w[3][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    split3(v[2 * q], v[2 * q + 1], w[0][q], w[1][q], w[2][q]);
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r] = make_uint4(w[r][0], w[r][1], w[r][2], w[r][3]);
}

// Copies `bytes` (0..16) from global to shared memory asynchronously
// (cp.async, 16-byte aligned at both ends) and zeros the rest of the 16
// bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// Starts the copy of the n (64 unless given) h rows [K] from row e0 into
// the h tile hs ([64][hstride] float32, columns 0..K-1) by cp.async, from
// the threads of one warpgroup: nothing waits for it here.  A ragged last
// tile (n < 64) leaves its other rows as they were: their A rows are zero
// and their sums are never stored.
__device__ __forceinline__ void prefetch_h(float* hs, const float* h, long e0,
                                           int K, int hstride, int n = 64) {
  const float* src = h + e0 * K;
  const int t = threadIdx.x % kWarpgroup;
  int s = t / K, k = t - s * K;
  for (int q = t; q < n * K; q += kWarpgroup) {
    cp_async4(hs + s * hstride + k, src + q, 4);
    k += kWarpgroup;
    while (k >= K) {
      k -= K;
      ++s;
    }
  }
  cp_async_commit();
}

// The A part and the B part of product q (0..5), smallest first.
__device__ __forceinline__ constexpr int a_part(int q) {
  return q == 0 ? 2 : (q == 1 || q == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int b_part(int q) {
  return q == 2 ? 2 : (q == 1 || q == 4) ? 1 : 0;
}

// Past a depth of kWalkDepth, A's parts sit in shared memory and a stage
// is kSliceDepth deep (DeepWalk).
constexpr int kWalkDepth = 128;
constexpr int kSliceDepth = 32;
// The kernels' widest rows and depth (c_in, c_out; K up to 256 as well).
constexpr int kMaxWide = 256;

// The column chunks of a product of `rows` (1..256) over `depth` (1..256):
// `chunks` of n rows each (n a multiple of 8, chunks * n >= rows), n at most
// 64 where the depth takes at most 4 k16 steps or A sits in shared memory
// (`deep`, past a depth of 128), else at most 32; the padded depth dp
// (rounded up to 16, deep: to 32) in `slices` stages of sd each.
struct Chunks {
  int steps, n, chunks, dp, sd, slices;
  bool deep;
  __host__ __device__ Chunks(int rows, int depth) {
    steps = round_up(depth, 16) / 16;
    deep = depth > kWalkDepth;
    const int r8 = round_up(rows, 8), most = steps <= 4 || deep ? 64 : 32;
    chunks = (r8 + most - 1) / most;
    n = round_up((r8 + chunks - 1) / chunks, 8);
    dp = deep ? round_up(depth, kSliceDepth) : 16 * steps;
    sd = deep ? kSliceDepth : dp;
    slices = dp / sd;
  }
};

// Stage q / per of W~ (slice l of chunk c of W~_k, k = K: b3) as three
// K-major B operands of `rows` (a chunk's n) x `depth` (a stage's, a
// multiple of 16) bf16, zero padded; by_out: row o, depth i (B1), else row
// i, depth o (B2).  Consecutive threads take consecutive o, so that w3's
// rows coalesce.
__global__ void stage_image(const float* __restrict__ w3,
                            const float* __restrict__ b3,
                            bf16* __restrict__ image, int K, int c_in,
                            int c_out, int rows, int depth, int slices,
                            int chunks, int by_out) {
  const int per = rows * depth;
  const long total = static_cast<long>(chunks) * (K + 1) * slices * per;
  for (long q = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<long>(gridDim.x) * blockDim.x) {
    const int st = static_cast<int>(q / per), r = static_cast<int>(q % per);
    const int ck = st / slices, l = st - ck * slices;
    const int c = ck / (K + 1), k = ck - c * (K + 1);
    int i, o, at;
    if (by_out) {
      const int il = r / rows;
      const int ol = r - il * rows;
      i = l * depth + il;
      o = c * rows + ol;
      at = kmajor(ol, il, depth);
    } else {
      const int il = r / depth;
      const int ol = r - il * depth;
      o = l * depth + ol;
      i = c * rows + il;
      at = kmajor(il, ol, depth);
    }
    float v = 0.f;
    if (o < c_out && i < c_in)
      v = k < K ? w3[static_cast<long>(k) * c_in * c_out + i * c_out + o]
                : b3[i * c_out + o];
    const bf16 v1 = __float2bfloat16_rn(v);
    const float r1 = v - __bfloat162float(v1);
    const bf16 v2 = __float2bfloat16_rn(r1);
    const bf16 v3 = __float2bfloat16_rn(r1 - __bfloat162float(v2));
    bf16* dst = image + static_cast<long>(st) * 3 * per + at;
    dst[0] = v1;
    dst[per] = v2;
    dst[2 * per] = v3;
  }
}

inline cudaError_t launch_image(const float* w3, const float* b3, bf16* image,
                                int K, int c_in, int c_out, const Chunks& ch,
                                bool by_out, cudaStream_t stream) {
  const long cells =
      static_cast<long>(ch.chunks) * (K + 1) * ch.n * ch.dp;
  stage_image<<<static_cast<unsigned>((cells + 255) / 256), 256, 0, stream>>>(
      w3, b3, image, K, c_in, c_out, ch.n, ch.sd, ch.slices, ch.chunks,
      by_out ? 1 : 0);
  return cudaGetLastError();
}

// Ring step j's stage and the parity of its phase on the stage's barriers
// (kRing a power of 2, so j may wrap).
__device__ __forceinline__ uint32_t slot(uint32_t j) { return j % kRing; }
__device__ __forceinline__ uint32_t parity(uint32_t j) {
  return (j / kRing) & 1;
}

// The ring's barriers: "full" completes when a stage has landed (the
// producer's arrival and the copy's bytes), "empty" when the consumers'
// `warps` warps (one warpgroup's four unless given) are done with it.  One
// thread initialises, then a block barrier.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int warps = 4) {
  for (int r = 0; r < kRing; ++r) {
    mbar_init(full + r, 1);
    mbar_init(empty + r, warps);
  }
  fence_mbar_init();
}

// The producer's share: stages 0..K of the image into the ring, ring steps
// j onwards.  One thread.
__device__ __forceinline__ void produce(uint64_t* full, uint64_t* empty,
                                        unsigned char* ring,
                                        const unsigned char* image,
                                        uint32_t stage_bytes, int K,
                                        uint32_t& j) {
  for (int k = 0; k <= K; ++k, ++j) {
    const uint32_t r = slot(j);
    mbar_wait(empty + r, parity(j) ^ 1);
    mbar_expect_tx(full + r, stage_bytes);
    bulk_load(ring + r * stage_bytes, image + static_cast<long>(k) * stage_bytes,
              stage_bytes, full + r);
  }
}

// acc = sum of the six products of A's parts (registers a[part][step]) and
// one stage's B parts (descriptor db; part p at db + p dpart, a k16 step at
// + 16), over the S k16 steps, as one committed group.
template <int N, int S>
__device__ __forceinline__ void issue(float (&acc)[N / 2],
                                      const uint32_t (&a)[3][S][4],
                                      uint64_t db, uint32_t dpart) {
  fence_operand(acc);
  fence();
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int s = 0; s < S; ++s)
      MmaRs<N>::run(acc, a[a_part(q)][s],
                    db + static_cast<uint64_t>(b_part(q) * dpart + 16 * s),
                    q + s > 0);
  commit();
  fence_operand(acc);
}

// A consumer warpgroup's walk over the ring for one tile: the tile's A
// parts, the ring's barriers and descriptors; fin(acc, k) is the CUDA
// cores' share of stage k once its product is complete.
template <int N, int S, typename Fin>
struct Walk {
  const uint32_t (&a)[3][S][4];
  uint64_t* full;
  uint64_t* empty;
  uint64_t d0;
  uint32_t dstage, dpart;
  int lane;
  Fin& fin;

  // Issues the products of ring step j into acc, once its stage has landed.
  __device__ __forceinline__ void start(float (&acc)[N / 2], uint32_t j) const {
    mbar_wait(full + slot(j), parity(j));
    issue<N, S>(acc, a, d0 + slot(j) * dstage, dpart);
  }

  // Step j (stage k) is complete in acc: release its stage, then fin.
  __device__ __forceinline__ void finish(float (&acc)[N / 2], uint32_t j,
                                         int k) const {
    fence_operand(acc);
    if (lane == 0) mbar_arrive(empty + slot(j));
    fin(acc, k);
  }

  // cur's products (step j, stage k) are in flight: finishes them and the
  // U - 1 steps after them, each next product issued (into the other
  // accumulator) before the current one is finished.  All are waited for by
  // the end: ptxas serializes every wgmma of a loop that carries one in
  // flight across its back edge.
  template <int U>
  __device__ __forceinline__ void run(float (&cur)[N / 2], float (&nxt)[N / 2],
                                      uint32_t j, int k) const {
    if constexpr (U > 1) {
      start(nxt, j + 1);
      wait_one();
      finish(cur, j, k);
      run<U - 1>(nxt, cur, j + 1, k + 1);
    } else {
      wait_all();
      finish(cur, j, k);
    }
  }

  // Stages 0..K from ring step j on, in runs of kRun (the rest one by one).
  __device__ __forceinline__ void all(int K, uint32_t& j) const {
    float pa[N / 2], pb[N / 2];
    int k = 0;
    for (; k + kRun <= K + 1; k += kRun, j += kRun) {
      start(pa, j);
      this->template run<kRun>(pa, pb, j, k);
    }
    for (; k <= K; ++k, ++j) {
      start(pa, j);
      this->template run<1>(pa, pb, j, k);
    }
  }
};

// Eight consecutive values v of row s, columns d .. d + 7 (d a multiple of
// 8), split into three K-major operands [64][dp] at dst (part p at dst + p
// 64 dp): a 16-byte piece of each part.  The caller fences and synchronises
// before a product reads them.
__device__ __forceinline__ void put_split8(bf16* dst, int dp, int s, int d,
                                           const float (&v)[8]) {
  uint4 pt[3];
  split3_8(v, pt);
  const int at = kmajor(s, d, dp);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    *reinterpret_cast<uint4*>(dst + r * 64 * dp + at) = pt[r];
}

// A consumer warpgroup's walk for one tile with A's parts in shared memory
// (descriptor da, part p at + p dapart, a k16 step at + 16): each chunk (B1,
// B2: W~_k; B3/B4: a chunk of their walk) `slices` stages of kSliceDepth of
// the ring (descriptors as Walk's).  A chunk's stages go into one
// accumulator, each stage's twelve products (six pairs of parts, two k16
// steps) as one group issued as soon as the stage has landed and waited for
// before the stage is released (the producer keeps the next stages landing
// meanwhile), then fin(acc, c).  No product is in flight across a loop's
// back edge.
template <int N, typename Fin>
struct DeepWalk {
  uint64_t da;
  uint32_t dapart;
  int slices;
  uint64_t* full;
  uint64_t* empty;
  uint64_t d0;
  uint32_t dstage, dpart;
  int lane;
  Fin& fin;

  // Chunks 0 .. n - 1 from ring step j on.
  __device__ __forceinline__ void all(int n, uint32_t& j) const {
    for (int c = 0; c < n; ++c) {
      float acc[N / 2];
#pragma unroll
      for (int v = 0; v < N / 2; ++v) acc[v] = 0.f;
      for (int l = 0; l < slices; ++l, ++j) {
        mbar_wait(full + slot(j), parity(j));
        fence_operand(acc);
        fence();
        const uint64_t db = d0 + slot(j) * dstage;
        const uint64_t dl = da + static_cast<uint64_t>(32 * l);
#pragma unroll
        for (int q = 0; q < 6; ++q)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            Mma<N>::run(acc,
                        dl + static_cast<uint64_t>(a_part(q) * dapart + 16 * s),
                        db + static_cast<uint64_t>(b_part(q) * dpart + 16 * s),
                        1);
        commit();
        wait_all();
        fence_operand(acc);
        if (lane == 0) mbar_arrive(empty + slot(j));
      }
      fin(acc, c);
    }
  }
};

// The template depth of B1's, B2's and B5's A operand past a depth of 128:
// S = kDeepA stands for A's parts in shared memory (DeepWalk) at any padded
// depth of 160 .. 256.
constexpr int kDeepA = 16;

// f(integral_constant N, integral_constant S) for the chunk width N of ch
// and S = its depth's k16 steps (1..8), or kDeepA past a depth of 128;
// `otherwise` for a width no instance takes.
template <typename F, typename R>
R shape_switch(const Chunks& ch, F&& f, R otherwise) {
  auto upto32 = [&](auto s) {
    switch (ch.n) {
      case 8: return f(std::integral_constant<int, 8>(), s);
      case 16: return f(std::integral_constant<int, 16>(), s);
      case 24: return f(std::integral_constant<int, 24>(), s);
      default: return f(std::integral_constant<int, 32>(), s);
    }
  };
  auto upto64 = [&](auto s) {
    return with_width(ch.n, [&](auto nn) { return f(nn, s); }, otherwise);
  };
  if (ch.deep) return upto64(std::integral_constant<int, kDeepA>());
  switch (ch.steps) {
    case 1: return upto64(std::integral_constant<int, 1>());
    case 2: return upto64(std::integral_constant<int, 2>());
    case 3: return upto64(std::integral_constant<int, 3>());
    case 4: return upto64(std::integral_constant<int, 4>());
    case 5: return upto32(std::integral_constant<int, 5>());
    case 6: return upto32(std::integral_constant<int, 6>());
    case 7: return upto32(std::integral_constant<int, 7>());
    default: return upto32(std::integral_constant<int, 8>());
  }
}

// f(integral_constant N, integral_constant S) for the chunk width N of
// Chunks(rows, depth) and S = depth rounded up to 16, over 16 (1..8), or
// past a depth of 128 S = kDeepA with N of 8..64; `otherwise` outside
// 1..256 (the instances of B1, B2 and B5).
template <typename F, typename R>
R with_wide_shape(int rows, int depth, F&& f, R otherwise) {
  if (depth < 1 || depth > kMaxWide || rows < 1 || rows > kMaxWide)
    return otherwise;
  return shape_switch(Chunks(rows, depth), f, otherwise);
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory one
// SM holds at once (-1 if the runtime refuses).
template <typename Kernel>
int blocks_on_sm(Kernel* kernel, int threads, size_t smem) {
  int n = -1;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace f32_wgmma
