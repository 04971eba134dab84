// M1: microbenchmarks of traversal design constants, per 1024-ray tile.
//
// Replaces tools/micro_prims.py:65 `mk` -> `run` (pallas_call at :67), the
// TPU microbenchmark behind glome_tpu's megakernel design, with its eight
// kernel bodies (k_vote :82, k_dense :99, mk_gated :111, k_bits :130,
// k_lane :168, k_mxu :196).  Each C entry below computes the same function
// of (rays, sphere table) as its Pallas body; the plain torch versions are
// glome_tpu_torch/tools/micro_prims.py's *_plain functions, and the SIMT
// variants round every operation as they do (built with -fmad=false, IEEE
// sqrtf), so the two are bit-equal.
//
//   a vote_while   a while loop over sphere i % P: the next i is i + 1 if
//                  any ray of the tile has t0 < bt, else i + 2
//   b dense_fori   every ray against all P spheres, no decision
//   c gate<LEAF>   leaf l (LEAF spheres) only if any ray of the tile has
//                  bt > 0.05f * l
//   d bits168      the tile's hit mask (ox + dx > 0) packed into eight
//                  21-bit words, then every ray tests sphere w * 21 + k
//                  for each set bit, in word then bit order
//   e lane8x128    ray (sub, lane) against spheres sb * 128 + lane
//   f mxu128       the all-pairs product d . c of the tile's 1024 rays
//                  with the first 128 sphere centres on the tensor cores
//
// What bounds them on this card: b, c and d are float32 work (26
// operations per ray and sphere test, 67 TFLOP/s), but under -fmad=false
// and IEEE sqrtf a test issues ~35 instructions, so the issue rate of
// 132 SMs x 128 lanes, not the FLOP rate, is their floor; a is a chain of
// 256 block-wide votes, each a barrier; e and f are a few microseconds,
// near one launch.
//
// Design (the H100 redesign; the first port ran every variant as one
// 1024-thread block per tile reading each sphere as four scalar uniform
// loads inside the test's dependency chain):
//   - a, c and d decide for the whole tile, so a tile stays one block of
//     1024 threads: the TPU's jnp.any over its (8, 128) vector is
//     __syncthreads_or (a warp-level vote would be another function), and
//     d's mask is five warp ballots cut into the tool's 21-bit words.
//   - b, e and f make no tile-wide decision, so a tile is split over
//     smaller blocks (b, e: four of 256 threads; f: sixteen warpgroups of
//     64 rays), 1,024 or 4,096 blocks that spread evenly over the SMs.
//   - a, b, c and d stage the sphere rows they read ([cx cy cz r2], one
//     float4 a sphere: all P for a, b, c; the first 168 for d) into shared
//     memory with one TMA bulk copy (cp.async.bulk, completion on an
//     mbarrier) that overlaps the block's ray loads; a test then reads
//     one broadcast float4.  b unrolls its sphere loop by DENSE_UNROLL
//     and c its leaf, so one test's sqrtf latency overlaps the next.
//     e reads pf_lane coalesced, one sphere a lane, and stages nothing.
//   - f runs the product on wgmma.mma_async TF32 from shared memory
//     descriptors, two m64n64k8 halves (see the f section), the 3xTF32
//     split as three wgmma into one accumulator, and its epilogue on the
//     accumulator fragments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "micro.cuh"

extern __shared__ float4 micro_smem[];   // the staged sphere rows

constexpr int SPLIT_THREADS = 256;                      // b, e
constexpr int SPLIT = MICRO_TILE / SPLIT_THREADS;       // blocks per tile
constexpr int DENSE_UNROLL = 4;                         // b's tests per pass
constexpr int BITS_SPHERES = 8 * 21;                    // d reads these

struct MRay {
  float ox, oy, oz, dx, dy, dz, seed;
};

__device__ __forceinline__ MRay load_ray(const float* __restrict__ rays,
                                         int T, int tile, int ray) {
  return MRay{ray_at(rays, T, 0, tile, ray), ray_at(rays, T, 1, tile, ray),
              ray_at(rays, T, 2, tile, ray), ray_at(rays, T, 3, tile, ray),
              ray_at(rays, T, 4, tile, ray), ray_at(rays, T, 5, tile, ray),
              ray_at(rays, T, 6, tile, ray)};
}

// A miss's square root is never read, so it is taken of 1, not of the
// clamped 0 the plain version takes it of: IEEE sqrtf of 0 (and of
// denormals) leaves its inline path for a called slow path, and with
// misses on ~half the tests nearly every warp took that call on every
// test (the first port's kernels did: b stayed at 1.4x its issue floor).
// The hits' roots, and so every output bit, are unchanged.

// tools/micro_prims.py:47 sph: entry and exit t of the sphere (cx, cy, cz)
// of squared radius r2, 1e6 on a miss
__device__ __forceinline__ void sph(float cx, float cy, float cz, float r2,
                                    const MRay& r, float& t0, float& t1) {
  float ex = cx - r.ox;
  float ey = cy - r.oy;
  float ez = cz - r.oz;
  float v = ex * r.dx + ey * r.dy + ez * r.dz;
  float disc = r2 - (ex * ex + ey * ey + ez * ez - v * v);
  bool ok = disc >= 0.0f;
  float sq = sqrtf(ok ? fmaxf(disc, 0.0f) : 1.0f);   // a miss: see above
  t0 = ok ? v - sq : 1e6f;
  t1 = ok ? v + sq : 1e6f;
}

// sphere s = [cx cy cz r2]: bt = min(bt, t0 > 0 ? t0 : t1); returns t0
__device__ __forceinline__ float keep_nearest(float4 s, const MRay& r,
                                              float& bt) {
  float t0, t1;
  sph(s.x, s.y, s.z, s.w, r, t0, t1);
  bt = fminf(bt, t0 > 0.0f ? t0 : t1);
  return t0;
}

// thread 0 starts the bulk copy of `bytes` of sphere rows into micro_smem
// (every thread calls it; the block then loads its rays and stage_wait()s)
__device__ __forceinline__ void stage_rows(const float* __restrict__ pf,
                                           uint32_t bytes, uint64_t* bar) {
  if (threadIdx.x == 0) stage_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    stage_expect(bar, bytes);
    stage_copy(micro_smem, pf, bytes, bar);
  }
}

// --- a: while loop with a tile-wide vote per step -------------------------
__global__ void __launch_bounds__(MICRO_TILE, 2)
    vote_while_kernel(const float* __restrict__ rays, int T,
                      const float* __restrict__ pf, int P, int steps,
                      float* __restrict__ out) {
  __shared__ uint64_t bar;
  stage_rows(pf, 16u * P, &bar);
  MRay r = load_ray(rays, T, blockIdx.x, threadIdx.x);
  float bt = r.seed;
  stage_wait(&bar);
  int i = 0, ip = 0;   // ip = i % P, kept without a division
#pragma unroll 1
  while (i < steps) {
    float t0 = keep_nearest(micro_smem[ip], r, bt);
    int step = __syncthreads_or(t0 < bt) ? 1 : 2;
    i += step;
    ip += step;   // < P + 2: two subtractions at most (P = 1)
    if (ip >= P) ip -= P;
    if (ip >= P) ip -= P;
  }
  tile_store(out, bt);
}

// --- b: dense loop over P spheres, no decisions ---------------------------
__global__ void __launch_bounds__(SPLIT_THREADS, 8)
    dense_fori_kernel(const float* __restrict__ rays, int T,
                      const float* __restrict__ pf, int P,
                      float* __restrict__ out) {
  __shared__ uint64_t bar;
  stage_rows(pf, 16u * P, &bar);
  const int tile = blockIdx.x / SPLIT;
  const int ray = (blockIdx.x % SPLIT) * SPLIT_THREADS + threadIdx.x;
  MRay r = load_ray(rays, T, tile, ray);
  float bt = r.seed;
  stage_wait(&bar);
  int p = 0;
#pragma unroll 1
  for (; p + DENSE_UNROLL <= P; p += DENSE_UNROLL) {
#pragma unroll
    for (int u = 0; u < DENSE_UNROLL; ++u)
      keep_nearest(micro_smem[p + u], r, bt);
  }
#pragma unroll 1
  for (; p < P; ++p) keep_nearest(micro_smem[p], r, bt);
  store_at(out, tile, ray, bt);
}

// --- c: dense with a tile-wide gate every LEAF spheres --------------------
template <int LEAF>
__global__ void __launch_bounds__(MICRO_TILE, 2)
    gated_kernel(const float* __restrict__ rays, int T,
                 const float* __restrict__ pf, int P,
                 float* __restrict__ out) {
  __shared__ uint64_t bar;
  stage_rows(pf, 16u * P, &bar);
  MRay r = load_ray(rays, T, blockIdx.x, threadIdx.x);
  float bt = r.seed;
  stage_wait(&bar);
  int n_leaves = P / LEAF;
#pragma unroll 1
  for (int l = 0; l < n_leaves; ++l) {
    // JAX's weak-typed 0.05 * int32 l: a float32 product
    if (__syncthreads_or(bt > 0.05f * (float)l)) {
#pragma unroll
      for (int k = 0; k < LEAF; ++k)
        keep_nearest(micro_smem[l * LEAF + k], r, bt);
    }
  }
  tile_store(out, bt);
}

// --- d: packed-bit readout, then a loop over the set bits -----------------
// bit k of word w is the hit of lane w*21 + k of sub-row 0 for w < 7 (word
// 6 holds lanes 126 and 127 only) and of sub-row 1's lane k for w = 7;
// ballot[i] holds the hits of threads 32i .. 32i + 31
__device__ __forceinline__ unsigned tile_word(const unsigned* ballot, int w) {
  if (w == 7) return ballot[MICRO_LANES / 32] & 0x1FFFFFu;
  const int j = 21 * w, q = j >> 5;
  const uint64_t pair =
      ((uint64_t)(q + 1 < MICRO_LANES / 32 ? ballot[q + 1] : 0u) << 32) |
      ballot[q];
  const int width = min(21, MICRO_LANES - j);
  return (unsigned)(pair >> (j & 31)) & ((1u << width) - 1u);
}

__global__ void __launch_bounds__(MICRO_TILE, 2)
    bits168_kernel(const float* __restrict__ rays, int T,
                   const float* __restrict__ pf, float* __restrict__ out) {
  __shared__ uint64_t bar;
  __shared__ unsigned ballot[MICRO_LANES / 32 + 1];
  stage_rows(pf, 16u * BITS_SPHERES, &bar);
  MRay r = load_ray(rays, T, blockIdx.x, threadIdx.x);
  float bt = r.seed;
  unsigned b = __ballot_sync(0xFFFFFFFFu, (r.ox + r.dx) > 0.0f);
  int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && warp <= MICRO_LANES / 32) ballot[warp] = b;
  __syncthreads();
  stage_wait(&bar);
#pragma unroll 1
  for (int w = 0; w < 8; ++w) {
    unsigned word = tile_word(ballot, w);
#pragma unroll 1
    while (word) {
      int k = __ffs(word) - 1;
      word &= word - 1;
      keep_nearest(micro_smem[w * 21 + k], r, bt);
    }
  }
  tile_store(out, bt);
}

// --- e: lane-parallel sphere blocks ---------------------------------------
// pf_lane: (4, 8, 128) field-major, sphere s at [q][s]
__global__ void __launch_bounds__(SPLIT_THREADS, 8)
    lane8x128_kernel(const float* __restrict__ rays, int T,
                     const float* __restrict__ pfl,
                     float* __restrict__ out) {
  const int tile = blockIdx.x / SPLIT;
  const int ray = (blockIdx.x % SPLIT) * SPLIT_THREADS + threadIdx.x;
  MRay r = load_ray(rays, T, tile, ray);
  float bt = r.seed;
  const int lane = ray % MICRO_LANES;
#pragma unroll
  for (int sb = 0; sb < 8; ++sb) {
    int s = sb * MICRO_LANES + lane;
    float t0, t1;
    sph(pfl[s], pfl[MICRO_TILE + s], pfl[2 * MICRO_TILE + s],
        pfl[3 * MICRO_TILE + s], r, t0, t1);
    bt = fminf(bt, t0);
  }
  store_at(out, tile, ray, bt);
}

// --- f: all-pairs (1024 rays) x (128 spheres) on the tensor cores ---------
// One warpgroup (128 threads) per 64 rays, 16 blocks per tile.  D (64 rays
// x 128 spheres, float32) = A (64 x 8 ray features) . B (8 x 128 sphere
// features) runs as two halves of 64 spheres, each one wgmma.mma_async
// m64n64k8 TF32 per split part: ptxas needs 90 registers for an m64n128
// accumulator (it refuses the kernel under __launch_bounds__(128, 6)),
// which leaves 5 blocks on an SM; the n64 halves hold 32 accumulator
// registers and fit 8 (58 registers), and ran 11% faster in turns.
// A and B are TF32, K-major (tf32 wgmma reads both operands K-major), in
// the no-swizzle canonical layout: core matrices of 8 rows x 16 bytes (4
// TF32), core matrix (row / 8, k / 4) at (row / 8) * MXU_SBO + (k / 4) *
// MXU_LBO bytes, the descriptor's stride and leading byte offsets (CUTLASS:
// ((8,m),(T,2)):((1T,SBO),(1,LBO))).  The block writes its A (its rays,
// split) and B (the 128 centres, staged by one bulk copy, split) into
// shared memory, fences them to the async proxy, and per half issues the
// three products of the 3xTF32 split (small x big, big x small, big x big)
// into one accumulator, in wgmma's D layout (warp w holds rows 16w ..
// 16w + 15; lane (g, c) = (lane / 4, lane % 4) holds, for column block j,
// d[4j], d[4j + 1] of row 16w + g and d[4j + 2], d[4j + 3] of row 16w + g
// + 8).  The epilogue (mxu_t0, the running min over the half's columns)
// runs on those registers; the four lanes of a row combine by shuffles.
constexpr int MXU_RAYS = 64;                        // wgmma M
constexpr int MXU_THREADS = 128;                    // one warpgroup
constexpr int MXU_N = MICRO_LANES;                  // spheres
constexpr int MXU_HALF = MXU_N / 2;                 // wgmma N
constexpr int MXU_ACC = MXU_HALF / 2;               // accumulators a thread
constexpr int MXU_SPLIT = MICRO_TILE / MXU_RAYS;    // blocks per tile
constexpr int MXU_LBO = 128;   // bytes between the two core matrices in K
constexpr int MXU_SBO = 256;   // bytes between 8-row groups

struct __align__(128) MxuSmem {
  float a_big[MXU_RAYS * 8];
  float a_small[MXU_RAYS * 8];
  float b_big[MXU_N * 8];
  float b_small[MXU_N * 8];
  float centre[3][MXU_N];
  uint64_t bar;
};

// float index of element (row, k) of a K-major operand of 8 TF32 a row
__device__ __forceinline__ int kmajor(int row, int k) {
  return (row >> 3) * (MXU_SBO / 4) + (k >> 2) * (MXU_LBO / 4) +
         (row & 7) * 4 + (k & 3);
}

// wgmma's shared-memory matrix descriptor of an operand at p: start
// address, leading and stride byte offsets (all >> 4), no swizzle
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)(MXU_LBO >> 4) << 16) | ((uint64_t)(MXU_SBO >> 4) << 32);
}

__device__ __forceinline__ uint32_t tf32_big(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y & 0xFFFFE000u;
}

// x = big + small to ~22 bits: both TF32
__device__ __forceinline__ void tf32_split(float x, float& big,
                                           float& small) {
  big = __uint_as_float(tf32_big(x));
  small = __uint_as_float(tf32_big(x - big));
}

// four consecutive K of one row, split, into the big and small operands
__device__ __forceinline__ void put_split4(float* big, float* small, int row,
                                           int k0, const float* v) {
  float4 b, s;
  tf32_split(v[0], b.x, s.x);
  tf32_split(v[1], b.y, s.y);
  tf32_split(v[2], b.z, s.z);
  tf32_split(v[3], b.w, s.w);
  *reinterpret_cast<float4*>(big + kmajor(row, k0)) = b;
  *reinterpret_cast<float4*>(small + kmajor(row, k0)) = s;
}

// d += A . B, one m64n64k8 TF32 product from shared memory
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product's fence and wait
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < MXU_ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// t0 of tools/micro_prims.py:210-212 for one product vm
__device__ __forceinline__ float mxu_t0(float vm) {
  float disc = vm * vm - 0.05f;
  bool ok = disc >= 0.0f;
  float t0 = vm - sqrtf(ok ? fmaxf(disc, 0.0f) : 1.0f);   // as in sph
  return ok ? t0 : 1e6f;
}

__global__ void __launch_bounds__(MXU_THREADS, 8)
    mxu128_kernel(const float* __restrict__ rays, int T,
                  const float* __restrict__ pfl, float* __restrict__ out) {
  __shared__ MxuSmem sm;
  const int t = threadIdx.x;
  const int tile = blockIdx.x / MXU_SPLIT;
  const int ray0 = (blockIdx.x % MXU_SPLIT) * MXU_RAYS;
  if (t == 0) stage_init(&sm.bar);
  __syncthreads();
  if (t == 0) {
    // the centres: rows 0-2 of block 0 of pf_lane, 512 bytes each
    stage_expect(&sm.bar, 3 * MXU_N * 4);
    for (int k = 0; k < 3; ++k)
      stage_copy(sm.centre[k], pfl + k * MICRO_TILE, MXU_N * 4, &sm.bar);
  }
  // A: ray features [dx dy dz ox oy oz 1 0] (tools/micro_prims.py:199);
  // thread t writes K 4h .. 4h + 3 of ray t % 64, h = t / 64
  {
    const int r = t % MXU_RAYS, ray = ray0 + r;
    float v[4];
    if (t < MXU_RAYS) {
      v[0] = ray_at(rays, T, 3, tile, ray);
      v[1] = ray_at(rays, T, 4, tile, ray);
      v[2] = ray_at(rays, T, 5, tile, ray);
      v[3] = ray_at(rays, T, 0, tile, ray);
    } else {
      v[0] = ray_at(rays, T, 1, tile, ray);
      v[1] = ray_at(rays, T, 2, tile, ray);
      v[2] = 1.0f;
      v[3] = 0.0f;
    }
    put_split4(sm.a_big, sm.a_small, r, 4 * (t / MXU_RAYS), v);
  }
  stage_wait(&sm.bar);
  // B: sphere t's features [cx cy cz, -c * 0 (three), 0, 0]
  // (tools/micro_prims.py:203-207)
  {
    const float cx = sm.centre[0][t], cy = sm.centre[1][t],
                cz = sm.centre[2][t];
    const float lo[4] = {cx, cy, cz, -cx * 0.0f};
    const float hi[4] = {-cy * 0.0f, -cz * 0.0f, 0.0f, 0.0f};
    put_split4(sm.b_big, sm.b_small, t, 0, lo);
    put_split4(sm.b_big, sm.b_small, t, 4, hi);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int lane = t & 31, g = lane >> 2, c = lane & 3;
  const float inf = __int_as_float(0x7F800000);
  float m0 = inf, m1 = inf;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int b0 = kmajor(half * MXU_HALF, 0);   // this half's B rows
    float d[MXU_ACC];
#pragma unroll
    for (int i = 0; i < MXU_ACC; ++i) d[i] = 0.0f;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_m64n64k8_tf32(d, smem_desc(sm.a_small), smem_desc(sm.b_big + b0));
    wgmma_m64n64k8_tf32(d, smem_desc(sm.a_big), smem_desc(sm.b_small + b0));
    wgmma_m64n64k8_tf32(d, smem_desc(sm.a_big), smem_desc(sm.b_big + b0));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
#pragma unroll
    for (int j = 0; j < MXU_ACC / 4; ++j) {
      m0 = fminf(m0, fminf(mxu_t0(d[4 * j]), mxu_t0(d[4 * j + 1])));
      m1 = fminf(m1, fminf(mxu_t0(d[4 * j + 2]), mxu_t0(d[4 * j + 3])));
    }
  }
  // the four lanes of a row hold its 128 columns between them
  m0 = fminf(m0, __shfl_xor_sync(0xFFFFFFFFu, m0, 1));
  m0 = fminf(m0, __shfl_xor_sync(0xFFFFFFFFu, m0, 2));
  m1 = fminf(m1, __shfl_xor_sync(0xFFFFFFFFu, m1, 1));
  m1 = fminf(m1, __shfl_xor_sync(0xFFFFFFFFu, m1, 2));
  if (c == 0) {
    const int ray = ray0 + 16 * (t >> 5) + g;
    store_at(out, tile, ray, fminf(ray_at(rays, T, 6, tile, ray), m0));
    store_at(out, tile, ray + 8,
             fminf(ray_at(rays, T, 6, tile, ray + 8), m1));
  }
}

// --- the launch floor: a kernel of a variant's grid that only stores ------
// Each of blocks_per_tile blocks of a tile stores its share of the tile
// (float4 stores where the share is four floats a thread), nothing else.
__global__ void store_tile_kernel(int per_block, float* __restrict__ out) {
  float* o = out + (size_t)blockIdx.x * per_block;
  if (per_block == 4 * (int)blockDim.x) {
    reinterpret_cast<float4*>(o)[threadIdx.x] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int i = threadIdx.x; i < per_block; i += blockDim.x) o[i] = 0.0f;
  }
}

// --- C entries ------------------------------------------------------------
// Each launches its grid on `stream` and returns the launch's cudaError:
// cudaErrorInvalidValue for a table too small or a table (or output) not
// 16-byte aligned, which the bulk copies and float4 stores need.

static inline cudaStream_t as_stream(void* s) { return (cudaStream_t)s; }

// a staged table of `bytes` in dynamic shared memory: above the default
// 48 KB the kernel must opt in (the card's limit then refuses the launch)
template <typename Kernel>
static cudaError_t smem_opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" int glome_micro_vote_while(const float* rays, int T,
                                      const float* pf, int P, int steps,
                                      float* out, void* stream) {
  if (P <= 0 || !host_aligned16(pf)) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  size_t smem = 16 * (size_t)P;
  cudaError_t e = smem_opt_in(vote_while_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  vote_while_kernel<<<T, MICRO_TILE, smem, as_stream(stream)>>>(
      rays, T, pf, P, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_dense_fori(const float* rays, int T,
                                      const float* pf, int P, float* out,
                                      void* stream) {
  if (P <= 0 || !host_aligned16(pf)) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  size_t smem = 16 * (size_t)P;
  cudaError_t e = smem_opt_in(dense_fori_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dense_fori_kernel<<<T * SPLIT, SPLIT_THREADS, smem, as_stream(stream)>>>(
      rays, T, pf, P, out);
  return (int)cudaGetLastError();
}

template <int LEAF>
static int launch_gated(const float* rays, int T, const float* pf, int P,
                        float* out, void* stream) {
  if (P <= 0 || !host_aligned16(pf)) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  size_t smem = 16 * (size_t)P;
  cudaError_t e = smem_opt_in(gated_kernel<LEAF>, smem);
  if (e != cudaSuccess) return (int)e;
  gated_kernel<LEAF><<<T, MICRO_TILE, smem, as_stream(stream)>>>(rays, T, pf,
                                                                  P, out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_gate8(const float* rays, int T, const float* pf,
                                 int P, float* out, void* stream) {
  return launch_gated<8>(rays, T, pf, P, out, stream);
}

extern "C" int glome_micro_gate16(const float* rays, int T, const float* pf,
                                  int P, float* out, void* stream) {
  return launch_gated<16>(rays, T, pf, P, out, stream);
}

extern "C" int glome_micro_gate32(const float* rays, int T, const float* pf,
                                  int P, float* out, void* stream) {
  return launch_gated<32>(rays, T, pf, P, out, stream);
}

extern "C" int glome_micro_bits168(const float* rays, int T, const float* pf,
                                   int P, float* out, void* stream) {
  if (P < BITS_SPHERES || !host_aligned16(pf))
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  bits168_kernel<<<T, MICRO_TILE, 16 * BITS_SPHERES, as_stream(stream)>>>(
      rays, T, pf, out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_lane8x128(const float* rays, int T,
                                     const float* pf_lane, float* out,
                                     void* stream) {
  if (T <= 0) return 0;
  lane8x128_kernel<<<T * SPLIT, SPLIT_THREADS, 0, as_stream(stream)>>>(
      rays, T, pf_lane, out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_mxu128(const float* rays, int T,
                                  const float* pf_lane, float* out,
                                  void* stream) {
  if (!host_aligned16(pf_lane)) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  mxu128_kernel<<<T * MXU_SPLIT, MXU_THREADS, 0, as_stream(stream)>>>(
      rays, T, pf_lane, out);
  return (int)cudaGetLastError();
}

// T * blocks_per_tile blocks of `threads`, each storing 1024 /
// blocks_per_tile floats of `out` (rays unused: the signature of the
// variants' entries, so one launcher serves all)
extern "C" int glome_micro_store_tile(const float* rays, int T,
                                      int blocks_per_tile, int threads,
                                      float* out, void* stream) {
  (void)rays;
  if (blocks_per_tile <= 0 || MICRO_TILE % blocks_per_tile || threads <= 0 ||
      !host_aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  store_tile_kernel<<<T * blocks_per_tile, threads, 0, as_stream(stream)>>>(
      MICRO_TILE / blocks_per_tile, out);
  return (int)cudaGetLastError();
}
