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
// operations per ray and sphere test, 67 TFLOP/s); a is a chain of 256
// block-wide votes, each a barrier; e and f are a few microseconds, about
// one launch, so their event times read the launch as much as the work.
//
// Design.  One block of 1024 threads per tile, since a, c and d decide
// for the whole tile: the TPU's jnp.any over its (8, 128) vector is
// __syncthreads_or here (a warp-level __any_sync would be a different
// function), and d's mask is five warp ballots re-indexed to the TPU's
// word layout.  Sphere rows are read as uniform loads (every thread the
// same address), the card's counterpart of the TPU's SMEM scalars.  f is a
// hand-written mma.sync.m16n8k8 TF32 product: K = 8 is one k-step; each
// warp takes 32 rays (two m16 tiles) against 16 n8 tiles of spheres, with
// the 3xTF32 split (big and small parts, three products) so that the
// result meets float32: one TF32 pass moves the product by ~1e-3
// relative, and disc = vm^2 - 0.05 turns that into wrong hits near 0.
// Its epilogue (sqrt, select, the 128-wide min) stays in registers, with
// the four threads that share a row combined by shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "micro.cuh"

struct MRay {
  float ox, oy, oz, dx, dy, dz, seed;
};

__device__ __forceinline__ MRay load_mray(const float* __restrict__ rays,
                                          int T) {
  return MRay{tile_ray(rays, T, 0), tile_ray(rays, T, 1),
              tile_ray(rays, T, 2), tile_ray(rays, T, 3),
              tile_ray(rays, T, 4), tile_ray(rays, T, 5),
              tile_ray(rays, T, 6)};
}

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
  float sq = sqrtf(fmaxf(disc, 0.0f));
  t0 = ok ? v - sq : 1e6f;
  t1 = ok ? v + sq : 1e6f;
}

// sphere p of the row-major [cx cy cz r2] table: bt = min(bt, t0 > 0 ?
// t0 : t1); returns t0
__device__ __forceinline__ float keep_nearest(const float* __restrict__ pf,
                                              int p, const MRay& r,
                                              float& bt) {
  const float* s = pf + 4 * p;
  float t0, t1;
  sph(__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3), r, t0, t1);
  bt = fminf(bt, t0 > 0.0f ? t0 : t1);
  return t0;
}

// --- a: while loop with a tile-wide vote per step -------------------------
__global__ void __launch_bounds__(MICRO_TILE)
    vote_while_kernel(const float* __restrict__ rays, int T,
                      const float* __restrict__ pf, int P, int steps,
                      float* __restrict__ out) {
  MRay r = load_mray(rays, T);
  float bt = r.seed;
  int i = 0;
  while (i < steps) {
    float t0 = keep_nearest(pf, i % P, r, bt);
    i += __syncthreads_or(t0 < bt) ? 1 : 2;
  }
  tile_store(out, bt);
}

// --- b: dense loop over P spheres, no decisions ---------------------------
__global__ void __launch_bounds__(MICRO_TILE)
    dense_fori_kernel(const float* __restrict__ rays, int T,
                      const float* __restrict__ pf, int P,
                      float* __restrict__ out) {
  MRay r = load_mray(rays, T);
  float bt = r.seed;
  for (int p = 0; p < P; ++p) keep_nearest(pf, p, r, bt);
  tile_store(out, bt);
}

// --- c: dense with a tile-wide gate every LEAF spheres --------------------
template <int LEAF>
__global__ void __launch_bounds__(MICRO_TILE)
    gated_kernel(const float* __restrict__ rays, int T,
                 const float* __restrict__ pf, int P,
                 float* __restrict__ out) {
  MRay r = load_mray(rays, T);
  float bt = r.seed;
  int n_leaves = P / LEAF;
  for (int l = 0; l < n_leaves; ++l) {
    // JAX's weak-typed 0.05 * int32 l: a float32 product
    if (__syncthreads_or(bt > 0.05f * (float)l)) {
#pragma unroll
      for (int k = 0; k < LEAF; ++k) keep_nearest(pf, l * LEAF + k, r, bt);
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
  unsigned v = 0;
  for (int k = 0; k < 21; ++k) {
    int j = 21 * w + k;
    if (j < MICRO_LANES && ((ballot[j >> 5] >> (j & 31)) & 1u)) v |= 1u << k;
  }
  return v;
}

__global__ void __launch_bounds__(MICRO_TILE)
    bits168_kernel(const float* __restrict__ rays, int T,
                   const float* __restrict__ pf, float* __restrict__ out) {
  __shared__ unsigned ballot[MICRO_LANES / 32 + 1];
  MRay r = load_mray(rays, T);
  float bt = r.seed;
  unsigned b = __ballot_sync(0xFFFFFFFFu, (r.ox + r.dx) > 0.0f);
  int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0 && warp <= MICRO_LANES / 32) ballot[warp] = b;
  __syncthreads();
  for (int w = 0; w < 8; ++w) {
    unsigned word = tile_word(ballot, w);
    while (word) {
      int k = __ffs(word) - 1;
      word &= word - 1;
      keep_nearest(pf, w * 21 + k, r, bt);
    }
  }
  tile_store(out, bt);
}

// --- e: lane-parallel sphere blocks ---------------------------------------
// pf_lane: (4, 8, 128) field-major, sphere s at [q][s]
__global__ void __launch_bounds__(MICRO_TILE)
    lane8x128_kernel(const float* __restrict__ rays, int T,
                     const float* __restrict__ pfl,
                     float* __restrict__ out) {
  MRay r = load_mray(rays, T);
  float bt = r.seed;
  int lane = threadIdx.x % MICRO_LANES;
  for (int sb = 0; sb < 8; ++sb) {
    int s = sb * MICRO_LANES + lane;
    float t0, t1;
    sph(pfl[s], pfl[MICRO_TILE + s], pfl[2 * MICRO_TILE + s],
        pfl[3 * MICRO_TILE + s], r, t0, t1);
    bt = fminf(bt, t0);
  }
  tile_store(out, bt);
}

// --- f: all-pairs (1024 rays) x (128 spheres) on the tensor cores ---------
__device__ __forceinline__ uint32_t tf32_big(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y & 0xFFFFE000u;
}

// x = big + small to ~22 bits: both TF32
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_big(x);
  small = tf32_big(x - __uint_as_float(big));
}

// d += a * b, one m16n8k8 TF32 tile (PTX ISA fragment layouts: with
// g = lane / 4, c = lane % 4, a0..a3 = A[g][c], A[g+8][c], A[g][c+4],
// A[g+8][c+4]; b0, b1 = B[c][g], B[c+4][g]; d0..d3 = D[g][2c], D[g][2c+1],
// D[g+8][2c], D[g+8][2c+1])
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// feature k of ray `ray`: [dx dy dz ox oy oz 1 0] (tools/micro_prims.py:199)
__device__ __forceinline__ float ray_feature(const float* __restrict__ rays,
                                             int T, int ray, int k) {
  const int comp[6] = {3, 4, 5, 0, 1, 2};
  if (k >= 6) return k == 6 ? 1.0f : 0.0f;
  return rays[((size_t)comp[k] * T + blockIdx.x) * MICRO_TILE + ray];
}

// feature k of sphere s: [cx cy cz, -c * 0 (three rows), 0, 0]
// (tools/micro_prims.py:203-207); centres from block 0 of pf_lane
__device__ __forceinline__ float sphere_feature(const float* __restrict__ pfl,
                                                int s, int k) {
  if (k < 3) return pfl[k * MICRO_TILE + s];
  if (k < 6) return -pfl[(k - 3) * MICRO_TILE + s] * 0.0f;
  return 0.0f;
}

// t0 of tools/micro_prims.py:210-212 for one product vm
__device__ __forceinline__ float mxu_t0(float vm) {
  float disc = vm * vm - 0.05f;
  float t0 = vm - sqrtf(fmaxf(disc, 0.0f));
  return disc >= 0.0f ? t0 : 1e6f;
}

__global__ void __launch_bounds__(MICRO_TILE)
    mxu128_kernel(const float* __restrict__ rays, int T,
                  const float* __restrict__ pfl, float* __restrict__ out) {
  __shared__ float row_min[MICRO_TILE];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int warp_ray = (threadIdx.x >> 5) * 32;
  // A fragments of the warp's two m16 tiles (rows = rays), split
  uint32_t a_big[2][4], a_small[2][4];
  for (int mt = 0; mt < 2; ++mt) {
    int r0 = warp_ray + mt * 16 + g;
    float av[4] = {ray_feature(rays, T, r0, c), ray_feature(rays, T, r0 + 8, c),
                   ray_feature(rays, T, r0, c + 4),
                   ray_feature(rays, T, r0 + 8, c + 4)};
    for (int q = 0; q < 4; ++q) tf32_split(av[q], a_big[mt][q], a_small[mt][q]);
  }
  const float inf = __int_as_float(0x7F800000);
  float m[2][2] = {{inf, inf}, {inf, inf}};
  for (int nt = 0; nt < MICRO_LANES / 8; ++nt) {
    int s = nt * 8 + g;
    uint32_t b_big[2], b_small[2];
    tf32_split(sphere_feature(pfl, s, c), b_big[0], b_small[0]);
    tf32_split(sphere_feature(pfl, s, c + 4), b_big[1], b_small[1]);
    for (int mt = 0; mt < 2; ++mt) {
      // 3xTF32: the small cross terms first, then big x big
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(d, a_small[mt], b_big);
      mma_tf32(d, a_big[mt], b_small);
      mma_tf32(d, a_big[mt], b_big);
      m[mt][0] = fminf(m[mt][0], fminf(mxu_t0(d[0]), mxu_t0(d[1])));
      m[mt][1] = fminf(m[mt][1], fminf(mxu_t0(d[2]), mxu_t0(d[3])));
    }
  }
  // the four threads of a row group hold its 128 columns between them
  for (int mt = 0; mt < 2; ++mt)
    for (int h = 0; h < 2; ++h) {
      float v = m[mt][h];
      v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
      if (c == 0) row_min[warp_ray + mt * 16 + h * 8 + g] = v;
    }
  __syncwarp();
  tile_store(out, fminf(tile_ray(rays, T, 6), row_min[threadIdx.x]));
}

// --- C entries ------------------------------------------------------------
// Each launches T blocks of 1024 threads on `stream` and returns the
// launch's cudaError (cudaErrorInvalidValue for a table too small).

static inline cudaStream_t as_stream(void* s) { return (cudaStream_t)s; }

extern "C" int glome_micro_vote_while(const float* rays, int T,
                                      const float* pf, int P, int steps,
                                      float* out, void* stream) {
  if (P <= 0) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  vote_while_kernel<<<T, MICRO_TILE, 0, as_stream(stream)>>>(rays, T, pf, P,
                                                              steps, out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_dense_fori(const float* rays, int T,
                                      const float* pf, int P, float* out,
                                      void* stream) {
  if (T <= 0) return 0;
  dense_fori_kernel<<<T, MICRO_TILE, 0, as_stream(stream)>>>(rays, T, pf, P,
                                                              out);
  return (int)cudaGetLastError();
}

template <int LEAF>
static int launch_gated(const float* rays, int T, const float* pf, int P,
                        float* out, void* stream) {
  if (T <= 0) return 0;
  gated_kernel<LEAF><<<T, MICRO_TILE, 0, as_stream(stream)>>>(rays, T, pf,
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
  if (P < 8 * 21) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  bits168_kernel<<<T, MICRO_TILE, 0, as_stream(stream)>>>(rays, T, pf, out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_lane8x128(const float* rays, int T,
                                     const float* pf_lane, float* out,
                                     void* stream) {
  if (T <= 0) return 0;
  lane8x128_kernel<<<T, MICRO_TILE, 0, as_stream(stream)>>>(rays, T, pf_lane,
                                                             out);
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_mxu128(const float* rays, int T,
                                  const float* pf_lane, float* out,
                                  void* stream) {
  if (T <= 0) return 0;
  mxu128_kernel<<<T, MICRO_TILE, 0, as_stream(stream)>>>(rays, T, pf_lane,
                                                          out);
  return (int)cudaGetLastError();
}
