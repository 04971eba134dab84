// Per-ray pieces shared by the select kernels (K1 mega_select.cu, K2
// block_select.cu, K3 mesh_block_select.cu, K4 dense_select.cu, K5
// bvh_select.cu): the ray record, the AABB
// slab test of a BVH walk and the world-space candidate distances of one
// (optionally instance-transformed) prim row.  The plain torch versions
// (glome_tpu_torch/megakernel.py _candidates, block_kernel.py,
// mesh_kernel.py) evaluate the same expressions in the same order, and
// the kernels are built without multiply-add contraction, so both round
// alike.
#pragma once

#include <cuda_runtime.h>

#include "prims.cuh"

struct RayCore {
  float ox, oy, oz, dx, dy, dz;
  float ivx, ivy, ivz;
};

// The ray record.  RayT<true> also tallies its walk's work (box tests,
// prim candidate tests; K1 also its clause work: point-in-node tests of
// member-set point BVHs and member inside tests) for a launch that asks
// for it; every other launch runs RayT<false>, whose counting compiles to
// nothing.  The helpers below and the kernels' walks take the record's
// type as a template parameter.
template <bool kTally>
struct RayT : RayCore {
  __device__ __forceinline__ void count_box() const {}
  __device__ __forceinline__ void count_prim() const {}
  __device__ __forceinline__ void count_point() const {}
  __device__ __forceinline__ void count_member() const {}
  __device__ __forceinline__ void store_tally(int*, int, int) const {}
  __device__ __forceinline__ void store_clause_tally(int*, int, int) const {}
};

template <>
struct RayT<true> : RayCore {
  mutable int n_box = 0, n_prim = 0, n_point = 0, n_member = 0;
  __device__ __forceinline__ void count_box() const { ++n_box; }
  __device__ __forceinline__ void count_prim() const { ++n_prim; }
  __device__ __forceinline__ void count_point() const { ++n_point; }
  __device__ __forceinline__ void count_member() const { ++n_member; }
  // tally[i] = box tests, tally[n + i] = prim tests of ray i
  __device__ __forceinline__ void store_tally(int* __restrict__ tally, int n,
                                              int i) const {
    tally[i] = n_box;
    tally[n + i] = n_prim;
  }
  // tally[2n + i] = point-in-node tests, tally[3n + i] = member tests
  __device__ __forceinline__ void store_clause_tally(int* __restrict__ tally,
                                                     int n, int i) const {
    tally[2 * n + i] = n_point;
    tally[3 * n + i] = n_member;
  }
};

// ray i of an (8, n) float32 component-plane table [o*3, d*3, ...]
template <bool kTally>
__device__ __forceinline__ RayT<kTally> load_ray(
    const float* __restrict__ rays, int n, int i) {
  RayT<kTally> r;
  r.ox = rays[i];
  r.oy = rays[n + i];
  r.oz = rays[2 * n + i];
  r.dx = rays[3 * n + i];
  r.dy = rays[4 * n + i];
  r.dz = rays[5 * n + i];
  r.ivx = 1.0f / (r.dx == 0.0f ? 1e-20f : r.dx);
  r.ivy = 1.0f / (r.dy == 0.0f ? 1e-20f : r.dy);
  r.ivz = 1.0f / (r.dz == 0.0f ? 1e-20f : r.dz);
  return r;
}

// world-space entry/exit distances of one prim row `prm`; transformed rows
// carry the 12 inverse-matrix floats after their nfld fields
template <class Ray>
__device__ __forceinline__ void prim_candidates(int ptype, const float* prm,
                                                bool xf, int nfld,
                                                const Ray& r, float& t0,
                                                float& t1) {
  r.count_prim();
  if (!xf) {
    prim_t(ptype, prm, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t0, t1);
    return;
  }
  const float* m = prm + nfld;
  float pox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[3];
  float poy = m[4] * r.ox + m[5] * r.oy + m[6] * r.oz + m[7];
  float poz = m[8] * r.ox + m[9] * r.oy + m[10] * r.oz + m[11];
  float pdx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
  float pdy = m[4] * r.dx + m[5] * r.dy + m[6] * r.dz;
  float pdz = m[8] * r.dx + m[9] * r.dy + m[10] * r.dz;
  float ils = 1.0f / sqrtf(pdx * pdx + pdy * pdy + pdz * pdz);
  prim_t(ptype, prm, pox, poy, poz, pdx * ils, pdy * ils, pdz * ils, t0, t1);
  if (fabsf(t0) < GLOME_INF) t0 *= ils;
  if (fabsf(t1) < GLOME_INF) t1 *= ils;
}

// the ray's entry and exit distances of an AABB (x0, y0, z0) - (x1, y1,
// z1): one box test
template <class Ray>
__device__ __forceinline__ void box_span(float x0, float y0, float z0,
                                         float x1, float y1, float z1,
                                         const Ray& r, float& near,
                                         float& far) {
  r.count_box();
  float t1x = (x0 - r.ox) * r.ivx, t2x = (x1 - r.ox) * r.ivx;
  float t1y = (y0 - r.oy) * r.ivy, t2y = (y1 - r.oy) * r.ivy;
  float t1z = (z0 - r.oz) * r.ivz, t2z = (z1 - r.oz) * r.ivz;
  near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// slab test of an AABB against the ray and a t limit
template <class Ray>
__device__ __forceinline__ bool box_live6(float x0, float y0, float z0,
                                          float x1, float y1, float z1,
                                          const Ray& r, float lim,
                                          float& near) {
  float far;
  box_span(x0, y0, z0, x1, y1, z1, r, near, far);
  return (near <= far) && (far > 0.0f) && (near < lim);
}

// the same for a box stored as (bmin xyz, bmax xyz)
template <class Ray>
__device__ __forceinline__ bool box_live(const float* b, const Ray& r,
                                         float lim, float& near) {
  return box_live6(b[0], b[1], b[2], b[3], b[4], b[5], r, lim, near);
}

extern "C" const char* glome_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
