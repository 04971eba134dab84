// Per-primitive entry/exit distances and strict inside tests, one ray
// (or point) per thread.  Device-side mirror of glome_tpu's
// pallas_kernels._T_KERNELS / _inside_comp and of the plain torch
// versions in glome_tpu_torch/megakernel.py: same formulas, same INF
// (1e6) for absent crossings, same 1e18 slab sentinels.  Parameters are
// one row of the PF table, in glome_tpu_torch.megakernel.FIELDS order.
#pragma once

#include <cuda_runtime.h>

#define GLOME_INF 1.0e6f
#define GLOME_BIG 1.0e18f

// ptype codes (glome_tpu_torch.megakernel.PTYPE_CODE)
enum PType {
  PT_SPHERE = 0,
  PT_PLANE = 1,
  PT_BOX = 2,
  PT_TRIANGLE = 3,
  PT_TRIANGLENORM = 4,
  PT_DISC = 5,
  PT_CYLINDER = 6,
  PT_CONE = 7
};

__device__ __forceinline__ float safe_nz(float x) {
  return x == 0.0f ? 1.0f : x;
}

__device__ __forceinline__ void sphere_t(const float* p, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float& t0, float& t1) {
  float ex = p[0] - ox, ey = p[1] - oy, ez = p[2] - oz, r = p[3];
  float v = ex * dx + ey * dy + ez * dz;
  float disc = r * r - (ex * ex + ey * ey + ez * ez - v * v);
  if (disc >= 0.0f) {
    float sq = sqrtf(disc);
    t0 = v - sq;
    t1 = v + sq;
  } else {
    t0 = GLOME_INF;
    t1 = GLOME_INF;
  }
}

__device__ __forceinline__ void plane_t(const float* p, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float& t0, float& t1) {
  float dn = p[0] * dx + p[1] * dy + p[2] * dz;
  float t = -(p[0] * ox + p[1] * oy + p[2] * oz - p[3]) / safe_nz(dn);
  if (dn == 0.0f) t = GLOME_INF;
  bool entering = dn < 0.0f;
  t0 = entering ? t : GLOME_INF;
  t1 = entering ? GLOME_INF : t;
}

__device__ __forceinline__ void slab1(float lo, float hi, float o, float d,
                                      float& tin, float& tout) {
  if (d == 0.0f) {
    bool ins = (o > lo) && (o < hi);
    tin = ins ? -GLOME_BIG : GLOME_BIG;
    tout = ins ? GLOME_BIG : -GLOME_BIG;
    return;
  }
  float inv = 1.0f / d;
  float ta = (lo - o) * inv;
  float tb = (hi - o) * inv;
  tin = fminf(ta, tb);
  tout = fmaxf(ta, tb);
}

__device__ __forceinline__ void box_t(const float* p, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float& t0, float& t1) {
  float ix, axo, iy, ayo, iz, azo;
  slab1(p[0], p[3], ox, dx, ix, axo);
  slab1(p[1], p[4], oy, dy, iy, ayo);
  slab1(p[2], p[5], oz, dz, iz, azo);
  float lastin = fmaxf(fmaxf(ix, iy), iz);
  float firstout = fminf(fminf(axo, ayo), azo);
  bool ok = lastin <= firstout;
  t0 = ok ? lastin : GLOME_INF;
  t1 = ok ? firstout : GLOME_INF;
}

__device__ __forceinline__ void triangle_t(const float* p, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float& t0,
                                           float& t1) {
  float p1x = p[0], p1y = p[1], p1z = p[2];
  float e1x = p[3] - p1x, e1y = p[4] - p1y, e1z = p[5] - p1z;
  float e2x = p[6] - p1x, e2y = p[7] - p1y, e2z = p[8] - p1z;
  float s1x = dy * e2z - dz * e2y;
  float s1y = dz * e2x - dx * e2z;
  float s1z = dx * e2y - dy * e2x;
  float div = s1x * e1x + s1y * e1y + s1z * e1z;
  bool ok = div != 0.0f;
  float inv = 1.0f / safe_nz(div);
  float ddx = ox - p1x, ddy = oy - p1y, ddz = oz - p1z;
  float b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv;
  ok = ok && (b1 >= 0.0f) && (b1 <= 1.0f);
  float s2x = ddy * e1z - ddz * e1y;
  float s2y = ddz * e1x - ddx * e1z;
  float s2z = ddx * e1y - ddy * e1x;
  float b2 = (dx * s2x + dy * s2y + dz * s2z) * inv;
  ok = ok && (b2 >= 0.0f) && (b1 + b2 <= 1.0f);
  float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
  t0 = ok ? t : GLOME_INF;
  t1 = GLOME_INF;
}

__device__ __forceinline__ void disc_t(const float* p, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float& t0, float& t1) {
  float px = p[0], py = p[1], pz = p[2];
  float nx = p[3], ny = p[4], nz = p[5], rsqr = p[6];
  float dn = nx * dx + ny * dy + nz * dz;
  float t = -(nx * (ox - px) + ny * (oy - py) + nz * (oz - pz)) / safe_nz(dn);
  float hx = ox + dx * t - px;
  float hy = oy + dy * t - py;
  float hz = oz + dz * t - pz;
  bool ok = (dn != 0.0f) && (hx * hx + hy * hy + hz * hz <= rsqr);
  t0 = ok ? t : GLOME_INF;
  t1 = GLOME_INF;
}

// roots of a t^2 + b t + c by the q-trick (Cone.hs:113-118)
__device__ __forceinline__ bool roots(float a, float b, float c, float& lo,
                                      float& hi) {
  float disc = b * b - 4.0f * a * c;
  bool ok = disc >= 0.0f;
  float sq = sqrtf(ok ? disc : 0.0f);
  float q = (b < 0.0f) ? (b - sq) * -0.5f : (b + sq) * -0.5f;
  float r0 = q / safe_nz(a);
  float r1 = c / safe_nz(q);
  lo = fminf(r0, r1);
  hi = fmaxf(r0, r1);
  return ok;
}

__device__ __forceinline__ void cylinder_t(const float* p, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float& t0,
                                           float& t1) {
  float r = p[0], h1 = p[1], h2 = p[2];
  float a = dx * dx + dy * dy;
  float b = 2.0f * (dx * ox + dy * oy);
  float c = ox * ox + oy * oy - r * r;
  float lo, hi;
  bool ok = roots(a, b, c, lo, hi);
  if (a == 0.0f) {
    bool inc = c < 0.0f;
    lo = inc ? -GLOME_INF : GLOME_INF;
    hi = inc ? GLOME_INF : -GLOME_INF;
  } else if (!ok) {
    lo = GLOME_INF;
    hi = -GLOME_INF;
  }
  float zlo, zhi;
  slab1(h1, h2, oz, dz, zlo, zhi);
  float a0 = fmaxf(lo, zlo);
  float a1 = fminf(hi, zhi);
  bool empty = a0 > a1;
  t0 = empty ? GLOME_INF : a0;
  t1 = empty ? GLOME_INF : a1;
}

__device__ __forceinline__ void cone_t(const float* p, float ox, float oy,
                                       float oz, float dx, float dy, float dz,
                                       float& t0, float& t1) {
  float r = p[0], clip1 = p[1], clip2 = p[2], height = p[3];
  float kp = r / height;
  float k = kp * kp;
  float a = dx * dx + dy * dy - k * dz * dz;
  float b = 2.0f * (dx * ox + dy * oy - k * dz * (oz - height));
  float c = ox * ox + oy * oy - k * (oz - height) * (oz - height);
  float lo, hi;
  bool ok = roots(a, b, c, lo, hi);
  float flo, fhi;
  if (a > 0.0f) {
    flo = ok ? lo : GLOME_INF;
    fhi = ok ? hi : -GLOME_INF;
  } else if (a < 0.0f) {
    // on the tails: within the z-slab only one applies, by sign(dz)
    flo = ok ? (dz > 0.0f ? -GLOME_INF : hi) : -GLOME_INF;
    fhi = ok ? (dz > 0.0f ? lo : GLOME_INF) : GLOME_INF;
  } else if (b == 0.0f) {
    flo = c < 0.0f ? -GLOME_INF : GLOME_INF;
    fhi = c < 0.0f ? GLOME_INF : -GLOME_INF;
  } else {
    // parallel to the cone surface: f is linear in t
    float lin_t = -c / b;
    flo = b < 0.0f ? lin_t : -GLOME_INF;
    fhi = b < 0.0f ? GLOME_INF : lin_t;
  }
  float zlo, zhi;
  slab1(clip1, clip2, oz, dz, zlo, zhi);
  float a0 = fmaxf(flo, zlo);
  float a1 = fminf(fhi, zhi);
  bool empty = a0 > a1;
  t0 = empty ? GLOME_INF : a0;
  t1 = empty ? GLOME_INF : a1;
}

__device__ __forceinline__ void prim_t(int ptype, const float* p, float ox,
                                       float oy, float oz, float dx,
                                       float dy, float dz, float& t0,
                                       float& t1) {
  switch (ptype) {
    case PT_SPHERE: sphere_t(p, ox, oy, oz, dx, dy, dz, t0, t1); break;
    case PT_PLANE: plane_t(p, ox, oy, oz, dx, dy, dz, t0, t1); break;
    case PT_BOX: box_t(p, ox, oy, oz, dx, dy, dz, t0, t1); break;
    case PT_TRIANGLE:
    case PT_TRIANGLENORM:
      triangle_t(p, ox, oy, oz, dx, dy, dz, t0, t1);
      break;
    case PT_DISC: disc_t(p, ox, oy, oz, dx, dy, dz, t0, t1); break;
    case PT_CYLINDER: cylinder_t(p, ox, oy, oz, dx, dy, dz, t0, t1); break;
    case PT_CONE: cone_t(p, ox, oy, oz, dx, dy, dz, t0, t1); break;
    default: t0 = GLOME_INF; t1 = GLOME_INF; break;
  }
}

// strict point-in-solid; surface prims have no volume
__device__ __forceinline__ bool inside_comp(int ptype, const float* c,
                                            float x, float y, float z) {
  switch (ptype) {
    case PT_SPHERE: {
      float ex = c[0] - x, ey = c[1] - y, ez = c[2] - z;
      return ex * ex + ey * ey + ez * ez < c[3] * c[3];
    }
    case PT_PLANE:
      return c[0] * x + c[1] * y + c[2] * z < c[3];
    case PT_BOX:
      return (x > c[0]) && (x < c[3]) && (y > c[1]) && (y < c[4]) &&
             (z > c[2]) && (z < c[5]);
    case PT_CYLINDER:
      return (z > c[1]) && (z < c[2]) && (x * x + y * y < c[0] * c[0]);
    case PT_CONE: {
      float rz = c[0] * (1.0f - (z - c[1]) / c[3]);
      return (z > c[1]) && (z < c[2]) && (x * x + y * y < rz * rz);
    }
    default:
      return false;
  }
}
