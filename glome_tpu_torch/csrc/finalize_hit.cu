// The fused finalize: megakernel.finalize's forward in one launch per
// intersect batch, for calls that need no gradient.
//
// megakernel.finalize re-evaluates each lane's winning candidate (t, wid,
// aux from the select kernels) and assembles the Hit record: t, hit,
// pos, norm, the object-space ray of a Warp-textured transformed prim,
// the texture and tag stacks (with the difference-B retexture) and the
// prim serial.  In torch that is ~700 small ops a call, replayed inside
// the compiled frame's segments.  Here one thread does one lane: it finds
// its prim's group in the per-call group descriptor (megakernel
// _finalize_groups), reads the group's parameter rows in place, runs its
// own primitive's geom.*_hits2 and writes the same Hit, bit for bit.
//
// Bit equality.  The kernel is built without multiply-add contraction
// (kernels.NVCC_FLAGS) and evaluates geom.py's expressions in their
// order.  Where torch's CUDA ops do not round as the expression reads,
// the helpers below follow the ops:
//   - torch.sum / amax / amin over the last dim of an (N, 3) tensor (the
//     vdot of geom.py and vec.py, the box's entry and exit) reduce in an
//     order set by the tensor's layout: two threads, (x0 + x2) + x1,
//     where that dim is contiguous (row-major); one thread, (x0 + x1) +
//     x2, where it is strided (the rows of a (8, N) ray table).  Each
//     call site passes the layout its torch tensor has (`row`);
//   - torch.linalg.cross is built with contraction: a1 * b2 - a2 * b1 is
//     fma(a1, b2, -(a2 * b1));
//   - torch.minimum / maximum / clamp propagate NaN, where fminf / fmaxf
//     drop it.
//
// These orders were read off torch 2.11.0+cu128 on an H100; another torch
// may reduce otherwise, and tests/test_torch_cuda.py's fused-finalize
// tests then fail.  The per-primitive hit math here is the third copy of
// the primitives beside geom.py (the torch finalize's, which this one
// follows) and prims.cuh (the select kernels' t): a change to one changes
// the others.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prims.cuh"

#define FIN_THREADS 128
// int64 words of one group's descriptor row (megakernel.FIN_GW): the
// group's first global prim, its field count, ptype, transformed flag,
// warp flag (its combo's object rays are the Hit's) and m_inv pointer,
// then for each of at most FIN_FIELDS fields in FIELDS order: its rows
// pointer, index pointer (int32 (T, 3) of a shared-vertex mesh, or 0),
// index column and width
#define FIN_FIELDS 6
#define FIN_GW (6 + 4 * FIN_FIELDS)
// floats of the widest ptype's fields (trianglenorm)
#define FIN_FMAX 18
// meta columns (megakernel._meta_tables): tex*4, tag*4, serial, neg,
// cid, row, useatex
#define FIN_TD 4
#define FIN_GD 4
#define FIN_MW (FIN_TD + FIN_GD + 5)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}

__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}

// vscaleadd(a, b, s): a + b * s
__device__ __forceinline__ V3 vsa(V3 a, V3 b, float s) {
  return v3(a.x + b.x * s, a.y + b.y * s, a.z + b.z * s);
}

// torch.sum(x, dim=-1) of an (N, 3) tensor; the +0.0f are the
// reduction's identity, which turns a -0 sum into +0
__device__ __forceinline__ float sum3(bool row, float x0, float x1,
                                      float x2) {
  return row ? ((x0 + x2) + 0.0f) + (x1 + 0.0f) : ((x0 + x1) + x2) + 0.0f;
}

__device__ __forceinline__ float vdot(bool row, V3 a, V3 b) {
  return sum3(row, a.x * b.x, a.y * b.y, a.z * b.z);
}

// torch.amax / amin's combine (NaN first, strict compare)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float amax3(bool row, V3 v) {
  return row ? max_nan(max_nan(v.x, v.z), v.y)
             : max_nan(max_nan(v.x, v.y), v.z);
}

__device__ __forceinline__ float amin3(bool row, V3 v) {
  return row ? min_nan(min_nan(v.x, v.z), v.y)
             : min_nan(min_nan(v.x, v.y), v.z);
}

// torch.minimum / maximum
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.clamp(x, min=lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// torch.linalg.cross (a row-major output)
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(__fmaf_rn(a.y, b.z, -(a.z * b.y)),
            __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}

// vec.vnorm
__device__ __forceinline__ V3 vnorm(bool row, V3 v) {
  float inv = 1.0f / sqrtf(clamp_min(vdot(row, v, v), 1e-30f));
  return v3(v.x * inv, v.y * inv, v.z * inv);
}

__device__ __forceinline__ V3 ld3(const float* p) {
  return v3(p[0], p[1], p[2]);
}

// The selected slot of one primitive: its two crossings and the normal
// of slot `slot` (geom.*_hits2, in object space).
struct Hits {
  float t0, t1;
  V3 n;
};

// geom.sphere_hits2.  `row`: the layout of the ray (o) tensor.
__device__ Hits sphere_hits(const float* f, V3 o, V3 d, bool row, int slot) {
  V3 c = v3(f[0], f[1], f[2]);
  float rad = f[3];
  V3 eo = vsub(c, o);
  float v = vdot(true, eo, d);
  float disc = rad * rad - (vdot(true, eo, eo) - v * v);
  bool ok = disc >= 0.0f;
  float sq = sqrtf(ok ? clamp_min(disc, 1e-12f) : 0.0f);
  Hits h;
  h.t0 = ok ? v - sq : GLOME_INF;
  h.t1 = ok ? v + sq : GLOME_INF;
  h.n = vnorm(row, vsub(vsa(o, d, slot ? h.t1 : h.t0), c));
  return h;
}

// geom.plane_hits2
__device__ Hits plane_hits(const float* f, V3 o, V3 d) {
  V3 nn = v3(f[0], f[1], f[2]);
  float dn = vdot(true, nn, d);
  float t = -(vdot(true, nn, o) - f[3]) / safe_nz(dn);
  t = dn == 0.0f ? GLOME_INF : t;
  bool entering = dn < 0.0f;
  Hits h;
  h.t0 = entering ? t : GLOME_INF;
  h.t1 = entering ? GLOME_INF : t;
  h.n = nn;
  return h;
}

__device__ __forceinline__ float sign1(float x) {
  float s = (float)((0.0f < x) - (x < 0.0f));
  return s == 0.0f ? 1.0f : s;
}

// one axis of geom.box_hits2's slabs
__device__ __forceinline__ void box_slab(float lo, float hi, float o,
                                         float d, float& tin, float& tout) {
  bool para = d == 0.0f;
  float inv = 1.0f / (para ? 1.0f : d);
  float ta = (lo - o) * inv;
  float tb = (hi - o) * inv;
  bool in_slab = (o > lo) && (o < hi);
  tin = para ? (in_slab ? -GLOME_BIG : GLOME_BIG) : tmin(ta, tb);
  tout = para ? (in_slab ? GLOME_BIG : -GLOME_BIG) : tmax(ta, tb);
}

// geom.box_hits2.  `row`: the layout of the ray (d) tensor.
__device__ Hits box_hits(const float* lo, const float* hi, V3 o, V3 d,
                         bool row, int slot) {
  V3 tin, tout;
  box_slab(lo[0], hi[0], o.x, d.x, tin.x, tout.x);
  box_slab(lo[1], hi[1], o.y, d.y, tin.y, tout.y);
  box_slab(lo[2], hi[2], o.z, d.z, tin.z, tout.z);
  float lastin = amax3(row, tin);
  float firstout = amin3(row, tout);
  bool ok = lastin <= firstout;
  V3 sg = v3(sign1(d.x), sign1(d.y), sign1(d.z));
  // the one-hot of the deciding axis, first match
  V3 ts = slot ? tout : tin;
  float tt = slot ? firstout : lastin;
  bool m0 = ts.x == tt;
  bool m1 = (ts.y == tt) && !m0;
  bool m2 = (ts.z == tt) && !m0 && !m1;
  Hits h;
  if (slot)
    h.n = v3(m0 ? sg.x : 0.0f, m1 ? sg.y : 0.0f, m2 ? sg.z : 0.0f);
  else
    h.n = v3(-(m0 ? sg.x : 0.0f), -(m1 ? sg.y : 0.0f),
             -(m2 ? sg.z : 0.0f));
  h.t0 = ok ? lastin : GLOME_INF;
  h.t1 = ok ? firstout : GLOME_INF;
  return h;
}

// geom.triangle_hits2 / trianglenorm_hits2 (f: p1, p2, p3[, n1, n2, n3])
__device__ Hits triangle_hits(const float* f, bool normals, V3 o, V3 d,
                              bool row) {
  V3 p[6];
  for (int k = 0; k < (normals ? 6 : 3); ++k) p[k] = ld3(f + 3 * k);
  V3 e1 = vsub(p[1], p[0]);
  V3 e2 = vsub(p[2], p[0]);
  V3 s1 = vcross(d, e2);
  float divisor = vdot(true, s1, e1);
  bool ok = divisor != 0.0f;
  float invdiv = 1.0f / safe_nz(divisor);
  V3 dd = vsub(o, p[0]);
  float b1 = vdot(row, dd, s1) * invdiv;
  ok = ok && (b1 >= 0.0f) && (b1 <= 1.0f);
  V3 s2 = vcross(dd, e1);
  float b2 = vdot(row, d, s2) * invdiv;
  ok = ok && (b2 >= 0.0f) && (b1 + b2 <= 1.0f);
  float t = vdot(true, e2, s2) * invdiv;
  Hits h;
  h.t0 = ok ? t : GLOME_INF;
  h.t1 = GLOME_INF;
  if (normals) {
    float w = 1.0f - (b1 + b2);
    h.n = vnorm(true, v3((p[3].x * w + p[4].x * b1) + p[5].x * b2,
                         (p[3].y * w + p[4].y * b1) + p[5].y * b2,
                         (p[3].z * w + p[4].z * b1) + p[5].z * b2));
  } else {
    h.n = vnorm(true, vcross(e1, e2));
  }
  return h;
}

// geom.disc_hits2.  `row`: the layout of the ray tensors.
__device__ Hits disc_hits(const float* f, V3 o, V3 d, bool row) {
  V3 pos = v3(f[0], f[1], f[2]);
  V3 nn = v3(f[3], f[4], f[5]);
  float dn = vdot(true, nn, d);
  float t = -vdot(true, nn, vsub(o, pos)) / safe_nz(dn);
  bool hit = dn != 0.0f;
  V3 off = vsub(vsa(o, d, t), pos);
  hit = hit && (vdot(row, off, off) <= f[6]);
  Hits h;
  h.t0 = hit ? t : GLOME_INF;
  h.t1 = GLOME_INF;
  h.n = nn;
  return h;
}

// geom._stable_roots
__device__ __forceinline__ bool stable_roots(float a, float b, float c,
                                             float& lo, float& hi) {
  float disc = b * b - 4.0f * a * c;
  bool ok = disc >= 0.0f;
  float sq = sqrtf(ok ? clamp_min(disc, 1e-12f) : 0.0f);
  float q = b < 0.0f ? (b - sq) * -0.5f : (b + sq) * -0.5f;
  float t0 = q / safe_nz(a);
  float t1 = c / safe_nz(q);
  lo = tmin(t0, t1);
  hi = tmax(t0, t1);
  return ok;
}

// geom._zslab
__device__ __forceinline__ void zslab(float h1, float h2, V3 o, V3 d,
                                      float& lo, float& hi) {
  float inv = 1.0f / safe_nz(d.z);
  float ta = (h1 - o.z) * inv;
  float tb = (h2 - o.z) * inv;
  bool para = d.z == 0.0f;
  bool in_slab = (o.z > h1) && (o.z < h2);
  lo = para ? (in_slab ? -GLOME_INF : GLOME_INF) : tmin(ta, tb);
  hi = para ? (in_slab ? GLOME_INF : -GLOME_INF) : tmax(ta, tb);
}

// geom.cylinder_hits2 (f: radius, h1, h2)
__device__ Hits cylinder_hits(const float* f, V3 o, V3 d, int slot) {
  float r = f[0], h1 = f[1], h2 = f[2];
  float a = d.x * d.x + d.y * d.y;
  float b = 2.0f * (d.x * o.x + d.y * o.y);
  float c = o.x * o.x + o.y * o.y - r * r;
  float lo, hi;
  bool ok = stable_roots(a, b, c, lo, hi);
  bool vert = a == 0.0f;
  bool inside = c < 0.0f;
  lo = vert ? (inside ? -GLOME_INF : GLOME_INF) : (ok ? lo : GLOME_INF);
  hi = vert ? (inside ? GLOME_INF : -GLOME_INF) : (ok ? hi : -GLOME_INF);
  float zlo, zhi;
  zslab(h1, h2, o, d, zlo, zhi);
  float t0 = tmax(lo, zlo);
  float t1 = tmin(hi, zhi);
  bool empty = t0 > t1;
  // geom._cyl_normal at the slot's crossing, before the empty test
  float ts = slot ? t1 : t0;
  bool cap = slot ? (t1 == zhi) : (t0 == zlo);
  V3 p = vsa(o, d, ts);
  float capz = p.z < (h1 + h2) * 0.5f ? -1.0f : 1.0f;
  Hits h;
  h.n = cap ? v3(0.0f, 0.0f, capz) : v3(p.x / r, p.y / r, 0.0f);
  h.t0 = empty ? GLOME_INF : t0;
  h.t1 = empty ? GLOME_INF : t1;
  return h;
}

// geom.cone_hits2 (f: radius, clip1, clip2, height)
__device__ Hits cone_hits(const float* f, V3 o, V3 d, int slot) {
  float r = f[0], clip1 = f[1], clip2 = f[2], height = f[3];
  float kp = r / height;
  float k = kp * kp;
  float a = d.x * d.x + d.y * d.y - k * d.z * d.z;
  float b = 2.0f * (d.x * o.x + d.y * o.y - k * d.z * (o.z - height));
  float c = o.x * o.x + o.y * o.y - k * (o.z - height) * (o.z - height);
  float lo, hi;
  bool ok = stable_roots(a, b, c, lo, hi);
  float ntl = d.z > 0.0f ? -GLOME_INF : hi;
  float nth = d.z > 0.0f ? lo : GLOME_INF;
  float lin_t = -c / safe_nz(b);
  float lin_lo = b < 0.0f ? lin_t : -GLOME_INF;
  float lin_hi = b < 0.0f ? GLOME_INF : lin_t;
  lin_lo = b == 0.0f ? (c < 0.0f ? -GLOME_INF : GLOME_INF) : lin_lo;
  lin_hi = b == 0.0f ? (c < 0.0f ? GLOME_INF : -GLOME_INF) : lin_hi;
  float flo = a > 0.0f ? (ok ? lo : GLOME_INF)
                       : (a < 0.0f ? (ok ? ntl : -GLOME_INF) : lin_lo);
  float fhi = a > 0.0f ? (ok ? hi : -GLOME_INF)
                       : (a < 0.0f ? (ok ? nth : GLOME_INF) : lin_hi);
  float zlo, zhi;
  zslab(clip1, clip2, o, d, zlo, zhi);
  float t0 = tmax(flo, zlo);
  float t1 = tmin(fhi, zhi);
  bool empty = t0 > t1;
  // geom._cone_normal at the slot's crossing, before the empty test
  float ts = slot ? t1 : t0;
  bool cap = slot ? (t1 == zhi) : (t0 == zlo);
  V3 p = vsa(o, d, ts);
  float invhyp = 1.0f / sqrtf(height * height + r * r);
  float up = r * invhyp;
  float out = height * invhyp;
  float r_ = sqrtf(clamp_min(p.x * p.x + p.y * p.y, 1e-24f));
  float corr = r_ == 0.0f ? 0.0f : out / safe_nz(r_);
  float capz = p.z < (clip1 + clip2) * 0.5f ? -1.0f : 1.0f;
  Hits h;
  h.n = cap ? v3(0.0f, 0.0f, capz) : v3(p.x * corr, p.y * corr, up);
  h.t0 = empty ? GLOME_INF : t0;
  h.t1 = empty ? GLOME_INF : t1;
  return h;
}

// row r of a group's fields, in FIELDS order, into f: each field's own
// rows, or a mesh's shared vertex (normal) table through its index
__device__ __forceinline__ void load_fields(const int64_t* g, int r,
                                            float* f) {
  int at = 0;
  for (int k = 0; k < (int)g[1]; ++k) {
    const int64_t* fd = g + 6 + 4 * k;
    const float* rows = (const float*)fd[0];
    const int* index = (const int*)fd[1];
    int width = (int)fd[3];
    const float* src =
        index ? rows + 3 * (size_t)index[3 * (size_t)r + fd[2]]
              : rows + (size_t)width * r;
    for (int c = 0; c < width; ++c) f[at + c] = src[c];
    at += width;
  }
}

__device__ __forceinline__ void store3(float* out, int row, int n, int i,
                                       V3 v) {
  if (row) {
    out[3 * (size_t)i] = v.x;
    out[3 * (size_t)i + 1] = v.y;
    out[3 * (size_t)i + 2] = v.z;
  } else {
    out[i] = v.x;
    out[(size_t)n + i] = v.y;
    out[2 * (size_t)n + i] = v.z;
  }
}

struct FinArgs {
  const float* o;
  long long o0, o1;  // o[i * o0 + c * o1]
  const float* d;
  long long d0, d1;
  int ray_row;  // the layout the torch ops see on o and d
  const float* t;
  const int* wid;
  const int* aux;
  int n;
  const int64_t* groups;
  int n_groups;
  const float* meta;  // (n_prims, FIN_MW) float32
  const int* ltab;    // (n_prims, FIN_TD + FIN_GD) int32
  int n_prims;
  int retex;
  float* out_t;
  bool* out_hit;
  float* out_pos;
  int pos_row;
  float* out_norm;
  int norm_row;
  float* out_oo;  // row-major, or null: obj_o / obj_d are o / d
  float* out_od;
  int* out_tex;
  int* out_tag;
  int* out_ser;
};

__global__ void __launch_bounds__(FIN_THREADS)
    finalize_hit_kernel(FinArgs a) {
  int i = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (i >= a.n) return;
  V3 o = v3(a.o[i * a.o0], a.o[i * a.o0 + a.o1], a.o[i * a.o0 + 2 * a.o1]);
  V3 d = v3(a.d[i * a.d0], a.d[i * a.d0 + a.d1], a.d[i * a.d0 + 2 * a.d1]);
  int w = a.wid[i];
  float best_t = GLOME_INF;
  V3 norm = v3(0.0f, 0.0f, 0.0f);
  V3 oo = o, od = d;
  int tex[FIN_TD], tag[FIN_GD], ser = -1;
  for (int k = 0; k < FIN_TD; ++k) tex[k] = -1;
  for (int k = 0; k < FIN_GD; ++k) tag[k] = -1;
  bool hit = w >= 0;
  if (hit) {
    int prim = w >> 1, slot = w & 1;
    // the group holding the prim: the last whose base is <= prim
    int lo = 0, hi = a.n_groups - 1;
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (a.groups[(size_t)mid * FIN_GW] <= prim)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int64_t* g = a.groups + (size_t)lo * FIN_GW;
    int r = prim - (int)g[0];
    int ptype = (int)g[2];
    bool xf = g[3] != 0;
    const float* mrow = a.meta + (size_t)prim * FIN_MW;
    for (int k = 0; k < FIN_TD; ++k) tex[k] = (int)mrow[k];
    for (int k = 0; k < FIN_GD; ++k) tag[k] = (int)mrow[FIN_TD + k];
    ser = (int)mrow[FIN_TD + FIN_GD];
    bool neg = mrow[FIN_TD + FIN_GD + 1] > 0.0f;
    bool atex = mrow[FIN_TD + FIN_GD + 4] > 0.0f;

    // the object-space ray of a transformed prim
    float m[12];
    V3 ro = o, rd = d;
    float ils = 1.0f;
    bool row = a.ray_row != 0;
    if (xf) {
      const float* mi = (const float*)g[5] + 12 * (size_t)r;
      for (int q = 0; q < 12; ++q) m[q] = mi[q];
      ro = v3(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
              m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
              m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
      V3 pd = v3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
                 m[4] * d.x + m[5] * d.y + m[6] * d.z,
                 m[8] * d.x + m[9] * d.y + m[10] * d.z);
      ils = 1.0f / sqrtf(clamp_min(pd.x * pd.x + pd.y * pd.y + pd.z * pd.z,
                                   1e-30f));
      rd = v3(pd.x * ils, pd.y * ils, pd.z * ils);
      row = true;  // torch.stack makes the object ray row-major
    }

    float f[FIN_FMAX];
    load_fields(g, r, f);
    Hits h;
    switch (ptype) {
      case PT_SPHERE:
        h = sphere_hits(f, ro, rd, row, slot);
        break;
      case PT_PLANE:
        h = plane_hits(f, ro, rd);
        break;
      case PT_BOX:
        h = box_hits(f, f + 3, ro, rd, row, slot);
        break;
      case PT_TRIANGLE:
      case PT_TRIANGLENORM:
        h = triangle_hits(f, ptype == PT_TRIANGLENORM, ro, rd, row);
        break;
      case PT_DISC:
        h = disc_hits(f, ro, rd, row);
        break;
      case PT_CYLINDER:
        h = cylinder_hits(f, ro, rd, slot);
        break;
      default:
        h = cone_hits(f, ro, rd, slot);
        break;
    }
    float t0 = h.t0, t1 = h.t1;
    if (xf) {
      t0 = t0 * ils;
      t1 = t1 * ils;
    }
    float t = a.t[i];
    float tsel = slot ? t1 : t0;
    // the tangency clamp: the kernel's t where the two evaluations differ
    best_t = fabsf(tsel - t) < 1e-2f * (1.0f + fabsf(t)) ? tsel : t;
    norm = h.n;
    if (xf) {
      // n_world = normalize(M_inv^T n_obj)
      V3 wv = v3(m[0] * norm.x + m[4] * norm.y + m[8] * norm.z,
                 m[1] * norm.x + m[5] * norm.y + m[9] * norm.z,
                 m[2] * norm.x + m[6] * norm.y + m[10] * norm.z);
      float il = 1.0f / sqrtf(clamp_min(wv.x * wv.x + wv.y * wv.y +
                                            wv.z * wv.z,
                                        1e-30f));
      norm = v3(wv.x * il, wv.y * il, wv.z * il);
      if (g[4]) {
        oo = ro;
        od = rd;
      }
    }
    if (neg) norm = v3(-norm.x, -norm.y, -norm.z);
    // the difference-B retexture from the select kernel's aux
    if (a.retex && atex && neg && a.aux[i] >= 0) {
      int ar = min(max(a.aux[i], 0), a.n_prims - 1);
      const int* lrow = a.ltab + (size_t)ar * (FIN_TD + FIN_GD);
      for (int k = 0; k < FIN_TD; ++k) tex[k] = lrow[k];
      for (int k = 0; k < FIN_GD; ++k) tag[k] = lrow[FIN_TD + k];
    }
  }
  a.out_t[i] = best_t;
  a.out_hit[i] = hit;
  store3(a.out_pos, a.pos_row, a.n, i, vsa(o, d, hit ? best_t : 0.0f));
  store3(a.out_norm, a.norm_row, a.n, i, norm);
  if (a.out_oo) {
    store3(a.out_oo, 1, a.n, i, oo);
    store3(a.out_od, 1, a.n, i, od);
  }
  for (int k = 0; k < FIN_TD; ++k) a.out_tex[(size_t)i * FIN_TD + k] = tex[k];
  for (int k = 0; k < FIN_GD; ++k) a.out_tag[(size_t)i * FIN_GD + k] = tag[k];
  a.out_ser[i] = ser;
}

extern "C" int glome_finalize_hit(
    const float* o, long long o0, long long o1, const float* d, long long d0,
    long long d1, int ray_row, const float* t, const int* wid,
    const int* aux, int n, const int64_t* groups, int n_groups,
    const float* meta, const int* ltab, int n_prims, int retex,
    float* out_t, bool* out_hit, float* out_pos, int pos_row,
    float* out_norm, int norm_row, float* out_oo, float* out_od,
    int* out_tex, int* out_tag, int* out_ser, void* stream) {
  if (n <= 0) return 0;
  // a scene without prims has no group rows, and every lane missed
  if (n_groups < 0 || n_prims < 0) return (int)cudaErrorInvalidValue;
  FinArgs a{o,      o0,      o1,      d,       d0,       d1,
            ray_row, t,      wid,     aux,     n,        groups,
            n_groups, meta,  ltab,    n_prims, retex,    out_t,
            out_hit, out_pos, pos_row, out_norm, norm_row, out_oo,
            out_od,  out_tex, out_tag, out_ser};
  int blocks = (n + FIN_THREADS - 1) / FIN_THREADS;
  finalize_hit_kernel<<<blocks, FIN_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* glome_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
