// K1: single-launch nearest-valid-candidate selection over every phase of
// every compiled scene.
//
// Replaces glome_tpu/megakernel.py:mega_select (the Pallas TPU kernel).
// It computes the same (t, wid, aux): the running best t carries across
// the phases in plan order and is updated with a strict <, so the tie
// order is the reference's; wid = global_prim * 2 + slot, -1 = miss; aux
// = first containing A member of a useatex difference-B winner.
//
// Design.  One thread per ray, rays read from (8, N) component planes
// (coalesced loads).  ONE generic kernel interprets the plan's flat
// phase-descriptor table (glome_tpu_torch.megakernel.encode_phases) at
// run time, where the Pallas kernel was unrolled in Python per plan:
//   dense    -- per-ray slab test of the phase AABB, then a prim loop;
//   bvh2     -- near-child-first walk of the binary BVH with a per-thread
//               stack (the TPU's K-wide frontier and skip-link walks
//               answered TPU scalar/vector sync costs and are not ported);
//   convex   -- member interval intersection;
//   deferred -- candidate test, clause checks (stackless skip-link point
//               BVH scans for big member sets), DNF region flips and the
//               useatex first-member tracking.
// Shadow mode is any-hit: a ray stops as soon as it is blocked.
//
// What bounds it on the card: the per-ray walks are chains of dependent
// loads (a node's children decide the next node), so their latency, not
// float32 work or bytes, sets the time; TestScene's plan tables (~300 KB)
// stay in L2.  The design cuts what each step waits for:
//   - a bvh2 tree is stored as child-pair records (megakernel.node_records):
//     one 64-B, 16-B-aligned record per internal node holds both
//     children's boxes and references, read as four float4 loads in one
//     round per step;
//   - the deferred subtrees wait on a stack of packed (reference, near)
//     pairs in dynamic shared memory (one column per thread; a
//     per-thread local array was slower), max(depth - 1, 1) entries for
//     the plan's deepest bvh2 tree (kernels.walk_stack), so any tree the
//     card's shared memory holds is walked (csrc/bvh_walk.cuh Stack);
//   - the descriptor table is staged in shared memory once per CTA (when
//     it fits in MEGA_META_MAX ints), so the header fields every prim test
//     reads come from there;
//   - in a transformed group's leaves (TestScene's 1,024 cones, the
//     phase that took half the launch) each prim's padded world box
//     (megakernel.padded_prim_aabb, PlanTables.pbox) is slab-tested before
//     the prim, whose test transforms the ray and solves a quadratic; the
//     padding keeps every candidate inside its box, so the cull is
//     conservative.
// The walk takes the near child first (nL <= nR) and pops a deferred
// subtree while it is nearer than the best t; the culls skip only prims
// that hold no candidate, so the winners, ties included, are those of the
// same walk without them.

#include <cuda_runtime.h>
#include <limits.h>

#include "bvh_walk.cuh"
#include "prims.cuh"
#include "walk.cuh"

// descriptor ints staged in shared memory (larger tables stay in global;
// megakernel.META_MAX)
#define MEGA_META_MAX 4096
#define GLOME_DELTA 1.0e-4f

// descriptor layout: glome_tpu_torch.megakernel PH_* / CM_* / CV_*
#define PH_W 32
#define PH_KIND 0
#define PH_SI 1
#define PH_PTYPE 2
#define PH_XF 3
#define PH_P 4
#define PH_PF 5
#define PH_F 6
#define PH_PI 7
#define PH_VIS0 8
#define PH_VIS1 9
#define PH_VISMIX 10
#define PH_BB 11
#define PH_NF 12
#define PH_NI 13
#define PH_NNODES 14
#define PH_DEPTH 15
#define PH_CONS 16
#define PH_NCONS 17
#define PH_MEM 18
#define PH_NMEM 19
#define PH_GPRIM 20
#define PH_NEG 21
#define PH_OWN 22
#define PH_REG 23
#define PH_NREG 24
#define PH_ATEX 25
#define PH_NFLD 26
#define PH_NODE 27
#define PH_PBOX 28

#define CM_W 10
#define CM_PTYPE 0
#define CM_PF 1
#define CM_F 2
#define CM_M 3
#define CM_INV 4
#define CM_PI 5
#define CM_NF 6
#define CM_NI 7
#define CM_NNODES 8
#define CM_NFLD 9

#define CL_W 3
#define RG_W 2
#define CV_W 6

#define KIND_DENSE 0
#define KIND_BVH2 1
#define KIND_CONVEX 2
#define KIND_DEFERRED 3

struct Tabs {
  const float* __restrict__ pf;
  const int* __restrict__ pi;
  const float* __restrict__ nf;
  const int* __restrict__ ni;
  const float4* __restrict__ nodes;   // child-pair records
  const float* __restrict__ bb;
  const float4* __restrict__ pbox;    // padded prim boxes, 8 floats each
  const int* __restrict__ meta;       // shared memory once staged
};

template <class Ray>
__device__ __forceinline__ bool point_in_node(const float* b, float px,
                                              float py, float pz,
                                              const Ray& ray) {
  ray.count_point();
  return px >= b[0] && px <= b[3] && py >= b[1] && py <= b[4] &&
         pz >= b[2] && pz <= b[5];
}

// row `row` of a constraint member set contains the point (strictly)
template <class Ray>
__device__ __forceinline__ bool member_row_inside(const Tabs& T,
                                                  const int* cm, int row,
                                                  float px, float py,
                                                  float pz, const Ray& ray) {
  ray.count_member();
  const float* c = T.pf + cm[CM_PF] + row * cm[CM_F];
  float x = px, y = py, z = pz;
  if (cm[CM_INV]) {
    const float* mi = c + cm[CM_NFLD];
    x = mi[0] * px + mi[1] * py + mi[2] * pz + mi[3];
    y = mi[4] * px + mi[5] * py + mi[6] * pz + mi[7];
    z = mi[8] * px + mi[9] * py + mi[10] * pz + mi[11];
  }
  return inside_comp(cm[CM_PTYPE], c, x, y, z);
}

// any row of the member set contains the point; big sets walk their
// stackless skip-link point BVH (rows stored in leaf order)
template <class Ray>
__device__ bool member_set_inside(const Tabs& T, const int* cm, float px,
                                  float py, float pz, const Ray& ray) {
  int M = cm[CM_M];
  int nn = cm[CM_NNODES];
  if (nn > 0) {
    const float* nf = T.nf + cm[CM_NF];
    const int* ni = T.ni + cm[CM_NI];
    // skip links only move forward: at most nn steps
    for (int node = 0, steps = 0; node < nn && steps < nn; ++steps) {
      if (point_in_node(nf + node * 6, px, py, pz, ray)) {
        int lc = ni[node * 3 + 2];
        int ls = ni[node * 3 + 1];
        for (int k = 0; k < lc; ++k) {
          int row = min(ls + k, M - 1);
          if (member_row_inside(T, cm, row, px, py, pz, ray)) return true;
        }
        node += 1;
      } else {
        node = ni[node * 3];
      }
    }
    return false;
  }
  for (int row = 0; row < M; ++row)
    if (member_row_inside(T, cm, row, px, py, pz, ray)) return true;
  return false;
}

// conjunction of clauses at a point: IN(set) == positive for every clause
// (Csg.hs:92-101); clause `skip` is left out (-1: none)
template <class Ray>
__device__ bool eval_conj(const Tabs& T, int cl_start, int cl_count,
                          int skip, float px, float py, float pz,
                          const Ray& ray) {
  for (int c = 0; c < cl_count; ++c) {
    if (c == skip) continue;
    const int* cl = T.meta + cl_start + c * CL_W;
    bool positive = cl[0] != 0;
    bool inn = false;
    for (int m = 0; m < cl[2] && !inn; ++m)
      inn = member_set_inside(T, T.meta + cl[1] + m * CM_W, px, py, pz,
                              ray);
    if (inn != positive) return false;
  }
  return true;
}

// get_metainfo semantics (Csg.hs:39-41): the global prim id of the FIRST
// containing member in clause order (the lowest clause ordinal), -1 if
// none.  Linear sets are in clause order, so their first hit is their
// minimum; BVH sets are in leaf order and take the minimum over every
// containing row; later sets hold higher ordinals.
template <class Ray>
__device__ int clause_first(const Tabs& T, const int* cl, float px, float py,
                            float pz, const Ray& ray) {
  int best_ord = INT_MAX;
  int best_gp = -1;
  for (int m = 0; m < cl[2] && best_gp < 0; ++m) {
    const int* cm = T.meta + cl[1] + m * CM_W;
    int M = cm[CM_M];
    int nn = cm[CM_NNODES];
    const int* pir = T.pi + cm[CM_PI];
    if (nn > 0) {
      const float* nf = T.nf + cm[CM_NF];
      const int* ni = T.ni + cm[CM_NI];
      for (int node = 0, steps = 0; node < nn && steps < nn; ++steps) {
        if (point_in_node(nf + node * 6, px, py, pz, ray)) {
          int lc = ni[node * 3 + 2];
          int ls = ni[node * 3 + 1];
          for (int k = 0; k < lc; ++k) {
            int row = min(ls + k, M - 1);
            if (member_row_inside(T, cm, row, px, py, pz, ray) &&
                pir[2 * row + 1] < best_ord) {
              best_ord = pir[2 * row + 1];
              best_gp = pir[2 * row];
            }
          }
          node += 1;
        } else {
          node = ni[node * 3];
        }
      }
    } else {
      for (int row = 0; row < M; ++row) {
        if (member_row_inside(T, cm, row, px, py, pz, ray)) {
          best_gp = pir[2 * row];
          break;
        }
      }
    }
  }
  return best_gp;
}

// full candidate test + strict-< merge of one prim of a dense/bvh2 phase
template <class Ray>
__device__ __forceinline__ void prim_test(const Tabs& T, const int* ph,
                                          int q, const Ray& r, float& bt,
                                          int& bw) {
  const float* prm = T.pf + ph[PH_PF] + q * ph[PH_F];
  float t0, t1;
  prim_candidates(ph[PH_PTYPE], prm, ph[PH_XF] != 0, ph[PH_NFLD], r, t0, t1);
  bool v0 = (t0 > 0.0f) && (t0 < bt);
  bool v1 = (t1 > 0.0f) && (t1 < bt);
  int ncons = ph[PH_NCONS];
  if (ncons > 0) {
    if (v0)
      v0 = eval_conj(T, ph[PH_CONS], ncons, -1, r.ox + r.dx * t0,
                     r.oy + r.dy * t0, r.oz + r.dz * t0, r);
    if (v1)
      v1 = eval_conj(T, ph[PH_CONS], ncons, -1, r.ox + r.dx * t1,
                     r.oy + r.dy * t1, r.oz + r.dz * t1, r);
  }
  float tc = v0 ? t0 : (v1 ? t1 : GLOME_INF);
  if (tc < bt) {
    bt = tc;
    bw = T.pi[ph[PH_PI] + 2 * q] * 2 + (v0 ? 0 : 1);
  }
}

// per-prim visibility flags (PI column 1: bit 0 primary, bit 1 shadow)
__device__ __forceinline__ bool prim_visible(const Tabs& T, const int* ph,
                                             int q, int shadow) {
  if (!ph[PH_VISMIX]) return true;
  int flags = T.pi[ph[PH_PI] + 2 * q + 1];
  return shadow ? (flags >= 2) : (flags % 2 == 1);
}

template <class Ray>
__device__ void run_dense(const Tabs& T, const int* ph, const Ray& r,
                          int shadow, float seed, float& bt, int& bw) {
  int bbi = ph[PH_BB];
  float near;
  if (bbi >= 0 && !box_live(T.bb + 8 * bbi, r, bt, near)) return;
  int P = ph[PH_P];
  for (int q = 0; q < P; ++q) {
    if (shadow && bt < seed) return;
    if (prim_visible(T, ph, q, shadow)) prim_test(T, ph, q, r, bt, bw);
  }
}

// near-child-first walk over the strictly binary bvh2 tree's child-pair
// records (megakernel.node_records, csrc/bvh_walk.cuh's layout).  A reference r names a node: r > 0
// the record of an internal node, r < 0 a leaf (~r = leaf_start << 5 |
// leaf_count), 0 none.  Record 0 holds the root's box and reference.
template <class Ray>
__device__ void run_bvh2(const Tabs& T, const int* ph, const Ray& r,
                         int shadow, float seed, float& bt, int& bw,
                         Stack& st) {
  const float4* rec = T.nodes + (size_t)ph[PH_NODE] * (NODE_W / 4);
  int sp = 0;
  int node;
  {
    float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 3);
    float near;
    node = box_live6(a.x, a.y, a.z, a.w, b.x, b.y, r, bt, near)
               ? __float_as_int(c.x)
               : 0;
  }
  // transformed prims: each one's padded world box first (-1: none)
  int pb = ph[PH_PBOX];
  // every node is visited at most once
  for (int steps = 0; steps <= ph[PH_NNODES]; ++steps) {
    if (node < 0) {
      int leaf = ~node;
      int ls = leaf >> 5, lc = leaf & 31;
      for (int k = 0; k < lc; ++k) {
        if (shadow && bt < seed) return;
        int q = ls + k;
        if (!prim_visible(T, ph, q, shadow)) continue;
        if (pb >= 0) {
          const float4* b = T.pbox + 2 * (size_t)(pb + q);
          float4 lo = __ldg(b), hi = __ldg(b + 1);
          float near;
          if (!box_live6(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, bt, near))
            continue;
        }
        prim_test(T, ph, q, r, bt, bw);
      }
      node = 0;
    } else if (node > 0) {
      // one load round: both children's boxes and references
      const float4* q = rec + (size_t)node * (NODE_W / 4);
      float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
             e = __ldg(q + 3);
      float nL, nR;
      bool hL = box_live6(a.x, a.y, a.z, a.w, b.x, b.y, r, bt, nL);
      bool hR = box_live6(b.z, b.w, c.x, c.y, c.z, c.w, r, bt, nR);
      int L = __float_as_int(e.x), R = __float_as_int(e.y);
      if (hL && hR) {
        bool lfirst = nL <= nR;
        node = lfirst ? L : R;
        if (sp < st.cap) {
          st.put(sp, lfirst ? R : L, lfirst ? nR : nL);
          ++sp;
        }
      } else {
        node = hL ? L : (hR ? R : 0);
      }
    }
    if (shadow && bt < seed) return;
    if (node == 0) {
      // pop the next deferred subtree still nearer than the best hit
      while (sp > 0) {
        --sp;
        int2 top = st.get(sp);
        if (__int_as_float(top.y) < bt) {
          node = top.x;
          break;
        }
      }
      if (node == 0) return;
    }
  }
}

// exact world [t_in, t_out] of one convex member
template <class Ray>
__device__ __forceinline__ void member_interval(const Tabs& T, const int* cv,
                                                const Ray& r, float& t0,
                                                float& t1) {
  int ptype = cv[0];
  const float* p = T.pf + cv[1];
  bool xf = cv[3] != 0;
  float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  float ils = 1.0f;
  if (xf) {
    const float* m = p + cv[5];
    ox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[3];
    oy = m[4] * r.ox + m[5] * r.oy + m[6] * r.oz + m[7];
    oz = m[8] * r.ox + m[9] * r.oy + m[10] * r.oz + m[11];
    float pdx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
    float pdy = m[4] * r.dx + m[5] * r.dy + m[6] * r.dz;
    float pdz = m[8] * r.dx + m[9] * r.dy + m[10] * r.dz;
    ils = 1.0f / sqrtf(pdx * pdx + pdy * pdy + pdz * pdz);
    dx = pdx * ils;
    dy = pdy * ils;
    dz = pdz * ils;
  }
  if (ptype == PT_PLANE) {
    float dn = p[0] * dx + p[1] * dy + p[2] * dz;
    float sdist = p[0] * ox + p[1] * oy + p[2] * oz - p[3];
    float t = -sdist / (dn == 0.0f ? 1.0f : dn);
    bool ins = sdist < 0.0f;
    t0 = dn < 0.0f ? t : -GLOME_INF;
    t1 = dn > 0.0f ? t : GLOME_INF;
    if (dn == 0.0f) {
      t0 = ins ? -GLOME_INF : GLOME_INF;
      t1 = ins ? GLOME_INF : -GLOME_INF;
    }
  } else {
    prim_t(ptype, p, ox, oy, oz, dx, dy, dz, t0, t1);
  }
  r.count_prim();
  if (xf) {
    if (fabsf(t0) < GLOME_INF) t0 *= ils;
    if (fabsf(t1) < GLOME_INF) t1 *= ils;
  }
}

template <class Ray>
__device__ void run_convex(const Tabs& T, const int* ph, const Ray& r,
                           float& bt, int& bw) {
  float t_in = -GLOME_INF, t_out = GLOME_INF;
  int w_in = 0, w_out = 0;
  int nm = ph[PH_NMEM];
  for (int k = 0; k < nm; ++k) {
    const int* cv = T.meta + ph[PH_MEM] + k * CV_W;
    float t0, t1;
    member_interval(T, cv, r, t0, t1);
    if (t0 > t_in) {
      t_in = t0;
      w_in = cv[4] * 2;
    }
    if (t1 < t_out) {
      t_out = t1;
      w_out = cv[4] * 2 + 1;
    }
  }
  bool entering = t_in > 0.0f;
  float t_cand = entering ? t_in : t_out;
  if ((t_in <= t_out) && (t_cand > 0.0f) && (t_cand < bt) &&
      (t_cand < GLOME_INF)) {
    bt = t_cand;
    bw = entering ? w_in : w_out;
  }
}

// one deferred CSG prim (Csg.hs:33-54)
template <class Ray>
__device__ void run_deferred(const Tabs& T, const int* ph, const Ray& r,
                             float& bt, int& bw, int& ba) {
  float t0, t1;
  prim_candidates(ph[PH_PTYPE], T.pf + ph[PH_PF], ph[PH_XF] != 0,
                  ph[PH_NFLD], r, t0, t1);
  bool neg = ph[PH_NEG] != 0;
  bool v0 = !neg && (t0 > 0.0f) && (t0 < bt) && (t0 < GLOME_INF);
  bool v1 = (t1 > 0.0f) && (t1 < bt) && (t1 < GLOME_INF);
  int atex = ph[PH_ATEX];
  int first_gp = -1;
  for (int which = 0; which < 2; ++which) {
    bool vm = which ? v1 : v0;
    if (!vm) continue;
    float tv = which ? t1 : t0;
    float px = r.ox + r.dx * tv, py = r.oy + r.dy * tv,
          pz = r.oz + r.dz * tv;
    bool okc;
    if (which == 1 && atex >= 0) {
      okc = eval_conj(T, ph[PH_CONS], ph[PH_NCONS], atex, px, py, pz, r);
      if (okc) {
        first_gp = clause_first(T, T.meta + ph[PH_CONS] + atex * CL_W, px,
                                py, pz, r);
        okc = first_gp >= 0;
      }
    } else {
      okc = eval_conj(T, ph[PH_CONS], ph[PH_NCONS], -1, px, py, pz, r);
    }
    int nreg = ph[PH_NREG];
    if (okc && nreg > 0) {
      // DNF boundary test: the union of regions must FLIP across the
      // candidate, sampled at p -+ DELTA*d
      bool um = false, up = false;
      for (int g = 0; g < nreg; ++g) {
        const int* rg = T.meta + ph[PH_REG] + g * RG_W;
        um = um || eval_conj(T, rg[0], rg[1], -1, px - r.dx * GLOME_DELTA,
                             py - r.dy * GLOME_DELTA,
                             pz - r.dz * GLOME_DELTA, r);
        up = up || eval_conj(T, rg[0], rg[1], -1, px + r.dx * GLOME_DELTA,
                             py + r.dy * GLOME_DELTA,
                             pz + r.dz * GLOME_DELTA, r);
      }
      okc = um != up;
    }
    if (okc && which == 1 && neg) {
      // the ray must actually leave the clause set
      okc = !eval_conj(T, ph[PH_OWN], 1, -1, px + r.dx * GLOME_DELTA,
                       py + r.dy * GLOME_DELTA, pz + r.dz * GLOME_DELTA, r);
    }
    if (which == 0)
      v0 = okc;
    else
      v1 = okc;
  }
  float tc = v0 ? t0 : (v1 ? t1 : GLOME_INF);
  if (tc < bt) {
    bt = tc;
    bw = ph[PH_GPRIM] * 2 + (v0 ? 0 : 1);
    if (atex >= 0) ba = first_gp;
  }
}

// kTally: also write each ray's work tally, four rows (walk.cuh RayT).
// At least 6 CTAs per SM: ptxas then keeps the kernel at 80 registers;
// left to itself (no static shared memory any more) it chose 64 and
// spilled 1,304 B of loads, and K1 took 29% longer.
template <bool kTally>
__global__ void __launch_bounds__(WALK_THREADS, 6)
    mega_select_kernel(const float* __restrict__ rays, int n, Tabs T,
                       int n_meta, int n_phases, int stack, int shadow,
                       float* __restrict__ out_t, int* __restrict__ out_w,
                       int* __restrict__ out_a, int* __restrict__ tally) {
  // dynamic shared memory: the bvh2 stack (`stack` entries per thread),
  // then the staged descriptor table
  extern __shared__ int2 sdyn[];
  Stack st{sdyn + threadIdx.x, stack};
  if (n_meta <= MEGA_META_MAX) {
    int* smeta = (int*)(sdyn + (size_t)stack * WALK_THREADS);
    for (int k = threadIdx.x; k < n_meta; k += WALK_THREADS)
      smeta[k] = T.meta[k];
    __syncthreads();
    T.meta = smeta;
  }
  int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= n) return;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  float seed = rays[6 * n + i];
  float sid = rays[7 * n + i];
  float bt = seed;
  int bw = -1;
  int ba = -1;
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f) {
    for (int p = 0; p < n_phases; ++p) {
      const int* ph = T.meta + p * PH_W;
      if (!ph[shadow ? PH_VIS1 : PH_VIS0]) continue;
      if (sid != (float)ph[PH_SI]) continue;
      switch (ph[PH_KIND]) {
        case KIND_DENSE: run_dense(T, ph, r, shadow, seed, bt, bw); break;
        case KIND_BVH2: run_bvh2(T, ph, r, shadow, seed, bt, bw, st); break;
        case KIND_CONVEX: run_convex(T, ph, r, bt, bw); break;
        case KIND_DEFERRED: run_deferred(T, ph, r, bt, bw, ba); break;
        default: break;
      }
      if (shadow && bt < seed) break;  // any-hit: blocked
    }
  }
  out_t[i] = bt;
  out_w[i] = bw;
  out_a[i] = ba;
  r.store_tally(tally, n, i);
  r.store_clause_tally(tally, n, i);
}

extern "C" int glome_mega_select(const float* rays, int n, const float* pf,
                                 const int* pi, const float* nf,
                                 const int* ni, const float* nodes,
                                 const float* bb, const float* pbox,
                                 const int* meta, int n_meta, int n_phases,
                                 int stack, int shadow, float* out_t,
                                 int* out_w, int* out_a, int* tally,
                                 void* stream) {
  if (n <= 0) return 0;
  if ((((size_t)nodes | (size_t)pbox) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (stack < 1) return (int)cudaErrorInvalidValue;
  Tabs T{pf, pi, nf, ni, (const float4*)nodes, bb, (const float4*)pbox,
         meta};
  int blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  size_t smem = stack_bytes(stack) +
                (n_meta <= MEGA_META_MAX ? (size_t)n_meta * sizeof(int) : 0);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tally) {
    err = allow_smem(mega_select_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    mega_select_kernel<true><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, T, n_meta, n_phases, stack, shadow, out_t, out_w, out_a,
        tally);
  } else {
    err = allow_smem(mega_select_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    mega_select_kernel<false><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, T, n_meta, n_phases, stack, shadow, out_t, out_w, out_a,
        tally);
  }
  return (int)cudaGetLastError();
}
