// Inline CSG constraint check shared by the per-group select kernels (K2
// block_select.cu, K4 dense_select.cu, K5 bvh_select.cu): a candidate
// point of a group whose prims are members of a CSG object is a visible
// surface only where every other clause of that object holds
// (Csg.hs:92-101: IN(member rows) == positive).  The plain torch version
// is glome_tpu_torch.block_kernel.cons_ok; the descriptor and the member
// rows come from block_kernel.encode_cons and the packers beside it.
#pragma once

#include <cuda_runtime.h>

#include "prims.cuh"

// constraint descriptor (glome_tpu_torch.block_kernel.encode_cons):
// [n_clauses, (positive, member_start, member_count) * n_clauses,
//  (ptype, cf_off, M, Fm, has_inv) * n_members]; member_start is an
// absolute index into the descriptor
#define CC_W 3
#define CMB_W 5

struct Cons {
  const float* __restrict__ cf;
  const int* __restrict__ desc;
};

// every clause holds at the point: IN(member rows) == positive
__device__ bool eval_cons(const Cons& C, float px, float py, float pz) {
  int n_cl = C.desc[0];
  for (int c = 0; c < n_cl; ++c) {
    const int* cl = C.desc + 1 + c * CC_W;
    bool inn = false;
    for (int m = 0; m < cl[2]; ++m) {
      const int* mb = C.desc + cl[1] + m * CMB_W;
      int ptype = mb[0], M = mb[2], Fm = mb[3];
      bool has_inv = mb[4] != 0;
      for (int r = 0; r < M; ++r) {
        const float* row = C.cf + mb[1] + r * Fm;
        float x = px, y = py, z = pz;
        if (has_inv) {
          const float* mi = row + Fm - 12;
          x = mi[0] * px + mi[1] * py + mi[2] * pz + mi[3];
          y = mi[4] * px + mi[5] * py + mi[6] * pz + mi[7];
          z = mi[8] * px + mi[9] * py + mi[10] * pz + mi[11];
        }
        inn = inn || inside_comp(ptype, row, x, y, z);
      }
    }
    if (inn != (cl[0] != 0)) return false;
  }
  return true;
}

// both candidates of one prim row against the constraints, as every
// select kernel filters them: v0/v1 stay true only where the candidate
// point o + d * t passes eval_cons
template <class Ray>
__device__ __forceinline__ void cons_filter(const Cons& C, const Ray& r,
                                            float t0, float t1, bool& v0,
                                            bool& v1) {
  if (v0) v0 = eval_cons(C, r.ox + r.dx * t0, r.oy + r.dy * t0,
                         r.oz + r.dz * t0);
  if (v1) v1 = eval_cons(C, r.ox + r.dx * t1, r.oy + r.dy * t1,
                         r.oz + r.dz * t1);
}
