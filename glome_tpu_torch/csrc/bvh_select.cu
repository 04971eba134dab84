// K5: seeded nearest (or any-hit) prim of ONE untransformed group through
// its skip-link BVH.
//
// Replaces glome_tpu/pallas_kernels.py:bvh_intersect (the Pallas TPU
// kernel of glome_tpu's pass-per-group route).  It computes the same
// (t, leaf index): the index is into the group's rows in LEAF order
// (bvh.order applied; intersect.bvh_dispatch maps it back to the
// group-local prim), -1 where nothing beat the per-ray seed t (t == seed
// there).  The tree is the group's own accel.build_bvh table
// (compile.group_accel): per node a box, a skip link (the next node on a
// miss) and a leaf range of at most accel.LEAF_MAX rows.
//
// Design.  The TPU kernel walked the tree once per (8, 128) ray tile with
// one node pointer in SMEM: the tile fell through to node + 1 when any of
// its rays hit the node box and jumped to the skip link otherwise, tested
// a leaf's rows densely against the whole tile, and in shadow mode left
// the walk once every ray of the tile was blocked.  Here every ray walks
// the same skip-link table alone (hit -> node + 1, miss -> skip) and culls
// by its own best t.  Leaf rows are tested in leaf order with a strict <,
// so the first row in leaf order wins a tie, as on the TPU.  Shadow mode
// is any-hit: the ray stops at its first blocker.  The skip-link walk
// cannot take the nearer child first; a near-first walk (as K2's) would
// make fewer prim tests, which is later work.
//
// What bounds it on the card: the dependent loads of a divergent per-ray
// walk (node boxes, then 16-byte sphere rows) out of L2; TestScene's two
// lattice groups hold under 3,000 spheres and about 2,500 nodes each.

#include <cuda_runtime.h>

#include "cons.cuh"
#include "prims.cuh"
#include "walk.cuh"

struct Bvh {
  const float* __restrict__ nf;    // (n_nodes, 6) node boxes
  const int* __restrict__ ni;      // (n_nodes, 3) [skip, leaf_start, count]
  const float* __restrict__ rows;  // (P, F) rows in leaf order
  const float* __restrict__ vis;   // (P,) 0/1 in leaf order
  int n_nodes, F, ptype;
};

// kTally: also write each ray's work tally (walk.cuh RayT)
template <bool kTally>
__global__ void __launch_bounds__(128)
    bvh_select_kernel(const float* __restrict__ rays, int n,
                      const float* __restrict__ seeds, Bvh B, Cons C,
                      int shadow, float* __restrict__ out_t,
                      int* __restrict__ out_l, int* __restrict__ tally) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float seed = seeds[i];
  float bt = seed;
  int bl = -1;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f) {
    int n_cl = C.desc[0];
    int node = 0;
    bool blocked = false;
    // skip links and fall-through both move forward: at most n_nodes steps
    while (node < B.n_nodes && !blocked) {
      const int* nd = B.ni + node * 3;
      float near;
      if (box_live(B.nf + node * 6, r, bt, near)) {
        int end = nd[1] + nd[2];
        for (int p = nd[1]; p < end; ++p) {
          if (!(B.vis[p] > 0.5f)) continue;
          float t0, t1;
          prim_candidates(B.ptype, B.rows + (size_t)p * B.F, false, B.F, r,
                          t0, t1);
          bool v0 = (t0 > 0.0f) && (t0 < bt);
          bool v1 = (t1 > 0.0f) && (t1 < bt);
          if (n_cl > 0) cons_filter(C, r, t0, t1, v0, v1);
          float tc = v0 ? t0 : (v1 ? t1 : GLOME_INF);
          if (tc < bt) {
            bt = tc;
            bl = p;
            if (shadow) {
              blocked = true;
              break;
            }
          }
        }
        node += 1;
      } else {
        node = nd[0];
      }
    }
  }
  out_t[i] = bt;
  out_l[i] = bt < seed ? bl : -1;
  r.store_tally(tally, n, i);
}

extern "C" int glome_bvh_select(const float* rays, int n, const float* seeds,
                                const float* nf, const int* ni, int n_nodes,
                                const float* rows, const float* vis, int F,
                                int ptype, const float* cf, const int* cdesc,
                                int shadow, float* out_t, int* out_l,
                                int* tally, void* stream) {
  if (n <= 0) return 0;
  Bvh B{nf, ni, rows, vis, n_nodes, F, ptype};
  Cons C{cf, cdesc};
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  if (tally)
    bvh_select_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        rays, n, seeds, B, C, shadow, out_t, out_l, tally);
  else
    bvh_select_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        rays, n, seeds, B, C, shadow, out_t, out_l, tally);
  return (int)cudaGetLastError();
}
