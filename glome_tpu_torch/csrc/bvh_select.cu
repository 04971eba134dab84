// K5: seeded nearest (or any-hit) prim of ONE untransformed group through
// its own BVH.
//
// Replaces glome_tpu/pallas_kernels.py:bvh_intersect (the Pallas TPU
// kernel of glome_tpu's pass-per-group route).  It computes the same
// (t, leaf index): the index is into the group's rows in LEAF order
// (bvh.order applied; intersect.bvh_dispatch maps it back to the
// group-local prim), -1 where nothing beat the per-ray seed t (t == seed
// there).  Only rows with vis > 0.5 are tested, and a candidate point
// must pass the group's inline constraints (csrc/cons.cuh).
//
// Design.  The TPU kernel walked the group's skip-link tree
// (accel.build_bvh, compile.group_accel) once per (8, 128) ray tile with
// one node pointer in SMEM, in the tree's fixed pre-order.  Here one
// thread walks one ray with csrc/bvh_walk.cuh's near-first walk, the one
// K2 and K3 walk, over the same tree converted to 64-B child-pair records
// (accel.skip_link_pairs, then accel.node_records): one float4 load round
// per step tests both children, the nearer is taken first, the farther
// waits on a stack in dynamic shared memory sized from the converted
// tree's depth (kernels.walk_stack), and a subtree is culled once it
// starts beyond the ray's best t.  The rows keep their leaf order, so a
// leaf is the same run of rows as in the skip-link tree.  The best
// candidate is the least (t, row): a candidate at the best t wins when
// its row is lower, so the winner is the plain version's argmin over the
// leaf-order rows, whatever order the walk visits the leaves in.  A chain
// of build_bvh's unsplittable leaves is a balanced subtree of the
// converted tree, so no group is too deep for the stack.  Rows of
// spheres (4 floats, the lattice groups') are read as one float4 load.
// Shadow mode is any-hit: the ray stops at its first blocker.  Dead lanes
// (seed <= 0) walk nothing.  ptxas gives the kernel 64 registers with or
// without __launch_bounds__(128, 8) (K2's and K3's bound); without it the
// kernel ran 0.5-1.3% faster on the H100, so it has none.
//
// What bounds it on the card: the dependent loads of a divergent per-ray
// walk out of L2 (TestScene's lattice groups: under 3,000 rows and 1,300
// records, under 100 KB) and its box tests.  A near-first walk makes two
// box tests per record step where the skip-link walk made one per node,
// so on rays that hit nothing (most of a lattice group's primary rays)
// it tests about as many boxes as before; its gain there is the one load
// round per step, and on rays that hit, the far subtrees it culls.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"
#include "cons.cuh"
#include "prims.cuh"
#include "walk.cuh"

// the visible rows of one leaf against the best (bt, best row)
struct RowLeaf {
  const float* __restrict__ rows;  // (P, F) rows in leaf order
  const float* __restrict__ vis;   // (P,) 0/1 in leaf order
  Cons C;
  int F, ptype, n_cl, shadow;
  int sph4;   // rows are 4-float spheres, 16-B aligned
  int best;   // leaf-order row of the best candidate, -1: the seed
  template <class Ray>
  __device__ __forceinline__ bool operator()(int first, int count,
                                             const Ray& r, float& bt) {
    for (int row = first; row < first + count; ++row) {
      if (!(__ldg(vis + row) > 0.5f)) continue;
      float t0, t1;
      if (sph4) {
        float4 q = __ldg((const float4*)rows + row);
        float p[4] = {q.x, q.y, q.z, q.w};
        r.count_prim();
        sphere_t(p, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t0, t1);
      } else {
        prim_candidates(ptype, rows + (size_t)row * F, false, F, r, t0, t1);
      }
      bool v0 = (t0 > 0.0f) && beats(t0, row, bt, best);
      bool v1 = (t1 > 0.0f) && beats(t1, row, bt, best);
      if (n_cl > 0) cons_filter(C, r, t0, t1, v0, v1);
      if (v0 || v1) {
        bt = v0 ? t0 : t1;
        best = row;
        if (shadow) return true;
      }
    }
    return false;
  }
};

// kTally: also write each ray's work tally (walk.cuh RayT).
template <bool kTally>
__global__ void __launch_bounds__(WALK_THREADS)
    bvh_select_kernel(const float* __restrict__ rays, int n,
                      const float* __restrict__ seeds,
                      const float4* __restrict__ nodes, int n_nodes,
                      int stack, const float* __restrict__ rows,
                      const float* __restrict__ vis, int F, int ptype,
                      Cons C, int shadow, float* __restrict__ out_t,
                      int* __restrict__ out_l, int* __restrict__ tally) {
  extern __shared__ int2 sstack[];
  int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= n) return;
  float seed = seeds[i];
  float bt = seed;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  int sph4 = ptype == PT_SPHERE && F == 4 && ((size_t)rows & 15) == 0;
  RowLeaf leaf{rows, vis, C, F, ptype, C.desc[0], shadow, sph4, -1};
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f)
    walk_pairs(nodes, n_nodes, r, Stack{sstack + threadIdx.x, stack}, bt,
               leaf);
  out_t[i] = bt;
  out_l[i] = bt < seed ? leaf.best : -1;
  r.store_tally(tally, n, i);
}

extern "C" int glome_bvh_select(const float* rays, int n, const float* seeds,
                                const float* nodes, int n_nodes, int stack,
                                const float* rows, const float* vis, int F,
                                int ptype, const float* cf, const int* cdesc,
                                int shadow, float* out_t, int* out_l,
                                int* tally, void* stream) {
  if (n <= 0) return 0;
  if (((size_t)nodes & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (stack < 1) return (int)cudaErrorInvalidValue;
  Cons C{cf, cdesc};
  int blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  size_t smem = stack_bytes(stack);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tally) {
    err = allow_smem(bvh_select_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    bvh_select_kernel<true><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, seeds, (const float4*)nodes, n_nodes, stack, rows, vis, F,
        ptype, C, shadow, out_t, out_l, tally);
  } else {
    err = allow_smem(bvh_select_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    bvh_select_kernel<false><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, seeds, (const float4*)nodes, n_nodes, stack, rows, vis, F,
        ptype, C, shadow, out_t, out_l, tally);
  }
  return (int)cudaGetLastError();
}
