// K2: seeded nearest (or any-hit) prim of ONE big group.
//
// Replaces glome_tpu/block_kernel.py:block_select (the Pallas TPU kernel).
// It computes the same (t, sel2): sel2 = row * 2 + slot (slot 0 entry,
// 1 exit) into the group's packed table, -1 where nothing beat the
// per-ray seed t.  The table (block_kernel.pack_blocks) holds the group's
// rows in their packed (Morton) order, cut into n_blocks blocks of bp rows
// (the last block padded with copies of the last row, which can never win
// a hit the real row does not); a strictly binary BVH over the block
// AABBs (accel.build_bvh2, one block per leaf) culls them.
//
// Design.  One thread per ray.  The TPU kernel walked the tree once per
// (8, 128) ray tile, choosing the near child by a vote of the tile's lanes
// and testing a leaf densely as (bp, 128) candidates; here every ray walks
// the tree alone with csrc/bvh_walk.cuh's near-first walk: the tree is
// stored as 64-B child-pair records (accel.node_records; a leaf reference
// packs its block's first row and bp), one float4 load round per step, and
// the far children wait on a stack in dynamic shared memory sized from
// the plan's depth (kernels.walk_stack).  The best candidate is the least
// (t, row): a candidate at the best t wins when its row is lower, and the
// walk culls only boxes that start beyond the best t, so the winner is
// that of the plain version's argmin over rows, whatever the order in
// which the walk visits the blocks.  Rows of transformed groups carry 12
// inverse-matrix floats (walk.cuh prim_candidates, 1/sqrt like K1).  At
// most a few constraint clauses (block_kernel.BLOCK_CONS_MAX rows) are
// evaluated at each candidate point from a small descriptor table
// (csrc/cons.cuh eval_cons, as block_kernel.cons_ok does).  Shadow mode is
// any-hit: the ray stops at its first blocker.
//
// What bounds it on the card: the dependent loads of a divergent per-ray
// walk out of the L2 cache: a 100k-triangle mesh's table is 3.6 MB and its
// records about 1.6 MB, both far under the H100's 50 MB L2.  The records
// cut a step from three rounds of loads (node ints, then two unaligned
// boxes) to one.  Rows of untransformed triangles are padded to 12 floats
// (block_kernel.TRI_F, as K3's rows) and read as three aligned float4
// loads; every other row is read one float at a time by the generic
// prim test.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"
#include "cons.cuh"
#include "prims.cuh"
#include "walk.cuh"

struct Group {
  const float4* __restrict__ nodes;  // child-pair records
  const float* __restrict__ tab;     // (n_blocks * bp, F) rows
  int n_nodes, F, ptype, xf, nfld;
  int tri4;   // rows are 12-float untransformed triangles, 16-B aligned
};

// the rows of one leaf block against the best (bt, best row)
struct BlockLeaf {
  Group G;
  Cons C;
  int n_cl, shadow;
  int best;   // row * 2 + slot of the best candidate, -1: the seed
  template <class Ray>
  __device__ __forceinline__ bool operator()(int first, int count,
                                             const Ray& r, float& bt) {
    for (int q = 0; q < count; ++q) {
      int row = first + q;
      float t0, t1;
      if (G.tri4) {
        const float4* r4 = (const float4*)G.tab + (size_t)row * 3;
        float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2);
        float p[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
        r.count_prim();
        triangle_t(p, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t0, t1);
      } else {
        prim_candidates(G.ptype, G.tab + (size_t)row * G.F, G.xf != 0,
                        G.nfld, r, t0, t1);
      }
      int brow = best >> 1;   // -1 stays -1
      bool v0 = (t0 > 0.0f) && beats(t0, row, bt, brow);
      bool v1 = (t1 > 0.0f) && beats(t1, row, bt, brow);
      if (n_cl > 0) cons_filter(C, r, t0, t1, v0, v1);
      if (v0 || v1) {
        bt = v0 ? t0 : t1;
        best = row * 2 + (v0 ? 0 : 1);
        if (shadow) return true;
      }
    }
    return false;
  }
};

// kTally: also write each ray's work tally (walk.cuh RayT).  At least 8
// CTAs per SM: ptxas then may use 64 registers; left to itself it chose
// 48 and spilled in the walk.
template <bool kTally>
__global__ void __launch_bounds__(WALK_THREADS, 8)
    block_select_kernel(const float* __restrict__ rays, int n,
                        const float* __restrict__ seeds, Group G, Cons C,
                        int stack, int shadow, float* __restrict__ out_t,
                        int* __restrict__ out_s, int* __restrict__ tally) {
  extern __shared__ int2 sstack[];
  int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= n) return;
  float seed = seeds[i];
  float bt = seed;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  BlockLeaf leaf{G, C, C.desc[0], shadow, -1};
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f)
    walk_pairs(G.nodes, G.n_nodes, r, Stack{sstack + threadIdx.x, stack}, bt,
               leaf);
  out_t[i] = bt;
  out_s[i] = bt < seed ? leaf.best : -1;
  r.store_tally(tally, n, i);
}

extern "C" int glome_block_select(const float* rays, int n, const float* seeds,
                                  const float* nodes, const float* tab,
                                  int n_nodes, int stack, int F, int ptype,
                                  int xf, int nfld, const float* cf,
                                  const int* cdesc, int shadow, float* out_t,
                                  int* out_s, int* tally, void* stream) {
  if (n <= 0) return 0;
  if (((size_t)nodes & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (stack < 1) return (int)cudaErrorInvalidValue;
  int tri4 = (ptype == PT_TRIANGLE || ptype == PT_TRIANGLENORM) && !xf &&
             F == 12 && ((size_t)tab & 15) == 0;
  Group G{(const float4*)nodes, tab, n_nodes, F, ptype, xf, nfld, tri4};
  Cons C{cf, cdesc};
  int blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  size_t smem = stack_bytes(stack);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tally) {
    err = allow_smem(block_select_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    block_select_kernel<true><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, seeds, G, C, stack, shadow, out_t, out_s, tally);
  } else {
    err = allow_smem(block_select_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    block_select_kernel<false><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, seeds, G, C, stack, shadow, out_t, out_s, tally);
  }
  return (int)cudaGetLastError();
}
