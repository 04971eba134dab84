// K3: seeded nearest (or any-hit) flat triangle of ONE giant mesh group.
//
// Replaces glome_tpu/mesh_kernel.py:mesh_block_select (the Pallas TPU
// kernel).  It computes the same (t, sel): sel indexes the block-permuted
// triangle table (mesh_kernel.pack_tri_blocks; the caller maps it to the
// group-local triangle through plan.sel_to_local), -1 where nothing beat
// the per-ray seed t.  Flat triangles only: their exit crossing is always
// a miss, so the winner carries no slot bit.
//
// Design.  The TPU kernel kept the table in HBM and DMA'd only the leaf
// blocks a 1024-ray tile could reach into VMEM, walking a skip-link BVH
// over 128-triangle blocks (4 blocks per leaf).  Here one thread walks a
// strictly binary tree over narrow blocks (mesh_kernel.BP rows, at most
// mesh_kernel.BLOCK_LEAF_MAX blocks per leaf; accel.build_bvh2) for one
// ray with csrc/bvh_walk.cuh's near-first walk, the one K2 walks: 64-B
// child-pair records (accel.node_records), one float4 load round per step,
// the far children on a stack in dynamic shared memory sized from the
// plan's depth.  (A skip-link walk cannot take the nearer child first,
// so it tests far leaves before a near hit culls them: twice the
// triangle tests.)  The table is stored in the tree's leaf order, so a
// leaf is one contiguous run of rows, each padded to 12 floats (48 B:
// p1, p2, p3 and three zeros) and read as three aligned float4 loads.
// Blocks of 4 rows, one a leaf, were the fastest of 4 or 8 rows and 1
// or 2 blocks a leaf on the H100: the leaf test is the costly step.  The
// best candidate is the least (t, row), with boxes culled only beyond the
// best t, so the winner is the plain version's argmin over the permuted
// rows whatever the visiting order.  Shadow mode is any-hit: the ray
// stops at its first blocker.
//
// What bounds it on the card: the dependent loads of a divergent per-ray
// walk out of L2: a 250k-triangle table is 12 MB and its records 4 MB,
// both inside the H100's 50 MB L2.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"
#include "prims.cuh"
#include "walk.cuh"

// floats per padded triangle row (mesh_kernel.TRI_F)
#define TRI_F 12

// the rows of one leaf against the best (bt, best row)
struct TriLeaf {
  const float4* __restrict__ tri;   // TRI_F / 4 float4 per row
  int shadow;
  int best;   // permuted row of the best candidate, -1: the seed
  template <class Ray>
  __device__ __forceinline__ bool operator()(int first, int count,
                                             const Ray& r, float& bt) {
    for (int row = first; row < first + count; ++row) {
      const float4* q = tri + (size_t)row * (TRI_F / 4);
      float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      float p[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
      float t0, t1;
      r.count_prim();
      triangle_t(p, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t0, t1);
      if ((t0 > 0.0f) && beats(t0, row, bt, best)) {
        bt = t0;
        best = row;
        if (shadow) return true;
      }
    }
    return false;
  }
};

// kTally: also write each ray's work tally (walk.cuh RayT).  At least 8
// CTAs per SM, as K2.
template <bool kTally>
__global__ void __launch_bounds__(WALK_THREADS, 8)
    mesh_block_select_kernel(const float* __restrict__ rays, int n,
                             const float* __restrict__ seeds,
                             const float4* __restrict__ nodes, int n_nodes,
                             const float4* __restrict__ tri, int stack,
                             int shadow, float* __restrict__ out_t,
                             int* __restrict__ out_s,
                             int* __restrict__ tally) {
  extern __shared__ int2 sstack[];
  int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= n) return;
  float seed = seeds[i];
  float bt = seed;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  TriLeaf leaf{tri, shadow, -1};
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f)
    walk_pairs(nodes, n_nodes, r, Stack{sstack + threadIdx.x, stack}, bt,
               leaf);
  out_t[i] = bt;
  out_s[i] = bt < seed ? leaf.best : -1;
  r.store_tally(tally, n, i);
}

extern "C" int glome_mesh_block_select(const float* rays, int n,
                                       const float* seeds, const float* nodes,
                                       int n_nodes, const float* tri,
                                       int stack, int shadow, float* out_t,
                                       int* out_s, int* tally, void* stream) {
  if (n <= 0) return 0;
  if ((((size_t)nodes | (size_t)tri) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (stack < 1) return (int)cudaErrorInvalidValue;
  int blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  size_t smem = stack_bytes(stack);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tally) {
    err = allow_smem(mesh_block_select_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    mesh_block_select_kernel<true><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, seeds, (const float4*)nodes, n_nodes, (const float4*)tri,
        stack, shadow, out_t, out_s, tally);
  } else {
    err = allow_smem(mesh_block_select_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    mesh_block_select_kernel<false><<<blocks, WALK_THREADS, smem, s>>>(
        rays, n, seeds, (const float4*)nodes, n_nodes, (const float4*)tri,
        stack, shadow, out_t, out_s, tally);
  }
  return (int)cudaGetLastError();
}
