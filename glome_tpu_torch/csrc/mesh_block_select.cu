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
// over 128-triangle blocks (4 blocks per leaf).  Here one thread walks
// the same kind of tree (accel.build_bvh over blocks, stackless: a box
// miss jumps to the node's skip link, a hit falls through to the next
// node) for one ray, and reads each leaf's rows straight from device
// memory: the table is stored in leaf order, so a leaf is one contiguous
// run of 36-byte rows, and a 250k-triangle table (9 MB) stays in the
// H100's 50 MB L2.  Blocks are narrow (mesh_kernel.BP rows) because a
// thread tests a leaf's rows one after another.  The walk visits leaves
// in table order, so the first row wins a tie, as the plain version's
// argmin does.  Shadow mode is any-hit: the ray stops at its first
// blocker.
//
// What bounds it on the card: the dependent loads of a divergent per-ray
// walk out of L2.  The skip-link order cannot put the nearer child
// first, so a ray may test far leaves before a near hit culls them.

#include <cuda_runtime.h>

#include "prims.cuh"
#include "walk.cuh"

#define TRI_F 9

// kTally: also write each ray's work tally (walk.cuh RayT)
template <bool kTally>
__global__ void __launch_bounds__(128)
    mesh_block_select_kernel(const float* __restrict__ rays, int n,
                             const float* __restrict__ seeds,
                             const float* __restrict__ nf,
                             const int* __restrict__ ni, int n_nodes,
                             const float* __restrict__ tri, int bp,
                             int shadow, float* __restrict__ out_t,
                             int* __restrict__ out_s,
                             int* __restrict__ tally) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float seed = seeds[i];
  float bt = seed;
  int bl = -1;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f) {
    int node = 0;
    bool blocked = false;
    // skip links and fall-through both move forward: at most n_nodes steps
    while (node < n_nodes && !blocked) {
      const int* nd = ni + node * 3;
      float near;
      if (box_live(nf + node * 6, r, bt, near)) {
        int end = (nd[1] + nd[2]) * bp;
        for (int row = nd[1] * bp; row < end; ++row) {
          float t0, t1;
          r.count_prim();
          triangle_t(tri + (size_t)row * TRI_F, r.ox, r.oy, r.oz, r.dx, r.dy,
                     r.dz, t0, t1);
          if ((t0 > 0.0f) && (t0 < bt)) {
            bt = t0;
            bl = row;
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
  out_s[i] = bt < seed ? bl : -1;
  r.store_tally(tally, n, i);
}

extern "C" int glome_mesh_block_select(const float* rays, int n,
                                       const float* seeds, const float* nf,
                                       const int* ni, int n_nodes,
                                       const float* tri, int bp, int shadow,
                                       float* out_t, int* out_s,
                                       int* tally, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  if (tally)
    mesh_block_select_kernel<true>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            rays, n, seeds, nf, ni, n_nodes, tri, bp, shadow, out_t, out_s,
            tally);
  else
    mesh_block_select_kernel<false>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            rays, n, seeds, nf, ni, n_nodes, tri, bp, shadow, out_t, out_s,
            tally);
  return (int)cudaGetLastError();
}
