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
// the tree alone, near child first, with a per-thread stack (bound
// BLOCK_STACK_MAX, checked against the plan's depth before launch) and its
// own best t for culling.  A leaf tests its bp rows in table order with a
// strict <, so the first row wins a tie inside a block, and a later block
// must be strictly nearer, as on the TPU.  Rows of transformed groups
// carry 12 inverse-matrix floats (walk.cuh prim_candidates, 1/sqrt like
// K1).  At most a few constraint clauses (block_kernel.BLOCK_CONS_MAX
// rows) are evaluated at each candidate point from a small descriptor
// table (csrc/cons.cuh eval_cons, as block_kernel.cons_ok does).  Shadow
// mode is any-hit: the ray stops at its first blocker.
//
// What bounds it on the card: the dependent loads of a divergent per-ray
// walk (node boxes, then 36-byte triangle rows) out of the L2 cache: a
// 100k-triangle mesh's table is 3.6 MB and its node tables about 1 MB,
// both far under the H100's 50 MB L2.  Warp-coherent traversal and
// shared-memory staging are later work.

#include <cuda_runtime.h>

#include "cons.cuh"
#include "prims.cuh"
#include "walk.cuh"

#define BLOCK_STACK_MAX 64

struct Group {
  const float* __restrict__ nf;   // (n_nodes, 6) node boxes
  const int* __restrict__ ni;     // (n_nodes, 3) [left, right, leaf_block]
  const float* __restrict__ tab;  // (n_blocks * bp, F) rows
  int n_nodes, bp, F, ptype, xf, nfld;
};

// one leaf block; returns true when a shadow ray is blocked
template <class Ray>
__device__ __forceinline__ bool leaf_test(const Group& G, const Cons& C,
                                          int n_cl, int b, const Ray& r,
                                          int shadow, float& bt, int& bs) {
  for (int q = 0; q < G.bp; ++q) {
    int row = b * G.bp + q;
    float t0, t1;
    prim_candidates(G.ptype, G.tab + (size_t)row * G.F, G.xf != 0, G.nfld, r,
                    t0, t1);
    bool v0 = (t0 > 0.0f) && (t0 < bt);
    bool v1 = (t1 > 0.0f) && (t1 < bt);
    if (n_cl > 0) cons_filter(C, r, t0, t1, v0, v1);
    float tc = v0 ? t0 : (v1 ? t1 : GLOME_INF);
    if (tc < bt) {
      bt = tc;
      bs = row * 2 + (v0 ? 0 : 1);
      if (shadow) return true;
    }
  }
  return false;
}

// kTally: also write each ray's work tally (walk.cuh RayT)
template <bool kTally>
__global__ void __launch_bounds__(128)
    block_select_kernel(const float* __restrict__ rays, int n,
                        const float* __restrict__ seeds, Group G, Cons C,
                        int shadow, float* __restrict__ out_t,
                        int* __restrict__ out_s, int* __restrict__ tally) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float seed = seeds[i];
  float bt = seed;
  int bs = -1;
  RayT<kTally> r = load_ray<kTally>(rays, n, i);
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  if (seed > 0.0f) {
    int n_cl = C.desc[0];
    int stack[BLOCK_STACK_MAX];
    float snear[BLOCK_STACK_MAX];
    int sp = 0;
    // the root is not box-tested (as on the TPU): a leaf root is one block
    int node = 0;
    // every node is visited at most once
    for (int steps = 0; steps <= G.n_nodes; ++steps) {
      if (node >= 0) {
        const int* nd = G.ni + node * 3;
        if (nd[2] >= 0) {
          if (leaf_test(G, C, n_cl, nd[2], r, shadow, bt, bs)) break;
          node = -1;
        } else {
          int L = nd[0], R = nd[1];
          float nL, nR;
          bool hL = box_live(G.nf + L * 6, r, bt, nL);
          bool hR = box_live(G.nf + R * 6, r, bt, nR);
          if (hL && hR) {
            bool lfirst = nL <= nR;
            node = lfirst ? L : R;
            if (sp < BLOCK_STACK_MAX) {
              stack[sp] = lfirst ? R : L;
              snear[sp] = lfirst ? nR : nL;
              ++sp;
            }
          } else {
            node = hL ? L : (hR ? R : -1);
          }
        }
      }
      if (node < 0) {
        // pop the next deferred subtree still nearer than the best hit
        while (sp > 0) {
          --sp;
          if (snear[sp] < bt) {
            node = stack[sp];
            break;
          }
        }
        if (node < 0) break;
      }
    }
  }
  out_t[i] = bt;
  out_s[i] = bt < seed ? bs : -1;
  r.store_tally(tally, n, i);
}

extern "C" int glome_block_select(const float* rays, int n, const float* seeds,
                                  const float* nf, const int* ni,
                                  const float* tab, int n_nodes, int bp,
                                  int F, int ptype, int xf, int nfld,
                                  const float* cf, const int* cdesc,
                                  int shadow, float* out_t, int* out_s,
                                  int* tally, void* stream) {
  if (n <= 0) return 0;
  Group G{nf, ni, tab, n_nodes, bp, F, ptype, xf, nfld};
  Cons C{cf, cdesc};
  const int threads = 128;
  int blocks = (n + threads - 1) / threads;
  if (tally)
    block_select_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        rays, n, seeds, G, C, shadow, out_t, out_s, tally);
  else
    block_select_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        rays, n, seeds, G, C, shadow, out_t, out_s, tally);
  return (int)cudaGetLastError();
}

extern "C" int glome_block_stack_max() { return BLOCK_STACK_MAX; }
