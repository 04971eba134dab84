// K4: seeded nearest (or any-hit) prim of ONE dense group.
//
// Replaces glome_tpu/pallas_kernels.py:dense_intersect (the Pallas TPU
// kernel of glome_tpu's pass-per-group route).  It computes the same
// (t, local): local indexes the group's prims in their packed order, -1
// where nothing beat the per-ray seed t (t == seed there).  The group
// arrives as the transposed parameter table of group_kernels.pack_params_T
// (FX rows of P columns: the nfld fields of each prim, then 12
// inverse-matrix rows for a transformed group), a 0/1 visibility row, an
// optional per-128-prim-block AABB table (group_kernels.block_aabbs) and
// the inline constraints (csrc/cons.cuh).
//
// Design.  The TPU kernel ran a grid over (1024-ray tile, 128-prim block)
// that accumulated the best (t, prim) in the output block like a matmul K
// loop, and culled a block when no ray of the tile hit its AABB before
// the tile's running best.  Here a CTA of 128 threads holds 128 rays, one
// per thread, and walks the group in 128-prim blocks in index order: the
// CTA stages each block's rows and visibility in shared memory (every
// thread then reads the same prim at the same time, a broadcast), and each
// ray culls the block by its own best t.  Prims are tested in index order
// with a strict <, so the first prim wins a tie inside a block and a later
// block must be strictly nearer, as the TPU's argmin and carry do.  Rays
// with seed <= 0 (other scenes' rays, dead lanes) do no work.  Shadow mode
// is any-hit: a ray stops at its first blocker, and a CTA stops once none
// of its rays is still searching.  Transformed rows go through walk.cuh
// prim_candidates (1/sqrt of |d|^2, as K1 and the plain versions compute
// it; the Pallas kernel's rsqrt rounds otherwise).
//
// What bounds it on the card: float32 work.  Each ray tests every prim of
// every block its box test does not cull, and the rows come from shared
// memory, so the kernel is arithmetic over a few KB of parameters per
// block; for TestScene's biggest dense group (1,024 transformed cones)
// the AABB cull decides the work.

#include <cuda_runtime.h>

#include "cons.cuh"
#include "prims.cuh"
#include "walk.cuh"

// prims per block, and rays per CTA
#define DENSE_BP 128
// the widest row: trianglenorm's 18 fields + 12 inverse-matrix floats
#define DENSE_FX_MAX 30

struct Dense {
  const float* __restrict__ tab;   // (FX, P) transposed rows
  const float* __restrict__ vis;   // (P,) 0/1
  const float* __restrict__ bbox;  // (ceil(P / DENSE_BP), 8) AABBs or null
  int P, FX, nfld, ptype, xf;
};

// kTally: also write each ray's work tally (walk.cuh RayT)
template <bool kTally>
__global__ void __launch_bounds__(DENSE_BP)
    dense_select_kernel(const float* __restrict__ rays, int n,
                        const float* __restrict__ seeds, Dense D, Cons C,
                        int shadow, float* __restrict__ out_t,
                        int* __restrict__ out_l, int* __restrict__ tally) {
  __shared__ float srow[DENSE_BP * DENSE_FX_MAX];
  __shared__ float svis[DENSE_BP];
  int tid = threadIdx.x;
  int i = blockIdx.x * DENSE_BP + tid;
  bool in = i < n;
  float seed = in ? seeds[i] : 0.0f;
  float bt = seed;
  int bl = -1;
  RayT<kTally> r = load_ray<kTally>(rays, n, in ? i : n - 1);
  // dead lanes (seed <= 0) fail every candidate: 0 < t < seed is empty
  bool done = !(in && seed > 0.0f);
  int n_cl = C.desc[0];
  for (int j0 = 0; j0 < D.P; j0 += DENSE_BP) {
    // the barrier keeps the last block's rows until every thread is done
    // with them, and ends the walk once no ray of the CTA is searching
    if (!__syncthreads_or(!done)) break;
    int cnt = min(DENSE_BP, D.P - j0);
    if (tid < cnt) {
      for (int f = 0; f < D.FX; ++f)
        srow[tid * D.FX + f] = D.tab[(size_t)f * D.P + j0 + tid];
      svis[tid] = D.vis[j0 + tid];
    }
    __syncthreads();
    if (done) continue;
    if (D.bbox != nullptr) {
      float near;
      if (!box_live(D.bbox + (size_t)(j0 / DENSE_BP) * 8, r, bt, near))
        continue;
    }
    for (int q = 0; q < cnt; ++q) {
      if (!(svis[q] > 0.5f)) continue;
      float t0, t1;
      prim_candidates(D.ptype, srow + q * D.FX, D.xf != 0, D.nfld, r, t0,
                      t1);
      bool v0 = (t0 > 0.0f) && (t0 < bt);
      bool v1 = (t1 > 0.0f) && (t1 < bt);
      if (n_cl > 0) cons_filter(C, r, t0, t1, v0, v1);
      float tc = v0 ? t0 : (v1 ? t1 : GLOME_INF);
      if (tc < bt) {
        bt = tc;
        bl = j0 + q;
        if (shadow) {
          done = true;
          break;
        }
      }
    }
  }
  if (in) {
    out_t[i] = bt;
    out_l[i] = bt < seed ? bl : -1;
    r.store_tally(tally, n, i);
  }
}

extern "C" int glome_dense_select(const float* rays, int n, const float* seeds,
                                  const float* tab, const float* vis,
                                  const float* bbox, int P, int FX, int nfld,
                                  int ptype, int xf, const float* cf,
                                  const int* cdesc, int shadow, float* out_t,
                                  int* out_l, int* tally, void* stream) {
  if (n <= 0) return 0;
  if (FX > DENSE_FX_MAX || FX < nfld) return (int)cudaErrorInvalidValue;
  Dense D{tab, vis, bbox, P, FX, nfld, ptype, xf};
  Cons C{cf, cdesc};
  int blocks = (n + DENSE_BP - 1) / DENSE_BP;
  if (tally)
    dense_select_kernel<true><<<blocks, DENSE_BP, 0, (cudaStream_t)stream>>>(
        rays, n, seeds, D, C, shadow, out_t, out_l, tally);
  else
    dense_select_kernel<false><<<blocks, DENSE_BP, 0, (cudaStream_t)stream>>>(
        rays, n, seeds, D, C, shadow, out_t, out_l, tally);
  return (int)cudaGetLastError();
}

extern "C" int glome_dense_block() { return DENSE_BP; }
extern "C" int glome_dense_fx_max() { return DENSE_FX_MAX; }
