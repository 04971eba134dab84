// K4: seeded nearest (or any-hit) prim of ONE dense group.
//
// Replaces glome_tpu/pallas_kernels.py:dense_intersect (the Pallas TPU
// kernel of glome_tpu's pass-per-group route).  It computes the same
// (t, local): local indexes the group's prims in their packed order, -1
// where nothing beat the per-ray seed t (t == seed there).  The group
// arrives as the transposed parameter table of group_kernels.pack_params_T
// (FX rows of P columns: the nfld fields of each prim, then 12
// inverse-matrix rows for a transformed group), a 0/1 visibility row, an
// optional cull table (group_kernels.cull_aabbs: one padded world AABB per
// 32-prim sub-block, then one per prim) and the inline constraints
// (csrc/cons.cuh).
//
// Design.  The TPU kernel ran a grid over (1024-ray tile, 128-prim block)
// that accumulated the best (t, prim) in the output block like a matmul K
// loop, and culled a block when no ray of the tile hit its AABB before
// the tile's running best.  Here a CTA of 128 threads holds 128 rays, one
// per thread, and walks the group in 128-prim blocks in index order.
// Each ray first slab-tests the block's (up to four) 32-prim sub-block
// boxes against its own best t; in a group of more than one block, a
// block that no ray of the CTA enters is not staged at all.  Otherwise
// the CTA stages the block's rows, visibility and per-prim boxes in shared
// memory (every thread then reads the same prim at the same time, a
// broadcast).  Each lane skips the sub-blocks it does not enter (a warp
// none of whose lanes enters one skips it whole; a warp vote there decides
// nothing more and makes ptxas spill, which doubled a one-prim group's
// time), and inside a sub-block each ray slab-tests a prim's own box
// against its best t before it pays for the prim's transform and
// quadratic.  The boxes are padded outward (cull_aabbs) and every cull is
// conservative, so the rays meet the prims that can hold a candidate in
// index order, and a strict < keeps the first prim on a tie, as the TPU's
// argmin and carry and the brute-force plain version do.  Rays with seed
// <= 0 (other scenes' rays, dead lanes) do no work.  Shadow mode is
// any-hit: a ray stops at its first blocker, and a CTA stops once none of
// its rays is still searching.  Transformed rows go through walk.cuh prim_candidates (1/sqrt
// of |d|^2, as K1 and the plain versions compute it; the Pallas kernel's
// rsqrt rounds otherwise).
//
// What bounds it on the card: float32 work, the prim tests that pass the
// per-prim box cull (on TestScene's 1,024 transformed cones, a cone test
// is ~100 operations against a box test's 25) and the box tests
// themselves; the rows come from shared memory.  Without a cull table
// (planes) every ray tests every prim.

#include <cuda_runtime.h>

#include "cons.cuh"
#include "prims.cuh"
#include "walk.cuh"

// prims per block, and rays per CTA
#define DENSE_BP 128
// prims per sub-block: one box each
#define DENSE_SUB 32
// the widest row: trianglenorm's 18 fields + 12 inverse-matrix floats
#define DENSE_FX_MAX 30
// floats per row of the cull table: bmin xyz, bmax xyz, 2 pad
#define DENSE_BOX_W 8

struct Dense {
  const float* __restrict__ tab;   // (FX, P) transposed rows
  const float* __restrict__ vis;   // (P,) 0/1
  // (ceil(P / DENSE_SUB) + P, DENSE_BOX_W): sub-block boxes, then prim
  // boxes; null: no cull
  const float* __restrict__ cull;
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
  __shared__ float sbox[DENSE_BP * 6];
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
  bool cull = D.cull != nullptr;
  int n_sub = (D.P + DENSE_SUB - 1) / DENSE_SUB;
  const float* pbox = cull ? D.cull + (size_t)n_sub * DENSE_BOX_W : nullptr;
  for (int j0 = 0; j0 < D.P; j0 += DENSE_BP) {
    // the barrier keeps the last block's rows until every thread is done
    // with them, and ends the walk once no ray of the CTA is searching
    if (!__syncthreads_or(!done)) break;
    int cnt = min(DENSE_BP, D.P - j0);
    int ns = (cnt + DENSE_SUB - 1) / DENSE_SUB;
    // bit s: this ray enters sub-block s of the block before its best t
    unsigned enter = 0;
    if (!done) {
      if (cull) {
        const float* sb = D.cull + (size_t)(j0 / DENSE_SUB) * DENSE_BOX_W;
        for (int s = 0; s < ns; ++s) {
          float near;
          if (box_live(sb + s * DENSE_BOX_W, r, bt, near)) enter |= 1u << s;
        }
      } else {
        enter = (1u << ns) - 1u;
      }
    }
    // a block that no ray of the CTA enters is not staged; a group of one
    // block is staged at once (the vote would only add a barrier)
    if (D.P > DENSE_BP && !__syncthreads_or(enter != 0u)) continue;
    if (tid < cnt) {
      for (int f = 0; f < D.FX; ++f)
        srow[tid * D.FX + f] = D.tab[(size_t)f * D.P + j0 + tid];
      svis[tid] = D.vis[j0 + tid];
      if (cull) {
        const float* b = pbox + (size_t)(j0 + tid) * DENSE_BOX_W;
        for (int k = 0; k < 6; ++k) sbox[tid * 6 + k] = b[k];
      }
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      if (!((enter >> s) & 1u)) continue;
      int q1 = min(cnt, (s + 1) * DENSE_SUB);
      for (int q = s * DENSE_SUB; q < q1; ++q) {
        if (!(svis[q] > 0.5f)) continue;
        float near;
        if (cull && !box_live(sbox + q * 6, r, bt, near)) continue;
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
      if (done) enter = 0u;   // shadow: blocked, nothing more to test
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
                                  const float* cull, int P, int FX, int nfld,
                                  int ptype, int xf, const float* cf,
                                  const int* cdesc, int shadow, float* out_t,
                                  int* out_l, int* tally, void* stream) {
  if (n <= 0) return 0;
  if (FX > DENSE_FX_MAX || FX < nfld) return (int)cudaErrorInvalidValue;
  Dense D{tab, vis, cull, P, FX, nfld, ptype, xf};
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
extern "C" int glome_dense_sub() { return DENSE_SUB; }
extern "C" int glome_dense_fx_max() { return DENSE_FX_MAX; }
