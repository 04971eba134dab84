// The near-first walk of a strictly binary BVH stored as child-pair
// records, shared by K2 (block_select.cu), K3 (mesh_block_select.cu) and
// K5 (bvh_select.cu); K1 (mega_select.cu) reads the same records and the
// same shared stack with its own walk, whose tie rule is the reference's
// strict <.
//
// A record (accel.node_records) is 64 aligned bytes: both children's
// boxes (bmin xyz, bmax xyz each, floats 0-11) and their references
// (floats 12 and 13, int32 bits).  A reference r > 0 names the record of
// an internal node, r < 0 a leaf with ~r = first_row << 5 | row_count, 0
// none; record 0 holds the root's box in the left slot and its reference
// at float 12.  One record is four __ldg float4 loads in one round, so a
// step waits on one load latency instead of three rounds of scalar loads.
//
// The deferred far children wait on a stack of packed (reference, near)
// entries in dynamic shared memory, one column per thread (entry k of
// thread x at k * WALK_THREADS + x), sized by the caller from the
// deepest tree of the launch: a near-first walk holds at most depth - 1
// entries (kernels.walk_stack).
#pragma once

#include <cuda_runtime.h>

#include "walk.cuh"

// threads per CTA of the walking kernels
#define WALK_THREADS 128
// floats per child-pair record (accel.NODE_W)
#define NODE_W 16
// static shared memory a kernel may use without opting in
#define WALK_SMEM_DEFAULT (48 * 1024)

struct Stack {
  int2* e;   // this thread's column of the CTA's shared stack
  int cap;   // entries per thread
  __device__ __forceinline__ void put(int k, int ref, float near) {
    e[k * WALK_THREADS] = make_int2(ref, __float_as_int(near));
  }
  __device__ __forceinline__ int2 get(int k) const {
    return e[k * WALK_THREADS];
  }
};

// bytes of dynamic shared memory of a stack of `entries` per thread
static inline size_t stack_bytes(int entries) {
  return (size_t)entries * WALK_THREADS * sizeof(int2);
}

// let `kernel` launch with `bytes` of dynamic shared memory: above the
// default 48 KB a kernel must opt in, up to the device's per-block limit
template <class K>
static cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= WALK_SMEM_DEFAULT) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// slab test of a box against the ray that keeps a box whose entry
// distance EQUALS the limit: a row tied with the best can still win by
// its lower row number (the first-row tie rule below)
template <class Ray>
__device__ __forceinline__ bool box_reach(float x0, float y0, float z0,
                                          float x1, float y1, float z1,
                                          const Ray& r, float lim,
                                          float& near) {
  float far;
  box_span(x0, y0, z0, x1, y1, z1, r, near, far);
  return (near <= far) && (far > 0.0f) && (near <= lim);
}

// First-row ties: the best candidate is the least (t, row).  A candidate
// at distance t in row `row` beats the best (bt, brow) when t < bt, or
// when t == bt and the best is a real row (brow >= 0: the seed never
// ties) with a higher number.  Then the walk's visiting order cannot
// change the winner, which is the plain versions' argmin over rows.
__device__ __forceinline__ bool beats(float t, int row, float bt, int brow) {
  return t < bt || (t == bt && brow >= 0 && row < brow);
}

// Near-first walk over the records `rec` of a tree of n_nodes nodes.  The
// leaf functor `leaf(first_row, row_count, r, bt)` tests a leaf's rows,
// updates bt (and its own best row) and returns true when the ray is
// done (a shadow ray's first blocker).  Boxes and deferred subtrees are
// culled only when they start beyond bt, so a tied row in a later
// subtree is still reached.
template <class Ray, class Leaf>
__device__ __forceinline__ void walk_pairs(const float4* __restrict__ rec,
                                           int n_nodes, const Ray& r,
                                           Stack st, float& bt, Leaf& leaf) {
  int sp = 0;
  int node;
  {
    float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 3);
    float near;
    node = box_reach(a.x, a.y, a.z, a.w, b.x, b.y, r, bt, near)
               ? __float_as_int(c.x)
               : 0;
  }
  // every node is visited at most once
  for (int steps = 0; node != 0 && steps <= n_nodes; ++steps) {
    if (node < 0) {
      int packed = ~node;
      if (leaf(packed >> 5, packed & 31, r, bt)) return;
      node = 0;
    } else {
      // one load round: both children's boxes and references
      const float4* q = rec + (size_t)node * (NODE_W / 4);
      float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
             e = __ldg(q + 3);
      float nL, nR;
      bool hL = box_reach(a.x, a.y, a.z, a.w, b.x, b.y, r, bt, nL);
      bool hR = box_reach(b.z, b.w, c.x, c.y, c.z, c.w, r, bt, nR);
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
    if (node == 0) {
      // pop the next deferred subtree that does not start beyond bt
      while (sp > 0) {
        --sp;
        int2 top = st.get(sp);
        if (__int_as_float(top.y) <= bt) {
          node = top.x;
          break;
        }
      }
    }
  }
}
