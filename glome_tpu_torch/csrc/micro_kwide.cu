// M2: the K-wide frontier walk and tile-scratch scalar reads, per
// 1024-ray tile.
//
// Replaces tools/micro_kwide.py:47 `mk_walk` (pallas_call at :109) and
// :138 `mk_vread` (pallas_call at :149), the TPU microbenchmarks of the
// megakernel's K-wide frontier ("K batched slab tests + K reductions cost
// ~one drain").  The plain torch versions are
// glome_tpu_torch/tools/micro_kwide.py's walk_plain / vread_plain; built
// with -fmad=false and IEEE division, the kernels equal them exactly.
//
//   walk<K>    the tile shares one stack over an implicit heap of M node
//              boxes, starting [0]; each iteration pops kk = min(sp, K)
//              nodes, slab-tests each against every ray of the tile, and
//              pushes 2n+1, 2n+2 (in pop order) for each inner node that
//              SOME ray hit.  Output: the nodes popped, per tile.
//   vread<N>   acc = sum_{i<N} ox[i % 8, (i*13) % 128] of the tile, in i
//              order from 0, broadcast to the tile.
//
// What bounds them on this card: the walk is a chain of dependent
// block-wide decisions (359 nodes per tile on the tool's inputs, one
// barrier per iteration), not bytes or float work; vread is a launch.
//
// Design.  One block of 1024 threads per tile, the stack (1024 entries,
// as the TPU's SMEM scratch) in shared memory.  The K hit votes of an
// iteration are warp ballots written into shared memory as the
// iteration's stamp, in a buffer that alternates between iterations, so
// one __syncthreads per iteration separates the votes from their reading
// and no buffer needs clearing: the card's version of "K reductions cost
// one drain".  After the barrier every thread reads the same votes and
// applies the same pushes to the shared stack (the same values into the
// same entries), so the next pop reads the thread's own writes and needs
// no second barrier.  Each node enters the stack at most once (a heap
// node has one parent), so M <= WALK_STACK entries cannot overflow it;
// the C entry refuses a larger heap instead of writing past the end.

#include <cuda_runtime.h>

#include "micro.cuh"

constexpr int WALK_STACK = 1024;

// tools/micro_kwide.py:56 slab: the box (lo xyz, hi xyz) is live for the
// ray: near <= far and far > 0
__device__ __forceinline__ bool slab(const float* __restrict__ b, float ox,
                                     float oy, float oz, float ivx, float ivy,
                                     float ivz) {
  float t1x = (__ldg(b + 0) - ox) * ivx;
  float t2x = (__ldg(b + 3) - ox) * ivx;
  float t1y = (__ldg(b + 1) - oy) * ivy;
  float t2y = (__ldg(b + 4) - oy) * ivy;
  float t1z = (__ldg(b + 2) - oz) * ivz;
  float t2z = (__ldg(b + 5) - oz) * ivz;
  float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return (near <= far) && (far > 0.0f);
}

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-20f : d);
}

template <int K>
__global__ void __launch_bounds__(MICRO_TILE)
    walk_kernel(const float* __restrict__ rays, int T,
                const float* __restrict__ nf, int M,
                float* __restrict__ out) {
  __shared__ int stack[WALK_STACK];
  __shared__ int votes[2][K];   // iteration stamp where some ray hit pop k
  float ox = tile_ray(rays, T, 0), oy = tile_ray(rays, T, 1),
        oz = tile_ray(rays, T, 2);
  float ivx = inv_dir(tile_ray(rays, T, 3)),
        ivy = inv_dir(tile_ray(rays, T, 4)),
        ivz = inv_dir(tile_ray(rays, T, 5));
  if (threadIdx.x < 2 * K) votes[threadIdx.x / K][threadIdx.x % K] = -1;
  if (threadIdx.x == 0) stack[0] = 0;
  __syncthreads();
  const bool leader = (threadIdx.x & 31) == 0;
  int sp = 1, popped = 0;
  for (int it = 0; sp > 0; ++it) {
    const int buf = it & 1;
    const int kk = min(sp, K);   // the same in every thread
    int node[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kk) {
        node[k] = stack[sp - 1 - k];
        bool hit = slab(nf + 6 * node[k], ox, oy, oz, ivx, ivy, ivz);
        if (__ballot_sync(0xFFFFFFFFu, hit) && leader) votes[buf][k] = it;
      }
    }
    __syncthreads();
    sp -= kk;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kk && votes[buf][k] == it && 2 * node[k] + 2 < M) {
        stack[sp] = 2 * node[k] + 1;
        stack[sp + 1] = 2 * node[k] + 2;
        sp += 2;
      }
    }
    popped += kk;
  }
  tile_store(out, (float)popped);
}

template <int NREAD>
__global__ void __launch_bounds__(MICRO_TILE)
    vread_kernel(const float* __restrict__ rays, int T,
                 float* __restrict__ out) {
  __shared__ float vs[MICRO_TILE];
  vs[threadIdx.x] = tile_ray(rays, T, 0);
  __syncthreads();
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < NREAD; ++i)
    acc = acc + vs[(i % 8) * MICRO_LANES + (i * 13) % MICRO_LANES];
  tile_store(out, acc);
}

// --- C entries ------------------------------------------------------------
// Each launches T blocks of 1024 threads on `stream` and returns the
// launch's cudaError: cudaErrorInvalidValue for a K or NREAD without a
// build, or a heap larger than the stack.

extern "C" int glome_micro_walk(const float* rays, int T, const float* nf,
                                int M, int K, float* out, void* stream) {
  if (M <= 0 || M > WALK_STACK) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: walk_kernel<1><<<T, MICRO_TILE, 0, s>>>(rays, T, nf, M, out); break;
    case 2: walk_kernel<2><<<T, MICRO_TILE, 0, s>>>(rays, T, nf, M, out); break;
    case 4: walk_kernel<4><<<T, MICRO_TILE, 0, s>>>(rays, T, nf, M, out); break;
    case 8: walk_kernel<8><<<T, MICRO_TILE, 0, s>>>(rays, T, nf, M, out); break;
    case 16:
      walk_kernel<16><<<T, MICRO_TILE, 0, s>>>(rays, T, nf, M, out);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int glome_micro_vread(const float* rays, int T, int nread,
                                 float* out, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nread) {
    case 16: vread_kernel<16><<<T, MICRO_TILE, 0, s>>>(rays, T, out); break;
    case 64: vread_kernel<64><<<T, MICRO_TILE, 0, s>>>(rays, T, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
