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
// Design.  The walk is one block of 1024 threads per tile (its vote is
// tile-wide), the stack (1024 entries, as the TPU's SMEM scratch) in
// shared memory.  The K hit votes of an iteration are warp ballots
// written into shared memory as the iteration's stamp, in a buffer that
// alternates between iterations, so one __syncthreads per iteration
// separates the votes from their reading and no buffer needs clearing:
// the card's version of "K reductions cost one drain".  After the
// barrier every thread reads the same votes and applies the same pushes
// to the shared stack (the same values into the same entries), so the
// next pop reads the thread's own writes and needs no second barrier.
// Each node enters the stack at most once (a heap node has one parent),
// so M <= WALK_STACK entries cannot overflow it; the C entry refuses a
// larger heap instead of writing past the end.
//
// The H100 redesign (the first port read each popped box as six scalar
// uniform loads from global memory inside the slab chain): the block
// stages all M boxes (24 bytes each, 24,552 for the tool's heap) into
// shared memory once, with one TMA bulk copy (cp.async.bulk on an
// mbarrier) of the 16-byte multiple and, for an odd M, one 8-byte load
// of the last half box, overlapping its ray loads.  A box then is three
// float2 shared loads (a 24-byte box is only 8-byte aligned), and the K
// slab tests of an iteration are independent shared loads that overlap.
// vread reads its N elements straight from global memory (the same
// addresses in every thread, which L1 broadcasts): no shared copy and no
// barrier; a block of 256 threads writes its tile with float4 stores.

#include <cuda_runtime.h>

#include "micro.cuh"

constexpr int WALK_STACK = 1024;
constexpr int VREAD_THREADS = MICRO_TILE / 4;   // one float4 store each

// tools/micro_kwide.py:56 slab: the box (lo xyz, hi xyz) at b, three
// float2, is live for the ray: near <= far and far > 0
__device__ __forceinline__ bool slab(const float2* b, float ox, float oy,
                                     float oz, float ivx, float ivy,
                                     float ivz) {
  const float2 b0 = b[0], b1 = b[1], b2 = b[2];
  float t1x = (b0.x - ox) * ivx;
  float t2x = (b1.y - ox) * ivx;
  float t1y = (b0.y - oy) * ivy;
  float t2y = (b2.x - oy) * ivy;
  float t1z = (b1.x - oz) * ivz;
  float t2z = (b2.y - oz) * ivz;
  float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return (near <= far) && (far > 0.0f);
}

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d == 0.0f ? 1e-20f : d);
}

template <int K>
__global__ void __launch_bounds__(MICRO_TILE, 2)
    walk_kernel(const float* __restrict__ rays, int T,
                const float* __restrict__ nf, int M,
                float* __restrict__ out) {
  __shared__ int stack[WALK_STACK];
  __shared__ int votes[2][K];   // iteration stamp where some ray hit pop k
  __shared__ __align__(16) float2 boxes[3 * WALK_STACK];
  __shared__ uint64_t bar;
  const uint32_t bytes = 24u * M, bulk = bytes & ~15u;
  if (threadIdx.x < 2 * K) votes[threadIdx.x / K][threadIdx.x % K] = -1;
  if (threadIdx.x == 0) {
    stage_init(&bar);
    stack[0] = 0;
    if (bytes != bulk)   // odd M: the last 8 bytes
      boxes[bulk / 8] = *reinterpret_cast<const float2*>(nf + bulk / 4);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    stage_expect(&bar, bulk);
    stage_copy(boxes, nf, bulk, &bar);
  }
  float ox = tile_ray(rays, T, 0), oy = tile_ray(rays, T, 1),
        oz = tile_ray(rays, T, 2);
  float ivx = inv_dir(tile_ray(rays, T, 3)),
        ivy = inv_dir(tile_ray(rays, T, 4)),
        ivz = inv_dir(tile_ray(rays, T, 5));
  stage_wait(&bar);
  const bool leader = (threadIdx.x & 31) == 0;
  int sp = 1, popped = 0;
#pragma unroll 1
  for (int it = 0; sp > 0; ++it) {
    const int buf = it & 1;
    const int kk = min(sp, K);   // the same in every thread
    int node[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kk) {
        node[k] = stack[sp - 1 - k];
        bool hit = slab(boxes + 3 * node[k], ox, oy, oz, ivx, ivy, ivz);
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
__global__ void __launch_bounds__(VREAD_THREADS)
    vread_kernel(const float* __restrict__ rays, float* __restrict__ out) {
  // component 0 (ox) of tile blockIdx.x
  const float* ox = rays + (size_t)blockIdx.x * MICRO_TILE;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < NREAD; ++i)
    acc = acc + __ldg(ox + (i % 8) * MICRO_LANES + (i * 13) % MICRO_LANES);
  reinterpret_cast<float4*>(out + (size_t)blockIdx.x * MICRO_TILE)
      [threadIdx.x] = make_float4(acc, acc, acc, acc);
}

// --- C entries ------------------------------------------------------------
// Each launches T blocks (1024 threads for the walk, 256 for vread) on
// `stream` and returns the launch's cudaError: cudaErrorInvalidValue for
// a K or NREAD without a build, a heap larger than the stack, or a table
// or output that is not 16-byte aligned (the bulk copy, the float4
// stores).

extern "C" int glome_micro_walk(const float* rays, int T, const float* nf,
                                int M, int K, float* out, void* stream) {
  if (M <= 0 || M > WALK_STACK || !host_aligned16(nf))
    return (int)cudaErrorInvalidValue;
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
  if (!host_aligned16(out)) return (int)cudaErrorInvalidValue;
  if (T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nread) {
    case 16: vread_kernel<16><<<T, VREAD_THREADS, 0, s>>>(rays, out); break;
    case 64: vread_kernel<64><<<T, VREAD_THREADS, 0, s>>>(rays, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
