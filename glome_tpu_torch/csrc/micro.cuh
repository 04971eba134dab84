// Shared by the microbenchmark kernels (csrc/micro_prims.cu,
// csrc/micro_kwide.cu): the ray-tile layout of glome's microbenchmarks,
// the bulk copy that stages a table into shared memory, and the C error
// name the ctypes wrappers read.
//
// Rays are a (8, T, 8, 128) float32 table [ox oy oz dx dy dz seed pad]:
// T tiles of 1024 rays, ray (sub, lane) of a tile at sub * 128 + lane.
// A variant that makes ONE decision for a whole tile (the TPU's any()
// over its (8, 128) vector) runs a tile as one block of 1024 threads,
// thread = sub * 128 + lane, and votes with __syncthreads_or or warp
// ballots combined in shared memory; a variant with no tile-wide decision
// splits a tile over several smaller blocks (ray_at / store_at).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MICRO_TILE = 1024;   // rays per tile
constexpr int MICRO_LANES = 128;   // lanes of a sub-row

// component c of ray `ray` of tile `tile`
__device__ __forceinline__ float ray_at(const float* __restrict__ rays,
                                        int T, int c, int tile, int ray) {
  return rays[((size_t)c * T + tile) * MICRO_TILE + ray];
}

__device__ __forceinline__ void store_at(float* __restrict__ out, int tile,
                                         int ray, float v) {
  out[(size_t)tile * MICRO_TILE + ray] = v;
}

// a tile-wide block (1024 threads, one tile): this thread's ray
__device__ __forceinline__ float tile_ray(const float* __restrict__ rays,
                                          int T, int c) {
  return ray_at(rays, T, c, blockIdx.x, threadIdx.x);
}

__device__ __forceinline__ void tile_store(float* __restrict__ out,
                                           float v) {
  store_at(out, blockIdx.x, threadIdx.x, v);
}

// --- staging a table: one TMA bulk copy (cp.async.bulk) per block ----------
// One thread initialises an mbarrier (stage_init), a __syncthreads makes
// it visible, the same thread announces the bytes and issues the copies
// (stage_expect, stage_copy), and every thread waits for them
// (stage_wait) after its own ray loads, which the copy overlaps.  A bulk
// copy moves a multiple of 16 bytes between 16-byte-aligned addresses;
// the C entries refuse a table that is not 16-byte aligned.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void stage_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void stage_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wait for phase 0 of the barrier (the block's one staging)
__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  }
}

static inline bool host_aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

extern "C" const char* glome_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
