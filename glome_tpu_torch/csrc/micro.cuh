// Shared by the microbenchmark kernels (csrc/micro_prims.cu,
// csrc/micro_kwide.cu): the ray-tile layout of glome's microbenchmarks and
// the C error name the ctypes wrappers read.
//
// Rays are a (8, T, 8, 128) float32 table [ox oy oz dx dy dz seed pad]:
// T tiles of 1024 rays, ray (sub, lane) of a tile at sub * 128 + lane.
// Several variants make ONE decision for a whole tile (the TPU's any()
// over its (8, 128) vector), so a tile is one block of 1024 threads,
// thread = sub * 128 + lane, and a tile-wide vote is __syncthreads_or or
// warp ballots combined in shared memory.

#pragma once

#include <cuda_runtime.h>

constexpr int MICRO_TILE = 1024;   // rays per tile = threads per block
constexpr int MICRO_LANES = 128;   // lanes of a sub-row

// component c of this thread's ray in this block's tile
__device__ __forceinline__ float tile_ray(const float* __restrict__ rays,
                                          int T, int c) {
  return rays[((size_t)c * T + blockIdx.x) * MICRO_TILE + threadIdx.x];
}

__device__ __forceinline__ void tile_store(float* __restrict__ out,
                                           float v) {
  out[(size_t)blockIdx.x * MICRO_TILE + threadIdx.x] = v;
}

extern "C" const char* glome_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
