// Block-wide reductions shared by the port's kernels.  kThreads is the
// block size (a multiple of 32); every thread of the block must call them,
// and every thread gets the result.
#pragma once

#include <math.h>

// Sums NV values across the block, in place.  red: kThreads/32 * NV
// elements of shared memory; bcast: NV elements.
template <int kThreads, int NV, typename T>
__device__ __forceinline__ void block_sum(T (&v)[NV], T* red, T* bcast) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp * NV + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    T x = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += red[w * NV + threadIdx.x];
    bcast[threadIdx.x] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = bcast[i];
  __syncthreads();
}

// Max across the block.  red: kThreads/32 floats of shared memory; bcast:
// one float.
template <int kThreads>
__device__ __forceinline__ float block_max(float x, float* red, float* bcast) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    bcast[0] = m;
  }
  __syncthreads();
  const float m = bcast[0];
  __syncthreads();
  return m;
}
