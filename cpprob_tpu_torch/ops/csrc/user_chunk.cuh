// The user-physics chunk kernel (K10 for D = 1, K11 for D > 1): replaces
// _make_scalar_chunk_kernel (cpprob_tpu/ops/pallas_ssm.py:588-630) and
// _make_vector_chunk_kernel (:702-772) behind attach_fused_scalar_kernels /
// attach_fused_vector_kernels.
//
// A generated source (ops/user_chunk.py) defines, in namespace user_model,
// the state dimension kD and the user's physics rendered to C++
// (ops/render.py) as
//   void step(const float (&x)[kD], float y, const float (&eps)[kD],
//             float (&nx)[kD], float& log_emission)
// and includes this header: one library per (physics, D).
//
// It is the linear-Gaussian kernel's loop (csrc/fused_lg.cu
// lg_chunk_kernel, K7) with the physics in place of the random walk: 256
// threads, kUserPerThread particles a thread held in registers for the
// whole chunk (particle base + i * 256 + thread), and per pair of steps and
// plane one philox_normal_pair (one Philox call, one logf, sqrtf and
// sincosf) on counter (particle, t / 2, plane, 0): its cos half at even t,
// its sin half kept for odd t, and a launch that starts at odd t draws the
// pair again.  So the draws do not depend on how a sweep is chunked, and
// with the linear-Gaussian physics the kernel is K7 draw for draw.  The
// states are (n, kD) float32, read and written row by row; n_valid comes
// from the device; steps at and after it leave the particle unchanged.
//
// What bounds it on an H100: per particle-step and plane half a Philox call
// and half a Box-Muller pair, plus the physics, against 8 (kD + 1) B read
// and written per particle and chunk: instruction issue, not HBM.
//
// Numerics: the physics uses the round-to-nearest intrinsics (ops/render.py)
// and the weight update __fadd_rn, so nvcc fuses no multiply-add and the
// plain PyTorch version (ops/user_chunk.py user_chunk_plain) rounds the same
// way but for the transcendentals' last bit.
//
// Particles a thread: 4, so a CTA holds 1,024 particles.  With 16 (K7's),
// 8 or 4 the kernel computes the same states and weights; 4 was the
// fastest at 2^24 x 8 steps (D = 1) and within 3 % of the fastest at
// 2^20 x 4 (D = 2), and with 8 the D = 2 instance spilled
// (util/user_parts.py times the other values).
//
// Records: one per CTA of 256 * kUserPerThread particles, 3 floats: (max
// w, sum e, sum e^2), e = exp(w - max w), the layout of ops/fused_hmm.py
// stats_from_partials.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace {

constexpr int kD = user_model::kD;
constexpr int kUserThreads = 256;
constexpr int kUserPerThread = 4;
constexpr int kUserBlock = kUserThreads * kUserPerThread;

__global__ void __launch_bounds__(kUserThreads)
user_chunk_kernel(const float* __restrict__ ys, int n_steps,
                  const int* __restrict__ ctrl, uint32_t k0, uint32_t k1,
                  uint32_t t0, const float* __restrict__ x_in,
                  const float* __restrict__ w_in, float* __restrict__ x_out,
                  float* __restrict__ w_out, float* __restrict__ rec,
                  long long n) {
  __shared__ float red[kUserThreads / 32 * 2];
  __shared__ float bcast[2];
  const int n_valid = min(*ctrl, n_steps);
  const uint2 key = make_uint2(k0, k1);
  const long long base = (long long)blockIdx.x * kUserBlock;

  float x[kUserPerThread][kD], w[kUserPerThread], sn[kUserPerThread][kD];
#pragma unroll
  for (int i = 0; i < kUserPerThread; ++i) {
    const long long g = base + i * kUserThreads + threadIdx.x;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      x[i][d] = g < n ? x_in[g * kD + d] : 0.f;
      sn[i][d] = 0.f;
    }
    w[i] = g < n ? w_in[g] : -INFINITY;
  }
  for (int t = 0; t < n_valid; ++t) {
    const uint32_t ta = t0 + (uint32_t)t;
    const bool even = (ta & 1u) == 0u;
    const float y = __ldg(ys + t);
#pragma unroll
    for (int i = 0; i < kUserPerThread; ++i) {
      float eps[kD];
      if (even || t == 0) {
        const uint32_t g = (uint32_t)(base + i * kUserThreads + threadIdx.x);
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const float2 pr = philox_normal_pair(g, ta >> 1, (uint32_t)d, key);
          sn[i][d] = pr.y;
          eps[d] = even ? pr.x : pr.y;
        }
      } else {
#pragma unroll
        for (int d = 0; d < kD; ++d) eps[d] = sn[i][d];
      }
      float nx[kD], lw;
      user_model::step(x[i], y, eps, nx, lw);
#pragma unroll
      for (int d = 0; d < kD; ++d) x[i][d] = nx[d];
      w[i] = __fadd_rn(w[i], lw);
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kUserPerThread; ++i) {
    const long long g = base + i * kUserThreads + threadIdx.x;
    if (g < n) {
#pragma unroll
      for (int d = 0; d < kD; ++d) x_out[g * kD + d] = x[i][d];
      w_out[g] = w[i];
      m = fmaxf(m, w[i]);
    }
  }
  m = block_max<kUserThreads>(m, red, bcast);
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kUserPerThread; ++i) {
    const long long g = base + i * kUserThreads + threadIdx.x;
    if (g < n) {
      const float e = expf(w[i] - m);
      v[0] += e;
      v[1] += e * e;
    }
  }
  block_sum<kUserThreads, 2>(v, red, bcast);
  if (threadIdx.x == 0) {
    float* out = rec + (long long)blockIdx.x * 3;
    out[0] = m;
    out[1] = v[0];
    out[2] = v[1];
  }
}

}  // namespace

extern "C" {

int user_chunk_planes() { return kD; }
int user_chunk_block() { return kUserBlock; }

// Returns cudaGetLastError() after the launch (0 = launched).  ctrl: int32
// [n_valid] on the device.
int user_chunk_launch(const float* ys, int n_steps, const int* ctrl,
                      uint32_t k0, uint32_t k1, uint32_t t0, const float* x_in,
                      const float* w_in, float* x_out, float* w_out, float* rec,
                      long long n, void* stream) {
  const int grid = (int)((n + kUserBlock - 1) / kUserBlock);
  user_chunk_kernel<<<grid, kUserThreads, 0, (cudaStream_t)stream>>>(
      ys, n_steps, ctrl, k0, k1, t0, x_in, w_in, x_out, w_out, rec, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
