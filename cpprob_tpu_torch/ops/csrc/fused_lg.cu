// Fused SMC chunk kernel for the linear-Gaussian model
// (x_t = x_{t-1} + N(0, 1), y_t ~ N(x_t, 1)).
//
// lg_chunk_kernel replaces _make_lg_chunk_kernel / pallas_lg_fused_chunk
// (cpprob_tpu/ops/pallas_hmm.py:808-918) and, launched with n_steps = 1,
// _lg_step_kernel / pallas_lg_fused_step (pallas_hmm.py:669-724).
//
// What bounds it on an H100: the chunk reads and writes 16 B per particle
// (state + weight, in and out) but spends, per pair of steps, one
// Philox4x32-10 call (~60 integer operations) and one log, sqrt and
// sincos (a few dozen float operations), so it is bound by instruction
// issue, not by HBM.  The design keeps each thread's kPerThread particles
// in registers for the whole chunk and feeds two steps from one Box-Muller
// pair: the draw for absolute step t sits on Philox counter
// (particle, t / 2, 0, 0), its cos half at even t and its sin half at odd
// t.  So the draws do not depend on how a sweep is cut into chunks: eight
// one-step launches give exactly what one eight-step launch gives.
//
// Numerics: precise logf / sqrtf / sincosf (no fast-math intrinsics), u1
// clamped to >= 1e-12 as the reference does, and round-to-nearest
// intrinsics for the draw and the update, so the compiler fuses no
// multiply-add: the plain PyTorch version (ops/fused_lg.py) rounds the same
// way, and a one-step launch is bit-equal to a step of a longer launch.
//
// Records: one per CTA, 3 floats: (max w, sum e, sum e^2), e = exp(w - max w)
// — the layout of ops/fused_hmm.py stats_from_partials with no category
// columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kBlock = kThreads * kPerThread;  // particles per CTA
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kTwoPi = 6.28318530717958648f;

// One Box-Muller pair (r cos, r sin) from Philox counter (g, pair, 0, 0).
__device__ __forceinline__ float2 normal_pair(uint32_t g, uint32_t pair,
                                              uint2 key) {
  const uint4 b = philox4x32_10(make_uint4(g, pair, 0u, 0u), key);
  const float u1 = fmaxf(philox_u01(b.x), 1e-12f);
  const float u2 = philox_u01(b.y);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float sn, cs;
  sincosf(__fmul_rn(kTwoPi, u2), &sn, &cs);
  return make_float2(__fmul_rn(r, cs), __fmul_rn(r, sn));
}

// ctrl: int32 [n_valid], or null for all n_steps valid.  Steps at and after
// n_valid leave the particle unchanged.
__global__ void __launch_bounds__(kThreads)
lg_chunk_kernel(const float* __restrict__ ys, int n_steps,
                const int* __restrict__ ctrl, uint32_t k0, uint32_t k1,
                uint32_t t0, const float* __restrict__ x_in,
                const float* __restrict__ w_in, float* __restrict__ x_out,
                float* __restrict__ w_out, float* __restrict__ rec,
                long long n) {
  __shared__ float red[kThreads / 32 * 2];
  __shared__ float bcast[2];
  const int n_valid = ctrl ? min(*ctrl, n_steps) : n_steps;
  const uint2 key = make_uint2(k0, k1);
  const long long base = (long long)blockIdx.x * kBlock;

  float x[kPerThread], w[kPerThread], sn[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    x[i] = g < n ? x_in[g] : 0.f;
    w[i] = g < n ? w_in[g] : -INFINITY;
    sn[i] = 0.f;
  }
  for (int t = 0; t < n_valid; ++t) {
    const uint32_t ta = t0 + (uint32_t)t;
    const bool even = (ta & 1u) == 0u;
    const float y = __ldg(ys + t);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      float eps;
      if (even || t == 0) {
        const uint32_t g = (uint32_t)(base + i * kThreads + threadIdx.x);
        const float2 pr = normal_pair(g, ta >> 1, key);
        sn[i] = pr.y;
        eps = even ? pr.x : pr.y;
      } else {
        eps = sn[i];
      }
      x[i] = __fadd_rn(x[i], eps);
      const float d = __fsub_rn(y, x[i]);
      w[i] = __fadd_rn(
          w[i], __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, d), d), kHalfLog2Pi));
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    if (g < n) {
      x_out[g] = x[i];
      w_out[g] = w[i];
      m = fmaxf(m, w[i]);
    }
  }
  m = block_max<kThreads>(m, red, bcast);
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    if (g < n) {
      const float e = expf(w[i] - m);
      v[0] += e;
      v[1] += e * e;
    }
  }
  block_sum<kThreads, 2>(v, red, bcast);
  if (threadIdx.x == 0) {
    float* out = rec + (long long)blockIdx.x * 3;
    out[0] = m;
    out[1] = v[0];
    out[2] = v[1];
  }
}

}  // namespace

extern "C" {

int lg_block() { return kBlock; }

// Returns cudaGetLastError() after the launch (0 = launched).
int lg_chunk_launch(const float* ys, int n_steps, const int* ctrl, uint32_t k0,
                    uint32_t k1, uint32_t t0, const float* x_in,
                    const float* w_in, float* x_out, float* w_out, float* rec,
                    long long n, void* stream) {
  const int grid = (int)((n + kBlock - 1) / kBlock);
  lg_chunk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ys, n_steps, ctrl, k0, k1, t0, x_in, w_in, x_out, w_out, rec, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
