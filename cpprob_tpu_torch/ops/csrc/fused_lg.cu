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
//
// The one-step launch with the step's resample control (lg_chunk_kernel<true>,
// a StepCtrl whose flag is set): where the int32 flag is set every particle
// starts from weight 0 (0 + the increment, the arithmetic of a reset by
// the caller, bit for bit; the old weights are not read), and after the
// records the last CTA to finish (an atomic ticket, as lse_stats_kernel's
// in stream_resample.cu) combines every record in float64 as
// stats_from_partials does, by CTA index, into the ESS and the next step's
// flag, ess < thresh (csrc/step_ctrl.cuh, which the user-physics one-step
// launch shares).  The per-step loop then waits on no pass over the
// population for its decision.  With a null flag the launch is
// lg_chunk_kernel<false>, the kernel as it was.
//
// lg_init_kernel is the sweep's start, x_0 ~ N(0, 1) weighted by N(y_0;
// x_0, 1); it replaces no TPU kernel (the JAX package starts the
// population with plain XLA operations).  Each particle takes the draw of
// absolute step 0, the cos half of Philox pair (particle, 0, 0), whose sin
// half step 1 takes, and computes 0 + eps and 0 + the increment in the
// order of the chunk kernel, so the launch equals a one-step chunk launch
// at t0 = 0 on zero states and weights.  Its records and their combine by
// the last CTA are the step control's: the launch leaves the population,
// its ESS and the first step's flag on the device.  Bound on an H100: one
// Philox call and one log, sqrt and sincos a particle, and 8 B written.
//
// Both kernels read the key from two device words (philox.cuh LaunchKey),
// what a replayed CUDA graph of a sweep reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"
#include "step_ctrl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kBlock = kThreads * kPerThread;  // particles per CTA
constexpr float kHalfLog2Pi = 0.91893853320467274f;

// The CTA's record (max w, sum e, sum e^2), e = exp(w - max w), over its
// particles below n; m is the thread's own max.  Every thread calls it.
__device__ __forceinline__ void cta_record(const float (&w)[kPerThread],
                                           float m, long long base,
                                           long long n, float* rec,
                                           float* red, float* bcast) {
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

// ctrl: int32 [n_valid], or null for all n_steps valid.  Steps at and after
// n_valid leave the particle unchanged.  sc: read only by kStepCtrl.
template <bool kStepCtrl>
__global__ void __launch_bounds__(kThreads)
lg_chunk_kernel(const float* __restrict__ ys, int n_steps,
                const int* __restrict__ ctrl, const uint32_t* __restrict__ key_dev,
                uint32_t t0, const float* __restrict__ x_in,
                const float* __restrict__ w_in, float* __restrict__ x_out,
                float* __restrict__ w_out, float* __restrict__ rec,
                long long n, StepCtrl sc) {
  __shared__ float red[kThreads / 32 * 2];
  __shared__ float bcast[2];
  const int n_valid = ctrl ? min(*ctrl, n_steps) : n_steps;
  const uint2 key = load_key(key_dev);
  const long long base = (long long)blockIdx.x * kBlock;
  bool reset = false;
  if constexpr (kStepCtrl) reset = *sc.flag != 0;

  float x[kPerThread], w[kPerThread], sn[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    x[i] = g < n ? x_in[g] : 0.f;
    w[i] = g < n ? (reset ? 0.f : w_in[g]) : -INFINITY;
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
        const float2 pr = philox_normal_pair(g, ta >> 1, 0u, key);
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
  cta_record(w, m, base, n, rec, red, bcast);
  if constexpr (kStepCtrl) {
    __shared__ double redd[kThreads / 32 * 2];
    __shared__ double bcastd[2];
    __shared__ int last_s;
    last_cta_combine<kThreads>(rec, sc, red, bcast, redd, bcastd, &last_s);
  }
}

// The sweep's start (the head of this file); sc.flag is not read.
__global__ void __launch_bounds__(kThreads)
lg_init_kernel(const float* __restrict__ y0,
               const uint32_t* __restrict__ key_dev, float* __restrict__ x_out,
               float* __restrict__ w_out, float* __restrict__ rec, long long n,
               StepCtrl sc) {
  __shared__ float red[kThreads / 32 * 2];
  __shared__ float bcast[2];
  __shared__ double redd[kThreads / 32 * 2];
  __shared__ double bcastd[2];
  __shared__ int last_s;
  const uint2 key = load_key(key_dev);
  const long long base = (long long)blockIdx.x * kBlock;
  const float y = __ldg(y0);

  float w[kPerThread];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    w[i] = -INFINITY;
    if (g < n) {
      const float x =
          __fadd_rn(0.f, philox_normal_pair((uint32_t)g, 0u, 0u, key).x);
      const float d = __fsub_rn(y, x);
      w[i] = __fadd_rn(
          0.f, __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, d), d), kHalfLog2Pi));
      x_out[g] = x;
      w_out[g] = w[i];
      m = fmaxf(m, w[i]);
    }
  }
  cta_record(w, m, base, n, rec, red, bcast);
  last_cta_combine<kThreads>(rec, sc, red, bcast, redd, bcastd, &last_s);
}

}  // namespace

extern "C" {

int lg_block() { return kBlock; }

// Returns cudaGetLastError() after the launch (0 = launched).  key: the
// Philox key's two words on the device (philox.cuh LaunchKey).  flag null:
// no step control (ticket, ess, next and thresh unused); else the step's
// resample control (StepCtrl), ticket the caller's per-stream scratch.
int lg_chunk_launch(const float* ys, int n_steps, const int* ctrl,
                    const uint32_t* key, uint32_t t0, const float* x_in,
                    const float* w_in, float* x_out, float* w_out, float* rec,
                    long long n, void* stream, const int* flag, int* ticket,
                    double* ess, int* next, double thresh) {
  const int grid = (int)((n + kBlock - 1) / kBlock);
  const StepCtrl sc = {flag, ticket, ess, next, thresh};
  if (flag)
    lg_chunk_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        ys, n_steps, ctrl, key, t0, x_in, w_in, x_out, w_out, rec, n, sc);
  else
    lg_chunk_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        ys, n_steps, ctrl, key, t0, x_in, w_in, x_out, w_out, rec, n, sc);
  return (int)cudaGetLastError();
}

// The sweep's start: x_out, w_out, the records, the ESS and the first
// flag (ess < thresh), ticket the caller's per-stream scratch; key as
// lg_chunk_launch's.
int lg_init_launch(const float* y0, const uint32_t* key, float* x_out,
                   float* w_out, float* rec, long long n, void* stream,
                   int* ticket, double* ess, int* next, double thresh) {
  const int grid = (int)((n + kBlock - 1) / kBlock);
  const StepCtrl sc = {nullptr, ticket, ess, next, thresh};
  lg_init_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      y0, key, x_out, w_out, rec, n, sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
