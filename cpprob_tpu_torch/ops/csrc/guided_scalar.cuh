// K12, the guided scalar chunk kernel with the proposal net on the FMA pipe.
// Replaces _make_guided_scalar_chunk_kernel (cpprob_tpu/ops/pallas_ssm.py:
// 887-945), the reference's elementwise twin
// (attach_fused_guided_scalar_kernels(..., mxu=False), pallas_ssm.py:1093;
// a linear [3, 2] head takes it whatever mxu says, :1135).
//
// The body of the kernel is fixed; cpprob_tpu_torch/ops/guided_scalar.py
// generates one source per proposal net and pair of densities that
// defines, before it includes this header, in namespace guided_scalar_model:
//   constexpr int kPerThread;   // particles a thread
//   constexpr int kFirst;       // units of the first layer
//   void first_consts(float y, float tf, float (&c)[kFirst]);
//       // c_j = w_y y + w_t tf + b_j, once a step
//   void net(float x, const float (&c)[kFirst], float& mean, float& raw);
//   float trans_logpdf_elem(float x, float nx, float t);
//   float obs_logpdf_elem(float nx, float y, float t);
// The net's weights are float32 literals in the generated code, as the
// reference's _make_mlp_elem bakes them (pallas_ssm.py:839): every
// multiply-add takes its weight as an immediate operand, with no load and
// no register.  The first layer is one __fmaf_rn(x, w_x, c_j) a unit, ReLU
// an fmaxf, each later unit a chain of __fmaf_rn from its bias, and the
// last hidden layer streams into (mean, raw), so one hidden layer is live.
//
// Per particle-step: the Box-Muller eps of absolute step t (Philox counter
// (particle, t / 2, 0): its cos half at even t, its sin half at odd t, as
// K7, K10 and the tensor-core twin draw it), the net's (mean, raw), the
// move nx = mean + std eps with std = softplus(raw) + 1e-6, and the weight
// log_w += trans(x, nx, t) + obs(nx, y, t) - log q(nx).  Records: one (max,
// sum e, sum e^2) per CTA.
//
// Layout: kThreads threads, kPerThread particles a thread held in registers
// for the whole chunk (particle base + i * kThreads + thread); the net of
// the thread's particles is unrolled side by side, so a layer of H units
// gives H x kPerThread independent chains of multiply-adds, and c_j is
// formed once a thread-step.  At [3,16,16,2] four particles a thread (112
// registers) ran 3-4 % faster than two and 10-12 % faster than one; the
// weights as a by-value kernel-parameter struct (constant-bank operands,
// one build per net shape) ran 1.2 times as long at two a thread and spilled
// at four (util/guided_tc_parts.py on an H100 80GB HBM3 at 700 W), so the
// generator bakes them in and holds four particles a thread up to hidden
// layers of 16 units, fewer above (ops/guided_scalar.py per_thread).
//
// Precision.  The net rounds each multiply-add once (the plain version,
// ops/guided_scalar.py _net_plain, emulates that in float64); the rest
// rounds as the plain version does (round-to-nearest intrinsics, precise
// expf / logf / log1pf).  One (mean, std) both samples and scores each move,
// so the weight stays the exact Radon-Nikodym weight.
//
// What bounds it on an H100: per particle-step about 2 sum(H_l H_{l+1})
// float operations of the net (one FFMA issues two), half a Philox call and
// half a Box-Muller pair, an exp + log1p pair and a log, against 16 B per
// particle per launch: float32 issue (util/roofline.py guided_net_ops).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace guided_scalar {

using namespace guided_scalar_model;

constexpr int kThreads = 256;
constexpr int kBlock = kThreads * kPerThread;  // particles per CTA
constexpr float kHalfLog2Pi = 0.91893853320467274f;

// nv: int32 [n_valid] (steps at and after it leave the particle as it is);
// T: the model's horizon (the net's time feature is t / T).
__global__ void __launch_bounds__(kThreads)
guided_scalar_kernel(const float* __restrict__ ys, int n_steps,
                     const int* __restrict__ nv, uint32_t k0, uint32_t k1,
                     uint32_t t0, float T, const float* __restrict__ x_in,
                     const float* __restrict__ w_in, float* __restrict__ x_out,
                     float* __restrict__ w_out, float* __restrict__ rec,
                     long long n) {
  __shared__ float red[kThreads / 32 * 2];
  __shared__ float bcast[2];
  const long long base = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int n_valid = min(*nv, n_steps);
  const uint2 key = make_uint2(k0, k1);

  float x[kPerThread], w[kPerThread], sn[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const long long i = base + (long long)p * kThreads;
    x[p] = i < n ? x_in[i] : 0.f;
    w[p] = i < n ? w_in[i] : -INFINITY;
    sn[p] = 0.f;
  }

  for (int s = 0; s < n_valid; ++s) {
    const uint32_t ta = t0 + (uint32_t)s;
    const bool even = (ta & 1u) == 0u;
    const float y = __ldg(ys + s);
    const float tt = (float)ta;
    float c[kFirst];
    first_consts(y, __fdiv_rn(tt, T), c);
    float mean[kPerThread], raw[kPerThread];
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) net(x[p], c, mean[p], raw[p]);

#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      float eps;
      if (even || s == 0) {
        const float2 pr = philox_normal_pair(
            (uint32_t)(base + (long long)p * kThreads), ta >> 1, 0u, key);
        sn[p] = pr.y;
        eps = even ? pr.x : pr.y;
      } else {
        eps = sn[p];
      }
      const float sd = __fadd_rn(
          __fadd_rn(fmaxf(raw[p], 0.f), log1pf(expf(-fabsf(raw[p])))), 1e-6f);
      const float nx = __fadd_rn(mean[p], __fmul_rn(sd, eps));
      const float log_q = __fsub_rn(
          __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, eps), eps), logf(sd)), kHalfLog2Pi);
      const float dlw = __fsub_rn(
          __fadd_rn(trans_logpdf_elem(x[p], nx, tt), obs_logpdf_elem(nx, y, tt)),
          log_q);
      x[p] = nx;
      w[p] = __fadd_rn(w[p], dlw);
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const long long i = base + (long long)p * kThreads;
    if (i < n) {
      x_out[i] = x[p];
      w_out[i] = w[p];
      m = fmaxf(m, w[p]);
    }
  }
  m = block_max<kThreads>(m, red, bcast);
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    if (base + (long long)p * kThreads < n) {
      const float e = expf(w[p] - m);
      v[0] += e;
      v[1] += e * e;
    }
  }
  block_sum<kThreads, 2>(v, red, bcast);
  if (threadIdx.x == 0) {
    float* r = rec + (long long)blockIdx.x * 3;
    r[0] = m;
    r[1] = v[0];
    r[2] = v[1];
  }
}

}  // namespace guided_scalar

extern "C" {

int guided_scalar_block() { return guided_scalar::kBlock; }

// Returns cudaGetLastError() after the launch (0 = launched).
int guided_scalar_launch(const float* ys, int n_steps, const int* nv,
                         uint32_t k0, uint32_t k1, uint32_t t0, float T,
                         const float* x_in, const float* w_in, float* x_out,
                         float* w_out, float* rec, long long n, void* stream) {
  const int grid =
      (int)((n + guided_scalar::kBlock - 1) / guided_scalar::kBlock);
  guided_scalar::guided_scalar_kernel<<<grid, guided_scalar::kThreads, 0,
                                        (cudaStream_t)stream>>>(
      ys, n_steps, nv, k0, k1, t0, T, x_in, w_in, x_out, w_out, rec, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
