// The user-physics chunk kernel (K10 for D = 1, K11 for D > 1): replaces
// _make_scalar_chunk_kernel (cpprob_tpu/ops/pallas_ssm.py:588-630) and
// _make_vector_chunk_kernel (:702-772) behind attach_fused_scalar_kernels /
// attach_fused_vector_kernels.
//
// A generated source (ops/user_chunk.py) defines, in namespace user_model,
// the state dimension kD, the observation dimension kDy and the user's
// physics rendered to C++ (ops/render.py) as
//   void step(const float (&x)[kD], const float (&y)[kDy],
//             const float (&eps)[kD], float (&nx)[kD], float& log_emission)
// and includes this header: one library per (physics, D, d_y).
//
// It is the linear-Gaussian kernel's loop (csrc/fused_lg.cu
// lg_chunk_kernel, K7) with the physics in place of the random walk: 256
// threads, kUserPerThread particles a thread held in registers for the
// whole chunk (particle base + i * 256 + thread).  The draws:
// - D = 1 (K10): per pair of steps one philox_normal_pair (one Philox
//   call, one logf, sqrtf and sincosf) on counter (particle, t / 2, 0, 0):
//   its cos half at even t, its sin half kept for odd t, and a launch that
//   starts at odd t draws the pair again; with the linear-Gaussian physics
//   the kernel is K7 draw for draw.
// - D > 1 (K11): per step and group of four planes one Philox call on
//   counter (particle, t, group, 0), its words 0-1 the Box-Muller pair of
//   planes 4 group and 4 group + 1, its words 2-3 that of the next two (a
//   plane past D is not drawn): ceil(D / 4) calls and ceil(D / 2) pairs a
//   particle-step, every half used, whether the launch runs one step or
//   many.
// So the draws do not depend on how a sweep is chunked.  The states are
// (n, kD) float32 rows, the CTA's rows read and written in one coalesced
// pass through shared memory (kStageRows), and the observations (n_steps,
// kDy); n_valid comes from the device; steps at and after it leave the
// particle unchanged.  The key is read from two device words (philox.cuh
// load_key), so a captured CUDA graph of a launch draws from the key
// written before each replay.
//
// The one-step launch with the step's resample control
// (user_chunk_kernel<true>, as K6 is lg_chunk_kernel<true>): one step from
// absolute time t0; where the int32 flag is set every particle starts from
// weight 0 (the old weights are not read), and the last CTA combines the
// records into the ESS and the next step's flag (csrc/step_ctrl.cuh).
// user_chunk_kernel<false> is the chunk launch.
//
// What bounds it on an H100: per particle-step and plane half a Philox call
// (a quarter above D = 1) and half a Box-Muller pair, plus the physics (at
// D = 10 a dense 10 x 10 product, 200 operations), against 8 (kD + 1) B
// read and written per particle and launch: instruction issue, not HBM.
//
// Numerics: the physics uses the round-to-nearest intrinsics (ops/render.py)
// and the weight update __fadd_rn, so nvcc fuses no multiply-add and the
// plain PyTorch version (ops/user_chunk.py user_chunk_plain) rounds the same
// way but for the transcendentals' last bit.
//
// Particles a thread: 4 up to D = 2, so a CTA holds 1,024 particles.  With
// 16 (K7's), 8 or 4 the kernel computes the same states and weights; 4 was
// the fastest at 2^24 x 8 steps (D = 1) and within 3 % of the fastest at
// 2^20 x 4 (D = 2) (util/user_parts.py times the other values).  Above D =
// 2, 2 a thread: the rows are 2 D floats a thread, and a CTA of 512
// particles keeps the one-step launch's records (and its last CTA's
// combine) at n / 512.
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
#include "step_ctrl.cuh"

namespace {

constexpr int kD = user_model::kD;
constexpr int kDy = user_model::kDy;
constexpr int kUserThreads = 256;
constexpr int kUserPerThread = kD <= 2 ? 4 : 2;
constexpr int kUserBlock = kUserThreads * kUserPerThread;
// Rows of kD > 1 floats go through shared memory, kRowPad floats a row (an
// odd stride: a warp's rows fall in distinct banks), where the CTA's rows
// fit in 32 KB: read and written coalesced, not a float at a time at a
// stride of kD.
constexpr int kRowPad = kD | 1;
constexpr bool kStageRows = kD > 1 && kUserBlock * kRowPad * 4 <= 32768;

// ctrl: int32 [n_valid] (the chunk launch); kStepCtrl: one step, ctrl not
// read, sc the step's resample control.
template <bool kStepCtrl>
__global__ void __launch_bounds__(kUserThreads)
user_chunk_kernel(const float* __restrict__ ys, int n_steps,
                  const int* __restrict__ ctrl,
                  const uint32_t* __restrict__ key_dev, uint32_t t0,
                  const float* __restrict__ x_in,
                  const float* __restrict__ w_in, float* __restrict__ x_out,
                  float* __restrict__ w_out, float* __restrict__ rec,
                  long long n, StepCtrl sc) {
  __shared__ float red[kUserThreads / 32 * 2];
  __shared__ float bcast[2];
  __shared__ float rows[kStageRows ? kUserBlock * kRowPad : 1];
  const int n_valid = kStepCtrl ? 1 : min(*ctrl, n_steps);
  const uint2 key = load_key(key_dev);
  const long long base = (long long)blockIdx.x * kUserBlock;
  const int floats = (int)min((long long)kUserBlock, n - base) * kD;
  bool reset = false;
  if constexpr (kStepCtrl) reset = *sc.flag != 0;
  if constexpr (kStageRows) {
    for (int l = threadIdx.x; l < floats; l += kUserThreads)
      rows[l / kD * kRowPad + l % kD] = x_in[base * kD + l];
    __syncthreads();
  }

  float x[kUserPerThread][kD], w[kUserPerThread], sn[kUserPerThread];
#pragma unroll
  for (int i = 0; i < kUserPerThread; ++i) {
    const int r = i * kUserThreads + threadIdx.x;
    const long long g = base + r;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      x[i][d] = g >= n ? 0.f : kStageRows ? rows[r * kRowPad + d] : x_in[g * kD + d];
    w[i] = g < n ? (reset ? 0.f : w_in[g]) : -INFINITY;
    sn[i] = 0.f;
  }
  for (int t = 0; t < n_valid; ++t) {
    const uint32_t ta = t0 + (uint32_t)t;
    const bool even = (ta & 1u) == 0u;
    float y[kDy];
#pragma unroll
    for (int k = 0; k < kDy; ++k) y[k] = __ldg(ys + t * kDy + k);
#pragma unroll
    for (int i = 0; i < kUserPerThread; ++i) {
      const uint32_t g = (uint32_t)(base + i * kUserThreads + threadIdx.x);
      float eps[kD];
      if constexpr (kD == 1) {
        if (even || t == 0) {
          const float2 pr = philox_normal_pair(g, ta >> 1, 0u, key);
          sn[i] = pr.y;
          eps[0] = even ? pr.x : pr.y;
        } else {
          eps[0] = sn[i];
        }
      } else {
#pragma unroll
        for (int q = 0; q < (kD + 3) / 4; ++q) {
          const uint4 b = philox4x32_10(make_uint4(g, ta, (uint32_t)q, 0u), key);
          const float2 p0 = box_muller(b.x, b.y);
          eps[4 * q] = p0.x;
          if (4 * q + 1 < kD) eps[4 * q + 1] = p0.y;
          if (4 * q + 2 < kD) {
            const float2 p1 = box_muller(b.z, b.w);
            eps[4 * q + 2] = p1.x;
            if (4 * q + 3 < kD) eps[4 * q + 3] = p1.y;
          }
        }
      }
      float nx[kD], lw;
      user_model::step(x[i], y, eps, nx, lw);
#pragma unroll
      for (int d = 0; d < kD; ++d) x[i][d] = nx[d];
      w[i] = __fadd_rn(w[i], lw);
    }
  }

  // each thread rewrites only the rows it read: no barrier before
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kUserPerThread; ++i) {
    const int r = i * kUserThreads + threadIdx.x;
    const long long g = base + r;
    if (g < n) {
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if constexpr (kStageRows) rows[r * kRowPad + d] = x[i][d];
        else x_out[g * kD + d] = x[i][d];
      }
      w_out[g] = w[i];
      m = fmaxf(m, w[i]);
    }
  }
  if constexpr (kStageRows) {
    __syncthreads();
    for (int l = threadIdx.x; l < floats; l += kUserThreads)
      x_out[base * kD + l] = rows[l / kD * kRowPad + l % kD];
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
  if constexpr (kStepCtrl) {
    __shared__ double redd[kUserThreads / 32 * 2];
    __shared__ double bcastd[2];
    __shared__ int last_s;
    last_cta_combine<kUserThreads>(rec, sc, red, bcast, redd, bcastd, &last_s);
  }
}

}  // namespace

extern "C" {

int user_chunk_planes() { return kD; }
int user_chunk_obs_planes() { return kDy; }
int user_chunk_block() { return kUserBlock; }

// Returns cudaGetLastError() after the launch (0 = launched).  key: the
// Philox key's two words on the device (philox.cuh load_key).  flag null:
// the chunk launch, ctrl int32 [n_valid] on the device (ticket, ess, next
// and thresh unused); else the one-step launch with the step's resample
// control (StepCtrl; n_steps 1, ctrl unused), ticket the caller's
// per-stream scratch.
int user_chunk_launch(const float* ys, int n_steps, const int* ctrl,
                      const uint32_t* key, uint32_t t0, const float* x_in,
                      const float* w_in, float* x_out, float* w_out, float* rec,
                      long long n, void* stream, const int* flag, int* ticket,
                      double* ess, int* next, double thresh) {
  const int grid = (int)((n + kUserBlock - 1) / kUserBlock);
  const StepCtrl sc = {flag, ticket, ess, next, thresh};
  if (flag)
    user_chunk_kernel<true><<<grid, kUserThreads, 0, (cudaStream_t)stream>>>(
        ys, n_steps, ctrl, key, t0, x_in, w_in, x_out, w_out, rec, n, sc);
  else
    user_chunk_kernel<false><<<grid, kUserThreads, 0, (cudaStream_t)stream>>>(
        ys, n_steps, ctrl, key, t0, x_in, w_in, x_out, w_out, rec, n, sc);
  return (int)cudaGetLastError();
}

}  // extern "C"
