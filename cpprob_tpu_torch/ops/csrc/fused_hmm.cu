// Fused SMC kernels for a K-state HMM with Gaussian emissions (K = 3 is
// instantiated; the tables take any K <= 8).
//
// hmm_init_kernel replaces the Pallas kernel _make_init_kernel /
// pallas_hmm_fused_init (cpprob_tpu/ops/pallas_hmm.py:727-805).
// hmm_chunk_kernel replaces _make_chunk_kernel_island and _make_chunk_kernel
// behind pallas_hmm_fused_chunk (pallas_hmm.py:245-591); island_every = 0
// turns the interior checks off.
//
// What bounds them on an H100: the chunk kernel reads and writes 16 B per
// particle per chunk (state + weight, in and out) but spends, per
// particle-step, one Philox4x32-10 call (10 rounds of two 32x32 multiplies
// plus xors, ~60 integer operations) and ~10 float operations.  At 15 steps
// per chunk that is ~1000 integer operations per 16 B, far above the card's
// ratio of compute to HBM bandwidth, so the kernel is bound by integer and
// ALU issue, not by memory.  The design keeps everything but the compulsory
// 16 B in registers: each thread holds its P particles across the whole
// chunk, the emission is computed once per step for the K states and picked
// by a select, the transition is K-1 compares against a CDF row in shared
// memory (exact table lookups, no fitted polynomials), and the island check
// is one max and one sum reduction per CTA every island_every steps.
//
// Numerics: the emission, the weight update and the island ticks use
// round-to-nearest intrinsics, so the compiler fuses no multiply-add and the
// plain PyTorch version (ops/fused_hmm.py) rounds the same way.
//
// Table layout (float32): transition CDF K x (K-1) | means K | 0.5/sigma^2 K
// | -log(sigma) - 0.5 log(2 pi) K | initial-state CDF K-1.
//
// Records: one per CTA, K + 4 floats: (max w, sum e, sum e^2, sum e per
// state k < K, interior resamples), e = exp(w - max w).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                     // particles per thread
constexpr int kIsland = kThreads * kPerThread;     // particles per CTA

// -(y - mu_k)^2 * 0.5/sigma_k^2 + log-normaliser_k for every state k.
template <int K>
__device__ __forceinline__ void emission(float y, const float (&mu)[K],
                                         const float (&hiv)[K],
                                         const float (&lc)[K], float (&e)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = __fsub_rn(y, mu[k]);
    e[k] = __fsub_rn(lc[k], __fmul_rn(__fmul_rn(hiv[k], d), d));
  }
}

template <int K>
__device__ __forceinline__ float pick(int s, const float (&e)[K]) {
  float v = e[0];
#pragma unroll
  for (int k = 1; k < K; ++k) v = (s == k) ? e[k] : v;
  return v;
}

template <int K>
__device__ __forceinline__ void load_emission_tables(const float* tab,
                                                     float (&mu)[K],
                                                     float (&hiv)[K],
                                                     float (&lc)[K]) {
  constexpr int kMu = K * (K - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mu[k] = tab[kMu + k];
    hiv[k] = tab[kMu + K + k];
    lc[k] = tab[kMu + 2 * K + k];
  }
}

// One thread per particle in a grid-stride loop: state from the initial
// CDF on Philox counter (index, 0, 0), the t=0 emission weight, and the
// CTA's record from an online (max, sums) accumulation.
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_init_kernel(const float* __restrict__ tab, const float* __restrict__ y0,
                uint32_t k0, uint32_t k1, int* __restrict__ s_out,
                float* __restrict__ w_out, float* __restrict__ rec,
                long long n) {
  static_assert(K >= 2, "K >= 2");
  __shared__ float red[kWarps * (K + 2)];
  __shared__ float bcast[K + 2];
  float mu[K], hiv[K], lc[K], e[K], icdf[K - 1];
  load_emission_tables<K>(tab, mu, hiv, lc);
#pragma unroll
  for (int k = 0; k < K - 1; ++k) icdf[k] = tab[K * (K - 1) + 3 * K + k];
  emission<K>(__ldg(y0), mu, hiv, lc, e);

  float m = -INFINITY, se = 0.f, se2 = 0.f, c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0.f;
  const uint2 key = make_uint2(k0, k1);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < n;
       g += stride) {
    const float u =
        philox_u01(philox4x32_10(make_uint4((uint32_t)g, 0u, 0u, 0u), key).x);
    int s = 0;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) s += (u >= icdf[k]);
    const float w = pick<K>(s, e);
    s_out[g] = s;
    w_out[g] = w;
    if (w > m) {
      const float r = expf(m - w);
      se *= r;
      se2 *= r * r;
#pragma unroll
      for (int k = 0; k < K; ++k) c[k] *= r;
      m = w;
    }
    const float ew = expf(w - m);
    se += ew;
    se2 += ew * ew;
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] += (s == k) ? ew : 0.f;
  }

  const float mb = block_max<kThreads>(m, red, bcast);
  const float sc = (m == -INFINITY) ? 0.f : expf(m - mb);
  float v[K + 2];
  v[0] = se * sc;
  v[1] = se2 * sc * sc;
#pragma unroll
  for (int k = 0; k < K; ++k) v[2 + k] = c[k] * sc;
  block_sum<kThreads, K + 2>(v, red, bcast);
  if (threadIdx.x == 0) {
    float* out = rec + (long long)blockIdx.x * (K + 4);
    out[0] = mb;
#pragma unroll
    for (int i = 0; i < K + 2; ++i) out[1 + i] = v[i];
    out[K + 3] = 0.f;
  }
}

// One CTA = one island of kIsland particles, each thread holding
// kPerThread of them (index base + i*kThreads + tid) in registers for the
// whole chunk.  ctrl = [flag, ticks (K-1), n_valid].
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_chunk_kernel(const float* __restrict__ tab, const float* __restrict__ ys,
                 int n_steps, const int* __restrict__ ctrl, uint32_t k0,
                 uint32_t k1, uint32_t t0, int island_every, float thresh,
                 const int* __restrict__ s_in, const float* __restrict__ w_in,
                 int* __restrict__ s_out, float* __restrict__ w_out,
                 float* __restrict__ rec) {
  static_assert(K >= 2, "K >= 2");
  __shared__ float cdf[K * (K - 1)];
  __shared__ float red[kWarps * (K + 2)];
  __shared__ float bcast[K + 2];
  __shared__ int collapse_s;
  if (threadIdx.x < K * (K - 1)) cdf[threadIdx.x] = tab[threadIdx.x];
  float mu[K], hiv[K], lc[K];
  load_emission_tables<K>(tab, mu, hiv, lc);

  const int flag = ctrl[0];
  int tick[K - 1];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) tick[k] = ctrl[1 + k];
  const int n_valid = ctrl[K];
  const uint2 key = make_uint2(k0, k1);
  const uint32_t base = blockIdx.x * (uint32_t)kIsland;

  // chunk start: the flagged exchange resample rebuilds the sorted
  // population from the slot index against the ticks, weights reset
  int s[kPerThread];
  float w[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const uint32_t g = base + i * kThreads + threadIdx.x;
    if (flag) {
      int v = 0;
#pragma unroll
      for (int k = 0; k < K - 1; ++k) v += ((long long)g >= tick[k]);
      s[i] = v;
      w[i] = 0.f;
    } else {
      s[i] = s_in[g];
      w[i] = w_in[g];
    }
  }
  __syncthreads();  // cdf

  const float nb = (float)kIsland;
  float count = 0.f;
  for (int t = 0; t < n_steps; ++t) {
    const uint32_t ta = t0 + (uint32_t)t;
    if (t < n_valid) {
      float e[K];
      emission<K>(__ldg(ys + t), mu, hiv, lc, e);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const uint32_t g = base + i * kThreads + threadIdx.x;
        const float u =
            philox_u01(philox4x32_10(make_uint4(g, ta, 0u, 0u), key).x);
        const float* row = cdf + s[i] * (K - 1);
        int ns = 0;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) ns += (u >= row[k]);
        s[i] = ns;
        w[i] = __fadd_rn(w[i], pick<K>(ns, e));
      }
    }
    if (island_every > 0 && (t + 1) % island_every == 0 && t < n_steps - 1) {
      // the island's Kish ESS; on collapse a block-local systematic
      // exchange resample at the island's log-mean weight
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) m = fmaxf(m, w[i]);
      m = block_max<kThreads>(m, red, bcast);
      float v[K + 1];
#pragma unroll
      for (int j = 0; j < K + 1; ++j) v[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float ew = expf(w[i] - m);
        v[0] += ew;
        v[1] += ew * ew;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) v[2 + k] += (s[i] == k) ? ew : 0.f;
      }
      block_sum<kThreads, K + 1>(v, red, bcast);
      // one thread decides, every thread follows
      if (threadIdx.x == 0)
        collapse_s = (v[0] * v[0] < thresh * nb * v[1]) && (t + 1 < n_valid);
      __syncthreads();
      if (collapse_s) {
        const float u0 = philox_u01(
            philox4x32_10(make_uint4(blockIdx.x, ta, 1u, 0u), key).x);
        int tk[K - 1];
        float cum = 0.f;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) {
          cum = __fadd_rn(cum, v[2 + k]);
          const float x = __fsub_rn(__fmul_rn(nb, __fdiv_rn(cum, v[0])), u0);
          tk[k] = (int)fminf(fmaxf(ceilf(x), 0.f), nb);
        }
        const float lme_b = __fsub_rn(__fadd_rn(m, logf(v[0])), logf(nb));
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int jl = i * kThreads + threadIdx.x;
          int ns = 0;
#pragma unroll
          for (int k = 0; k < K - 1; ++k) ns += (jl >= tk[k]);
          s[i] = ns;
          w[i] = lme_b;
        }
        count += 1.f;
      }
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const uint32_t g = base + i * kThreads + threadIdx.x;
    s_out[g] = s[i];
    w_out[g] = w[i];
    m = fmaxf(m, w[i]);
  }
  m = block_max<kThreads>(m, red, bcast);
  float v[K + 2];
#pragma unroll
  for (int j = 0; j < K + 2; ++j) v[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const float ew = expf(w[i] - m);
    v[0] += ew;
    v[1] += ew * ew;
#pragma unroll
    for (int k = 0; k < K; ++k) v[2 + k] += (s[i] == k) ? ew : 0.f;
  }
  block_sum<kThreads, K + 2>(v, red, bcast);
  if (threadIdx.x == 0) {
    float* out = rec + (long long)blockIdx.x * (K + 4);
    out[0] = m;
#pragma unroll
    for (int i = 0; i < K + 2; ++i) out[1 + i] = v[i];
    out[K + 3] = count;
  }
}

}  // namespace

extern "C" {

int hmm_island_size() { return kIsland; }

// Returns cudaGetLastError() after the launch (0 = launched).
int hmm_init_launch(int K, const float* tab, const float* y0, uint32_t k0,
                    uint32_t k1, int* s_out, float* w_out, float* rec,
                    long long n, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 3:
      hmm_init_kernel<3><<<grid, kThreads, 0, st>>>(tab, y0, k0, k1, s_out,
                                                    w_out, rec, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int hmm_chunk_launch(int K, const float* tab, const float* ys, int n_steps,
                     const int* ctrl, uint32_t k0, uint32_t k1, uint32_t t0,
                     int island_every, float thresh, const int* s_in,
                     const float* w_in, int* s_out, float* w_out, float* rec,
                     long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % kIsland != 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n / kIsland);
  switch (K) {
    case 3:
      hmm_chunk_kernel<3><<<grid, kThreads, 0, st>>>(
          tab, ys, n_steps, ctrl, k0, k1, t0, island_every, thresh, s_in,
          w_in, s_out, w_out, rec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
