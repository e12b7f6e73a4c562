// Fused SMC kernels for a K-state HMM with Gaussian emissions, 1 <= K <= 32.
//
// hmm_init_kernel / hmm_init_kernel_k replace the Pallas kernels
// _make_init_kernel / pallas_hmm_fused_init (cpprob_tpu/ops/pallas_hmm.py:
// 727-805) and _make_discrete_init_kernel / _discrete_init
// (cpprob_tpu/ops/pallas_ssm.py:331-363,433).
// hmm_chunk_kernel / hmm_chunk_kernel_k replace _make_chunk_kernel_island and
// _make_chunk_kernel behind pallas_hmm_fused_chunk (pallas_hmm.py:245-591)
// and _make_discrete_chunk_kernel behind _discrete_chunk (pallas_ssm.py:
// 165-328,402); island_every = 0 turns the interior checks off.  Launched
// with n_steps = 1 the chunk kernel is also the one-step kernels
// _make_step_exchange_kernel (pallas_hmm.py:103-170, flag and ticks live)
// and _step_kernel (pallas_hmm.py:66-100, flag 0).
//
// Two designs, one arithmetic:
// - K = 2..8 (hmm_*_kernel<K>): the per-category sums and the init
//   kernel's emission tables are K-sized register arrays, fully unrolled,
//   and each thread holds its particles in registers; K is a template
//   parameter, one instance per K.
// - K = 1 and 9..32 (hmm_*_kernel_k, K at run time): K-sized arrays in
//   registers would spill (and need compile-time K), so the transition CDF
//   (rows at an odd stride), the emission tables and each tile's emission
//   rows live in shared memory, and so does the chunk's population (held
//   in registers beside the binary search, it spilled); a particle's next
//   state is a binary search of its CDF row (the rows are non-decreasing,
//   so the search gives the count of entries <= u that the compare-and-add
//   of the small-K design and the plain version give); the K per-category
//   sums are one warp reduction per category over the thread's own
//   particles, written to shared memory and summed across warps; the init
//   kernel counts the states in a shared-memory histogram (integer atomics:
//   exact and order-free).
// Both init kernels form their record from the CTA's state counts, since
// every particle in state k carries the same t = 0 weight (init_record): no
// exp a particle, and one Philox call serves four particles.
//
// The transition draws: the uniform of particle g at absolute step t is word
// t & 3 of Philox4x32-10 at counter (g, t >> 2, 2, 0) under the sweep's key,
// so one call serves four steps (stream 2; the initial state of particle g
// is word g & 3 at (g >> 2, 0, 0, 0), four particles a call, and an
// island's offset (island, t, 1, 0), so no two uses share a counter).  A
// launch whose first step is not a multiple of 4, and a one-step launch,
// makes the call for its own first group, and a group cut by an island
// check makes it again after the check: the draws do not depend on how a
// sweep is chunked, and a chunk equals its steps launched one at a time.
// Each init and chunk kernel reads the key from two device words
// (philox.cuh LaunchKey: what a replayed CUDA graph of a sweep reads), once
// into two registers, or, where those would spill, from shared memory at
// each tile.
//
// What bounds them on an H100: the chunk kernel reads and writes 16 B per
// particle per chunk (state + weight, in and out) and spends, per
// particle-step, a quarter of a Philox4x32-10 call (10 rounds of two 32x32
// multiplies plus xors, ~60 integer operations a call), a CDF lookup (K-1
// compares, or a binary search of at most 5 shared loads), an emission
// lookup and an add.  At 8 to 15 steps per chunk that is still a few hundred
// integer operations per 16 B, above the card's ratio of compute to HBM
// bandwidth, so the kernel is bound by integer and ALU issue.  The loop runs
// tiles of steps: a tile ends at an island check, at the last step, or after
// at most kTile steps on a group boundary.  Each tile's K-entry emission rows
// are computed into shared memory first (one barrier a tile,
// double-buffered), then each thread runs its kPerThread particles one after
// the other through the whole tile, so only one particle's four words are
// live at a time (the words of 16 particles held across steps would cost 48
// registers).  The island check is one max and one sum reduction per CTA.
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

constexpr int kIsland = 4096;                      // particles per CTA
constexpr int kPerThread = 16;                     // particles per thread
constexpr int kThreads = kIsland / kPerThread;
constexpr int kWarps = kThreads / 32;

// The streams of the draws (the third counter word): the initial states
// (four particles a call), the islands' offsets and the transitions.
constexpr uint32_t kInitStream = 0u;
constexpr uint32_t kTransitionStream = 2u;
// The most steps a tile of the chunk kernels runs (a multiple of 4): the
// emission rows of a tile live in shared memory.  Tiles of 16 and 32 steps
// time the same; 4 and 8, more barriers, are slower (util/chain_parts.py
// times the other values of these constants).
constexpr int kTile = 32;
static_assert(kTile >= 4 && kTile % 4 == 0, "a tile is whole groups of 4");
// How many of a thread's particles the compiler interleaves in a tile of
// the run-time-K chunk kernel (its population lives in shared memory, so
// the loop need not be unrolled to keep it in registers).
constexpr int kUnroll = 2;
// The CTAs an SM is asked to hold of a chunk kernel (__launch_bounds__'s
// second argument, so at most 65536 / (kThreads * that) registers a
// thread): 1,024 threads (64 registers) where the kernel fits them without
// spilling (K <= 3 and the run-time-K kernel), 768 (80 registers) elsewhere.
// Asked for nothing, ptxas chose 64 registers and spilled at K = 6; asked
// for one CTA, it took up to 153 and ran slower.
static_assert(kThreads <= 768, "a CTA of at most 768 threads");
constexpr int min_blocks(bool fits_64) {
  return (fits_64 ? 1024 : 768) / kThreads;
}

// The end of the tile that starts at step t (relative to the launch's first
// step, absolute t0): the next island check, n_run (the last step to run),
// or the last group boundary of absolute time at most Tile steps on,
// whichever comes first.
template <int Tile>
__device__ __forceinline__ int tile_end(int t, uint32_t t0, int n_run,
                                        int island_every) {
  int end = n_run;
  if (island_every > 0) end = min(end, (t / island_every + 1) * island_every);
  const long long cap = (((long long)t0 + t + Tile) & ~3LL) - (long long)t0;
  return cap < end ? (int)cap : end;
}

// Steps 0 .. len-1 of a tile whose first step is absolute step ta, for
// particle g: one Philox call per group of four absolute steps (the tile's
// first group may start past its word 0, its last end before word 3), and
// step(j, u) for step j of the tile with its uniform u.
template <class Step>
__device__ __forceinline__ void tile_steps(uint32_t g, uint32_t ta, int len,
                                           uint2 key, Step& step) {
  for (int j = 0; j < len;) {
    const uint32_t tj = ta + (uint32_t)j;
    const uint4 b =
        philox4x32_10(make_uint4(g, tj >> 2, kTransitionStream, 0u), key);
    const int first = (int)(tj & 3u);
    const int last = min(4, first + len - j);   // words first .. last-1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= first && q < last)
        step(j + q - first,
             philox_u01(q == 0 ? b.x : q == 1 ? b.y : q == 2 ? b.z : b.w));
    }
    j += last - first;
  }
}

// The emission rows of a tile's len steps (observations ys[0 .. len)) into
// e, row j at e + j * K, one entry a thread: the arithmetic of emission().
__device__ __forceinline__ void emission_rows(const float* __restrict__ tab,
                                              int K,
                                              const float* __restrict__ ys,
                                              int len, float* e) {
  const float* mu = tab + K * (K - 1);   // means | 0.5/sigma^2 | log-normaliser
  for (int idx = threadIdx.x; idx < len * K; idx += kThreads) {
    const int j = idx / K, k = idx - j * K;
    const float d = __fsub_rn(__ldg(ys + j), __ldg(mu + k));
    e[idx] = __fsub_rn(__ldg(mu + 2 * K + k),
                       __fmul_rn(__fmul_rn(__ldg(mu + K + k), d), d));
  }
}

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

// The initial states of particles 4q .. 4q + 3 come from the four words of
// one Philox call at counter (q, 0, kInitStream, 0), word j for particle
// 4q + j: a quarter of a call a particle.
__device__ __forceinline__ void init_uniforms(long long q, uint2 key,
                                              float (&u)[4]) {
  const uint4 b =
      philox4x32_10(make_uint4((uint32_t)q, 0u, kInitStream, 0u), key);
  u[0] = philox_u01(b.x);
  u[1] = philox_u01(b.y);
  u[2] = philox_u01(b.z);
  u[3] = philox_u01(b.w);
}

// Stores the states and weights of particles 4q .. 4q + 3 that are below n:
// one int4 and one float4 when all four are.  Returns how many it stored.
__device__ __forceinline__ int store_quad(long long q, long long n,
                                          const int (&s)[4],
                                          const float (&w)[4],
                                          int* __restrict__ s_out,
                                          float* __restrict__ w_out) {
  const long long g = q << 2;
  if (g + 4 <= n) {
    reinterpret_cast<int4*>(s_out)[q] = make_int4(s[0], s[1], s[2], s[3]);
    reinterpret_cast<float4*>(w_out)[q] = make_float4(w[0], w[1], w[2], w[3]);
    return 4;
  }
  const int m = (int)(n - g);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j < m) {
      s_out[g + j] = s[j];
      w_out[g + j] = w[j];
    }
  }
  return m;
}

// The CTA's init record from its state counts hist[0 .. K) (every particle
// in state k carries the same t = 0 weight emis[k]): (max emis_k over the
// states present, sum_k c_k x_k, sum_k c_k x_k^2, c_k x_k, 0) with x_k =
// exp(emis_k - max).  One thread writes it; both init kernels use it.
__device__ __forceinline__ void init_record(const int* hist, const float* emis,
                                            int K, float* out) {
  float m = -INFINITY;
  for (int k = 0; k < K; ++k)
    if (hist[k] > 0) m = fmaxf(m, emis[k]);
  float se = 0.f, se2 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float x = hist[k] > 0 ? expf(emis[k] - m) : 0.f;
    const float c = (float)hist[k];
    se += c * x;
    se2 += c * (x * x);
    out[3 + k] = c * x;
  }
  out[0] = m;
  out[1] = se;
  out[2] = se2;
  out[K + 3] = 0.f;
}

// A grid-stride loop over quads of particles, one Philox call a quad
// (init_uniforms): states from the initial CDF, the t = 0 emission weight,
// stored as one int4 and one float4 (store_quad); each thread counts its
// particles' states in K registers, a warp sums them with redux.sync and
// the CTA across its warps, and the record comes from the counts
// (init_record): no exp a particle.
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_init_kernel(const float* __restrict__ tab, const float* __restrict__ y0,
                const uint32_t* __restrict__ key_dev, int* __restrict__ s_out,
                float* __restrict__ w_out, float* __restrict__ rec,
                long long n) {
  static_assert(K >= 2, "K >= 2");
  __shared__ int counts[kWarps][K];
  __shared__ int hist[K];
  __shared__ float emis[K];
  float mu[K], hiv[K], lc[K], e[K], icdf[K - 1];
  load_emission_tables<K>(tab, mu, hiv, lc);
#pragma unroll
  for (int k = 0; k < K - 1; ++k) icdf[k] = tab[K * (K - 1) + 3 * K + k];
  emission<K>(__ldg(y0), mu, hiv, lc, e);

  int c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = 0;
  const uint2 key = load_key(key_dev);
  const long long nq = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < nq;
       q += stride) {
    float u[4];
    init_uniforms(q, key, u);
    int s[4];
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = 0;
#pragma unroll
      for (int k = 0; k < K - 1; ++k) s[j] += (u[j] >= icdf[k]);
      w[j] = pick<K>(s[j], e);
    }
    const int m = store_quad(q, n, s, w, s_out, w_out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) c[k] += (j < m && s[j] == k) ? 1 : 0;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = __reduce_add_sync(0xffffffffu, c[k]);
    if (lane == 0) counts[warp][k] = v;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) emis[k] = e[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    int h = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) h += counts[w][threadIdx.x];
    hist[threadIdx.x] = h;
  }
  __syncthreads();
  if (threadIdx.x == 0) init_record(hist, emis, K, rec + (long long)blockIdx.x * (K + 4));
}

// One CTA = one island of kIsland particles, each thread holding
// kPerThread of them (index base + i*kThreads + tid) in registers for the
// whole chunk.  ctrl = [flag, ticks (K-1), n_valid].
template <int K>
__global__ void __launch_bounds__(kThreads, min_blocks(K <= 3))
hmm_chunk_kernel(const float* __restrict__ tab, const float* __restrict__ ys,
                 int n_steps, const int* __restrict__ ctrl,
                 const uint32_t* __restrict__ key_dev, uint32_t t0,
                 int island_every, float thresh, const int* __restrict__ s_in,
                 const float* __restrict__ w_in, int* __restrict__ s_out,
                 float* __restrict__ w_out, float* __restrict__ rec) {
  static_assert(K >= 2, "K >= 2");
  __shared__ float cdf[K * (K - 1)];
  __shared__ float erow[2][kTile * K];
  __shared__ float red[kWarps * (K + 2)];
  __shared__ float bcast[K + 2];
  __shared__ int collapse_s;
  if (threadIdx.x < K * (K - 1)) cdf[threadIdx.x] = tab[threadIdx.x];

  const int flag = ctrl[0];
  int tick[K - 1];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) tick[k] = ctrl[1 + k];
  const int n_valid = ctrl[K];
  // the key: read once into two registers (+1.1 % at K = 3, +1.5 % at
  // K = 5 against a key by value; read at each tile, +4.4 and +5 %), but
  // at K = 4 and 8, where ptxas spills 12 B to hold them across an island
  // check, from shared memory at each tile
  __shared__ uint2 key_s;
  const LaunchKey<K == 4 || K == 8> key(&key_s, key_dev);
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

  // steps at or past n_valid leave the particles alone, and a check after
  // step t can fire only while t + 1 < n_valid: both end at n_run
  const int n_run = max(0, min(n_steps, n_valid));
  const float nb = (float)kIsland;
  float count = 0.f;
  for (int t = 0, buf = 0; t < n_run; buf ^= 1) {
    const int end = tile_end<kTile>(t, t0, n_run, island_every);
    const int len = end - t;
    const float* e = erow[buf];
    emission_rows(tab, K, ys + t, len, erow[buf]);
    __syncthreads();   // the tile's rows (and, at the first, the CDF)
    const uint32_t ta = t0 + (uint32_t)t;
    const uint2 kt = key();
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int si = s[i];
      float wi = w[i];
      auto step = [&](int j, float u) {
        const float* row = cdf + si * (K - 1);
        int ns = 0;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) ns += (u >= row[k]);
        si = ns;
        wi = __fadd_rn(wi, e[j * K + ns]);
      };
      tile_steps(base + i * kThreads + threadIdx.x, ta, len, kt, step);
      s[i] = si;
      w[i] = wi;
    }
    t = end;
    if (island_every > 0 && t % island_every == 0 && t < n_run) {
      // the check after step t - 1: the island's Kish ESS; on collapse a
      // block-local systematic exchange resample at the island's log-mean
      // weight
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
      if (threadIdx.x == 0) collapse_s = v[0] * v[0] < thresh * nb * v[1];
      __syncthreads();
      if (collapse_s) {
        const float u0 = philox_u01(philox4x32_10(
            make_uint4(blockIdx.x, t0 + (uint32_t)(t - 1), 1u, 0u), key()).x);
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

// ---------------------------------------------------------------------------
// K at run time (K = 1 and 9..32): tables in shared memory.

constexpr int kMaxK = 32;
constexpr int kMaxStride = 31;   // odd row stride of the CDF rows, <= 31

// The number of entries of the non-decreasing row[0..len) that are <= u:
// what sum_k (u >= row[k]) gives, in at most 5 shared loads.
__device__ __forceinline__ int count_le(const float* row, int len, float u) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] <= u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Block sums of (sum e, sum e^2, sum e per category k < n_cat) over every
// thread's kPerThread particles, into out[0 .. n_cat + 2): one warp
// reduction per value, the warps' partials summed in warp order (the order
// of block_sum).  red: kWarps * (kMaxK + 2) floats.  Every thread calls it;
// out is valid for every thread after it returns.
__device__ __forceinline__ void block_cat_sums(const int (&s)[kPerThread],
                                               const float (&ew)[kPerThread],
                                               int n_cat, float* red,
                                               float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kW = kMaxK + 2;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    a += ew[i];
    b += ew[i] * ew[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    red[warp * kW] = a;
    red[warp * kW + 1] = b;
  }
  for (int k = 0; k < n_cat; ++k) {
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) c += (s[i] == k) ? ew[i] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (lane == 0) red[warp * kW + 2 + k] = c;
  }
  __syncthreads();
  if (threadIdx.x < n_cat + 2) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += red[w * kW + threadIdx.x];
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// hmm_init_kernel with K at run time: the same quads and draws, the CDF
// walk a binary search of the initial CDF in shared memory, and the states
// counted in a shared histogram (integer atomics: exact and order-free).
__global__ void __launch_bounds__(kThreads)
hmm_init_kernel_k(int K, const float* __restrict__ tab,
                  const float* __restrict__ y0,
                  const uint32_t* __restrict__ key_dev,
                  int* __restrict__ s_out, float* __restrict__ w_out,
                  float* __restrict__ rec, long long n) {
  __shared__ float icdf[kMaxK];
  __shared__ float emis[kMaxK];
  __shared__ int hist[kMaxK];
  const int km1 = K - 1;
  const int tid = threadIdx.x;
  if (tid < K) {
    const float* t = tab + K * km1;   // means | 0.5/sigma^2 | log-normaliser
    const float d = __fsub_rn(__ldg(y0), t[tid]);
    emis[tid] = __fsub_rn(t[2 * K + tid], __fmul_rn(__fmul_rn(t[K + tid], d), d));
    hist[tid] = 0;
    if (tid < km1) icdf[tid] = t[3 * K + tid];
  }
  __syncthreads();
  const uint2 key = load_key(key_dev);
  const long long nq = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + tid; q < nq;
       q += stride) {
    float u[4];
    init_uniforms(q, key, u);
    int s[4];
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = count_le(icdf, km1, u[j]);
      w[j] = emis[s[j]];
    }
    const int m = store_quad(q, n, s, w, s_out, w_out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < m) atomicAdd(&hist[s[j]], 1);
  }
  __syncthreads();
  if (tid == 0) init_record(hist, emis, K, rec + (long long)blockIdx.x * (K + 4));
}

// hmm_chunk_kernel with K at run time: the same tiles, island checks and
// records, the population, the tables and each tile's emission rows in
// shared memory.
__global__ void __launch_bounds__(kThreads, min_blocks(true))
hmm_chunk_kernel_k(int K, const float* __restrict__ tab,
                   const float* __restrict__ ys, int n_steps,
                   const int* __restrict__ ctrl,
                   const uint32_t* __restrict__ key_dev, uint32_t t0,
                   int island_every, float thresh,
                   const int* __restrict__ s_in, const float* __restrict__ w_in,
                   int* __restrict__ s_out, float* __restrict__ w_out,
                   float* __restrict__ rec) {
  __shared__ int st[kIsland];
  __shared__ float wt[kIsland];
  __shared__ float cdf[kMaxK * kMaxStride];
  __shared__ float erow[2][kTile * kMaxK];
  __shared__ int tick[kMaxK];
  __shared__ int isl_tick[kMaxK];
  __shared__ float red[kWarps * (kMaxK + 2)];
  __shared__ float sums[kMaxK + 2];
  __shared__ float bcast[1];
  __shared__ float lme_s;
  __shared__ int collapse_s;
  const int km1 = K - 1;
  const int row_stride = km1 | 1;   // odd: a warp's reads of one column of
                                    // different rows fall in other banks
  const int tid = threadIdx.x;
  for (int j = tid; j < K * km1; j += kThreads)
    cdf[(j / km1) * row_stride + j % km1] = tab[j];
  if (tid < km1) tick[tid] = ctrl[1 + tid];
  const int flag = ctrl[0];
  const int n_valid = ctrl[K];
  const uint2 key = load_key(key_dev);
  const uint32_t base = blockIdx.x * (uint32_t)kIsland;
  __syncthreads();   // tables, ticks

  for (int i = 0; i < kPerThread; ++i) {
    const int jl = i * kThreads + tid;
    const uint32_t g = base + jl;
    if (flag) {
      int v = 0;
      for (int k = 0; k < km1; ++k) v += ((long long)g >= tick[k]);
      st[jl] = v;
      wt[jl] = 0.f;
    } else {
      st[jl] = s_in[g];
      wt[jl] = w_in[g];
    }
  }

  const int n_run = max(0, min(n_steps, n_valid));   // as hmm_chunk_kernel
  const float nb = (float)kIsland;
  float count = 0.f;
  int s[kPerThread];   // a check's and the record's copies of the states
  float ew[kPerThread];
  for (int t = 0, buf = 0; t < n_run; buf ^= 1) {
    const int end = tile_end<kTile>(t, t0, n_run, island_every);
    const int len = end - t;
    const float* e = erow[buf];   // double-buffered: one barrier a tile
    emission_rows(tab, K, ys + t, len, erow[buf]);
    __syncthreads();
    const uint32_t ta = t0 + (uint32_t)t;
#pragma unroll kUnroll
    for (int i = 0; i < kPerThread; ++i) {
      const int jl = i * kThreads + tid;
      int si = st[jl];
      float wi = wt[jl];
      auto step = [&](int j, float u) {
        const int ns = count_le(cdf + si * row_stride, km1, u);
        si = ns;
        wi = __fadd_rn(wi, e[j * K + ns]);
      };
      tile_steps(base + jl, ta, len, key, step);
      st[jl] = si;
      wt[jl] = wi;
    }
    t = end;
    if (island_every > 0 && t % island_every == 0 && t < n_run) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) m = fmaxf(m, wt[i * kThreads + tid]);
      m = block_max<kThreads>(m, red, bcast);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        s[i] = st[i * kThreads + tid];
        ew[i] = expf(wt[i * kThreads + tid] - m);
      }
      block_cat_sums(s, ew, km1, red, sums);
      // one thread decides and places the island's ticks; every thread
      // follows
      if (tid == 0) {
        const int c = sums[0] * sums[0] < thresh * nb * sums[1];
        collapse_s = c;
        if (c) {
          const float u0 = philox_u01(philox4x32_10(
              make_uint4(blockIdx.x, t0 + (uint32_t)(t - 1), 1u, 0u), key).x);
          float cum = 0.f;
          for (int k = 0; k < km1; ++k) {
            cum = __fadd_rn(cum, sums[2 + k]);
            const float x = __fsub_rn(__fmul_rn(nb, __fdiv_rn(cum, sums[0])), u0);
            isl_tick[k] = (int)fminf(fmaxf(ceilf(x), 0.f), nb);
          }
          lme_s = __fsub_rn(__fadd_rn(m, logf(sums[0])), logf(nb));
        }
      }
      __syncthreads();
      if (collapse_s) {
        const float lme_b = lme_s;
        for (int i = 0; i < kPerThread; ++i) {
          const int jl = i * kThreads + tid;
          int ns = 0;
          for (int k = 0; k < km1; ++k) ns += (jl >= isl_tick[k]);
          st[jl] = ns;
          wt[jl] = lme_b;
        }
        count += 1.f;
      }
      __syncthreads();   // collapse_s, isl_tick and lme_s are read
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int jl = i * kThreads + tid;
    s[i] = st[jl];
    s_out[base + jl] = s[i];
    w_out[base + jl] = wt[jl];
    m = fmaxf(m, wt[jl]);
  }
  m = block_max<kThreads>(m, red, bcast);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) ew[i] = expf(wt[i * kThreads + tid] - m);
  block_cat_sums(s, ew, K, red, sums);
  if (tid == 0) {
    float* out = rec + (long long)blockIdx.x * (K + 4);
    out[0] = m;
    for (int j = 0; j < K + 2; ++j) out[1 + j] = sums[j];
    out[K + 3] = count;
  }
}

// ---------------------------------------------------------------------------
// The guided chunk kernel (K13) and its tables kernel: replace
// _make_guided_discrete_chunk_kernel (cpprob_tpu/ops/pallas_ssm.py:1225-1348)
// and its MXU twin _make_guided_discrete_chunk_kernel_mxu (:1351-1532)
// behind _guided_discrete_mxu_call / attach_fused_guided_discrete_kernels
// (:1535,1588).  Launched with n_steps = 1 they are also the guided model's
// per-step hooks.  K = 1 never reaches them: with one state q = 1, and the
// wrapper launches hmm_chunk_kernel_k, the same chain.
//
// The proposal q(z' | z, y, t) = softmax(MLP([onehot(z), y, t/T])) depends
// on a particle only through z in {0..K-1}: y and t/T are per-step scalars.
// So the net is evaluated K times per step (the reference evaluates it once
// per particle) into three tables a step:
//   cum[a][k]  running sums of exp(l_ak - m_a) over k (l the logits of
//              source state a, m_a their max); ssum[a] = cum[a][K-1];
//   rn[a][b]   log_trans[a][b] + (log g(y | b) - (l_ab - m_a - log ssum[a])),
//              the RN weight of the move a -> b.
// Each particle then does K8's work: one uniform u, K8's draw (word t & 3
// of Philox at (particle, t >> 2, 2, 0)), the next state b = #{k < K-1 :
// cum[a][k] <= u ssum[a]} (the reference's target >= cum walk,
// pallas_ssm.py:1313-1319,1442-1448), and w += rn[a][b].  The exchange
// synthesis at chunk start, n_valid masking, the island checks, the records
// and the tiles are K8's code.
//
// The tables depend on neither the particles nor the CTA, so a launch
// builds each step's once: guided_tables_kernel, one CTA per step, writes
// them to a global buffer of n_steps x (2K^2 + K) floats, and the chunk
// kernel, launched after it with programmatic dependent launch, loads its
// population while the tables are built, waits for them
// (griddepcontrol.wait), copies a tile's tables into shared memory with one
// barrier and runs its particles through the tile.  Built in every CTA, one
// step after the other, the tables cost each CTA (n_layers + 1) barriers a
// step with most of its threads idle: the chunk kernel took 0.580 ms where
// K8, the same particle loop, takes 0.347 ms; the tables kernel and the
// chunk kernel take 0.390 ms; every CTA building all its tile's steps at
// once, n_layers + 1 barriers a tile, 0.430 ms (H100 80GB HBM3 at 700 W,
// 2^24 particles x 8 steps, K = 5, a [7,16,16,5] net;
// util/guided_chain_parts.py).

// Table build (guided_build), for S steps at once: layer 0 (pre[s][a][j] =
// W0[a][j] + (W0[K][j] y_s + W0[K+1][j] t_s/T + b0[j]), one thread per
// (step, state, unit)), then each layer one thread per (step, state, unit)
// summing in input order, then one thread per (step, a, b) for the softmax
// sums and the RN entry: one barrier per layer and one after the tables,
// whatever S.  The arithmetic and its order are those of the plain version
// (ops/fused_hmm.py guided_tables_plain, round-to-nearest intrinsics), so
// the tables are bit-identical to it.
//
// What bounds the chunk kernel on an H100: K8's particle work (a quarter of
// a Philox4x32-10 call and K-1 compares per particle-step, 16 B per
// particle per chunk through HBM): integer issue.  The tables kernel is a
// few thousand multiply-adds a step, latency-bound (one CTA a step), and
// runs while the chunk kernel's CTAs load their population.

// The tables kernel keeps the activations of the K source states in dynamic
// shared memory, two buffers of K * stride floats (stride = the widest
// layer), so the net's width is bounded by kGuidedActBytes, what one CTA may
// hold (227 KB) less 3 KB.  The layers' weights are read from global memory.
constexpr int kGuidedMaxLayers = 32;
constexpr int kGuidedActBytes = 232448 - 3072;
// The chunk kernel is launched with programmatic dependent launch, so its
// CTAs load their population while the tables kernel runs; false launches
// it after the tables kernel has finished (util/guided_chain_parts.py times
// both, and the tables built in every CTA).
constexpr bool kGuidedPdl = true;

struct NetDims {
  int n_layers;
  int stride;                         // widest layer, floats per state row
  int dims[kGuidedMaxLayers + 1];     // [K + 2, H1, ..., K]
};

// Floats of one step's tables: cum (K x K) | ssum (K) | rn (K x K).
template <int K>
__host__ __device__ constexpr int guided_tab_floats() {
  return 2 * K * K + K;
}

// The tables of S consecutive steps (step s: observation ys[s], absolute
// time ta + s) from the net, into out[s * guided_tab_floats<K>() ...].
// act: 2 * S * K * nd.stride floats of shared memory.  Every thread calls
// it; it ends with a barrier, after which out is valid.
template <int K>
__device__ __forceinline__ void guided_build(
    const float* net, const NetDims& nd, const float* __restrict__ tab,
    const float* __restrict__ ltab, const float* __restrict__ ys, int S,
    uint32_t ta, float T, float* act, float* out) {
  constexpr int kTab = guided_tab_floats<K>();
  const int tid = threadIdx.x;
  const int h1 = nd.dims[1], w = nd.stride, rows = S * K;
  // layer 0: the one-hot input selects row a of W0
  for (int idx = tid; idx < rows * h1; idx += kThreads) {
    const int r = idx / h1, j = idx - r * h1;
    const int s = r / K, a = r - s * K;
    const float y = __ldg(ys + s);
    const float tf = __fdiv_rn((float)(ta + (uint32_t)s), T);
    const float c = __fadd_rn(
        __fadd_rn(__fmul_rn(net[K * h1 + j], y),
                  __fmul_rn(net[(K + 1) * h1 + j], tf)),
        net[(K + 2) * h1 + j]);
    const float pre = __fadd_rn(net[a * h1 + j], c);
    act[r * w + j] = nd.n_layers > 1 ? fmaxf(pre, 0.f) : pre;
  }
  __syncthreads();
  int off = (K + 3) * h1;
  for (int l = 1; l < nd.n_layers; ++l) {
    const int n_in = nd.dims[l], n_out = nd.dims[l + 1];
    const float* W = net + off;
    const float* b = W + n_in * n_out;
    const float* prev = act + ((l - 1) & 1) * rows * w;
    float* cur = act + (l & 1) * rows * w;
    for (int idx = tid; idx < rows * n_out; idx += kThreads) {
      const int r = idx / n_out, j = idx - r * n_out;
      float acc = b[j];
      for (int i = 0; i < n_in; ++i)
        acc = __fadd_rn(acc, __fmul_rn(prev[r * w + i], W[i * n_out + j]));
      cur[r * w + j] = l < nd.n_layers - 1 ? fmaxf(acc, 0.f) : acc;
    }
    off += n_in * n_out + n_out;
    __syncthreads();
  }
  const float* logits = act + ((nd.n_layers - 1) & 1) * rows * w;
  constexpr int kMu = K * (K - 1);
  for (int idx = tid; idx < S * K * K; idx += kThreads) {
    const int s = idx / (K * K), e = idx - s * (K * K);
    const int a = e / K, b = e - a * K;
    const float* l = logits + (s * K + a) * w;
    float m = l[0];
#pragma unroll
    for (int k = 1; k < K; ++k) m = fmaxf(m, l[k]);
    float sum = 0.f, cb = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float ek = expf(__fsub_rn(l[k], m));
      sum = k == 0 ? ek : __fadd_rn(sum, ek);
      if (k == b) cb = sum;
    }
    float* o = out + s * kTab;
    o[e] = cb;
    if (b == 0) o[K * K + a] = sum;
    const float lq = __fsub_rn(__fsub_rn(l[b], m), logf(sum));
    const float d = __fsub_rn(__ldg(ys + s), __ldg(tab + kMu + b));
    const float g = __fsub_rn(__ldg(tab + kMu + 2 * K + b),
                              __fmul_rn(__fmul_rn(__ldg(tab + kMu + K + b), d), d));
    o[K * K + K + e] = __fadd_rn(__ldg(ltab + e), __fsub_rn(g, lq));
  }
  __syncthreads();
}

// One CTA per step of the launch: that step's tables into tabs.  ctrl =
// [flag, ticks (K-1), n_valid]: a step at or past n_valid is never read.
template <int K>
__global__ void __launch_bounds__(kThreads)
guided_tables_kernel(const float* __restrict__ tab,
                     const float* __restrict__ ltab,
                     const float* __restrict__ net, NetDims nd, float T,
                     const float* __restrict__ ys,
                     const int* __restrict__ ctrl, uint32_t t0,
                     float* __restrict__ tabs) {
  extern __shared__ float act[];   // 2 x K x nd.stride, dynamic
  // the chunk kernel, launched next with programmatic dependent launch, may
  // start loading its population now
  asm volatile("griddepcontrol.launch_dependents;");
  const int s = blockIdx.x;
  if (s >= ctrl[K]) return;
  guided_build<K>(net, nd, tab, ltab, ys + s, 1, t0 + (uint32_t)s, T, act,
                  tabs + (long long)s * guided_tab_floats<K>());
}

// One CTA = one island of kIsland particles in registers, as in
// hmm_chunk_kernel<K>.  ctrl = [flag, ticks (K-1), n_valid].  tabs: the
// launch's tables from guided_tables_kernel, copied into shared memory a
// tile (up to kTile steps) at a time: the dynamic shared memory holds one
// tile's tables.
template <int K>
__global__ void __launch_bounds__(kThreads, min_blocks(false))
guided_chunk_kernel(const float* tabs, int n_steps,
                    const int* __restrict__ ctrl, uint32_t k0, uint32_t k1,
                    uint32_t t0, int island_every, float thresh,
                    const int* __restrict__ s_in,
                    const float* __restrict__ w_in, int* __restrict__ s_out,
                    float* __restrict__ w_out, float* __restrict__ rec) {
  static_assert(K >= 2 && K <= 8, "2 <= K <= 8");
  constexpr int kTab = guided_tab_floats<K>();
  extern __shared__ float tables[];   // a tile's tables, dynamic
  __shared__ float red[kWarps * (K + 2)];
  __shared__ float bcast[K + 2];
  __shared__ int collapse_s;

  const int flag = ctrl[0];
  int tick[K - 1];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) tick[k] = ctrl[1 + k];
  const int n_valid = ctrl[K];
  const uint2 key = make_uint2(k0, k1);
  const uint32_t base = blockIdx.x * (uint32_t)kIsland;

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

  const int n_run = max(0, min(n_steps, n_valid));   // as hmm_chunk_kernel
  const float nb = (float)kIsland;
  float count = 0.f;
  // the tables kernel has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int t = 0; t < n_run;) {
    const int end = tile_end<kTile>(t, t0, n_run, island_every);
    const int len = end - t;
    if (t > 0) __syncthreads();   // every thread has left the last tile
    for (int i = threadIdx.x; i < len * kTab; i += kThreads)
      tables[i] = __ldcg(tabs + (long long)t * kTab + i);
    __syncthreads();
    const uint32_t ta = t0 + (uint32_t)t;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      int si = s[i];
      float wi = w[i];
      auto step = [&](int j, float u) {
        const float* c = tables + j * kTab;
        const int a = si;
        const float target = __fmul_rn(u, c[K * K + a]);
        int ns = 0;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) ns += (c[a * K + k] <= target);
        si = ns;
        wi = __fadd_rn(wi, c[K * K + K + a * K + ns]);
      };
      tile_steps(base + i * kThreads + threadIdx.x, ta, len, key, step);
      s[i] = si;
      w[i] = wi;
    }
    t = end;
    if (island_every > 0 && t % island_every == 0 && t < n_run) {
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
      if (threadIdx.x == 0) collapse_s = v[0] * v[0] < thresh * nb * v[1];
      __syncthreads();
      if (collapse_s) {
        const float u0 = philox_u01(philox4x32_10(
            make_uint4(blockIdx.x, t0 + (uint32_t)(t - 1), 1u, 0u), key).x);
        int tk[K - 1];
        float cw = 0.f;
#pragma unroll
        for (int k = 0; k < K - 1; ++k) {
          cw = __fadd_rn(cw, v[2 + k]);
          const float x = __fsub_rn(__fmul_rn(nb, __fdiv_rn(cw, v[0])), u0);
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

// The checked NetDims of a net of n_layers layers of sizes dims (host
// array [K + 2, H1, ..., K]); false if the kernels do not take it.
bool guided_net_dims(int K, int n_layers, const int* dims, NetDims* nd) {
  if (n_layers < 1 || n_layers > kGuidedMaxLayers || dims[0] != K + 2 ||
      dims[n_layers] != K)
    return false;
  nd->n_layers = n_layers;
  nd->stride = 0;
  for (int l = 0; l <= kGuidedMaxLayers; ++l) {
    nd->dims[l] = l <= n_layers ? dims[l] : 0;
    if (l <= n_layers && dims[l] < 1) return false;
    if (l >= 1 && l <= n_layers && dims[l] > nd->stride) nd->stride = dims[l];
  }
  return 2LL * K * nd->stride * (long long)sizeof(float) <= kGuidedActBytes;
}

}  // namespace

extern "C" {

int hmm_island_size() { return kIsland; }
int hmm_max_k() { return kMaxK; }
int guided_max_layers() { return kGuidedMaxLayers; }
int guided_act_bytes() { return kGuidedActBytes; }

// Returns cudaGetLastError() after the launch (0 = launched).  dims: host
// array of n_layers + 1 layer sizes [K + 2, H1, ..., K]; net: the layers
// packed as W (in x out, row-major) then b (out), layer after layer; tabs:
// n_steps x (2K^2 + K) floats, the tables guided_chunk_launch reads next.
int guided_tables_launch(int K, const float* tab, const float* ltab,
                         const float* net, int n_layers, const int* dims,
                         float T, const float* ys, int n_steps,
                         const int* ctrl, uint32_t t0, float* tabs,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  NetDims nd;
  if (n_steps < 1 || !guided_net_dims(K, n_layers, dims, &nd))
    return (int)cudaErrorInvalidValue;
  const size_t act_bytes = 2 * (size_t)K * nd.stride * sizeof(float);
  // the opt-in above 48 KB, once per instance
  static bool opted[9] = {};
  switch (K) {
#define GUIDED_TABLES_CASE(KK)                                               \
  case KK:                                                                   \
    if (!opted[KK]) {                                                        \
      const int e = (int)cudaFuncSetAttribute(                               \
          guided_tables_kernel<KK>,                                          \
          cudaFuncAttributeMaxDynamicSharedMemorySize, kGuidedActBytes);     \
      if (e) return e;                                                       \
      opted[KK] = true;                                                      \
    }                                                                        \
    guided_tables_kernel<KK><<<n_steps, kThreads, act_bytes, st>>>(          \
        tab, ltab, net, nd, T, ys, ctrl, t0, tabs);                          \
    break;
    GUIDED_TABLES_CASE(2) GUIDED_TABLES_CASE(3) GUIDED_TABLES_CASE(4)
    GUIDED_TABLES_CASE(5) GUIDED_TABLES_CASE(6) GUIDED_TABLES_CASE(7)
    GUIDED_TABLES_CASE(8)
#undef GUIDED_TABLES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError() after the launch (0 = launched).  tabs: the
// n_steps tables guided_tables_launch wrote (launched just before, on the
// same stream).
int guided_chunk_launch(int K, const float* tabs, int n_steps, const int* ctrl,
                        uint32_t k0, uint32_t k1, uint32_t t0,
                        int island_every, float thresh, const int* s_in,
                        const float* w_in, int* s_out, float* w_out,
                        float* rec, long long n, void* stream) {
  if (n % kIsland != 0 || n_steps < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n / kIsland));
  cfg.blockDim = dim3(kThreads);
  // one tile's tables
  cfg.dynamicSmemBytes =
      (size_t)(n_steps < kTile ? n_steps : kTile) * (2 * K * K + K) * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kGuidedPdl ? 1 : 0;
  switch (K) {
#define GUIDED_CHUNK_CASE(KK)                                                \
  case KK:                                                                   \
    return (int)cudaLaunchKernelEx(&cfg, guided_chunk_kernel<KK>, tabs,      \
                                   n_steps, ctrl, k0, k1, t0, island_every,  \
                                   thresh, s_in, w_in, s_out, w_out, rec);
    GUIDED_CHUNK_CASE(2) GUIDED_CHUNK_CASE(3) GUIDED_CHUNK_CASE(4)
    GUIDED_CHUNK_CASE(5) GUIDED_CHUNK_CASE(6) GUIDED_CHUNK_CASE(7)
    GUIDED_CHUNK_CASE(8)
#undef GUIDED_CHUNK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#define HMM_SMALL_K(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// Returns cudaGetLastError() after the launch (0 = launched).  key: the
// Philox key's two words on the device (philox.cuh LaunchKey).
int hmm_init_launch(int K, const float* tab, const float* y0,
                    const uint32_t* key, int* s_out, float* w_out, float* rec,
                    long long n, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
#define HMM_INIT_CASE(KK)                                                   \
  case KK:                                                                  \
    hmm_init_kernel<KK><<<grid, kThreads, 0, st>>>(tab, y0, key, s_out,     \
                                                   w_out, rec, n);          \
    break;
    HMM_SMALL_K(HMM_INIT_CASE)
#undef HMM_INIT_CASE
    default:
      if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
      hmm_init_kernel_k<<<grid, kThreads, 0, st>>>(K, tab, y0, key, s_out,
                                                   w_out, rec, n);
  }
  return (int)cudaGetLastError();
}

int hmm_chunk_launch(int K, const float* tab, const float* ys, int n_steps,
                     const int* ctrl, const uint32_t* key, uint32_t t0,
                     int island_every, float thresh, const int* s_in,
                     const float* w_in, int* s_out, float* w_out, float* rec,
                     long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % kIsland != 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n / kIsland);
  switch (K) {
#define HMM_CHUNK_CASE(KK)                                                 \
  case KK:                                                                 \
    hmm_chunk_kernel<KK><<<grid, kThreads, 0, st>>>(                       \
        tab, ys, n_steps, ctrl, key, t0, island_every, thresh, s_in, w_in, \
        s_out, w_out, rec);                                                \
    break;
    HMM_SMALL_K(HMM_CHUNK_CASE)
#undef HMM_CHUNK_CASE
    default:
      if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
      hmm_chunk_kernel_k<<<grid, kThreads, 0, st>>>(
          K, tab, ys, n_steps, ctrl, key, t0, island_every, thresh, s_in,
          w_in, s_out, w_out, rec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
