// The streaming systematic resample epoch for scalar float32 populations.
//
// lse_stats_kernel replaces _logsumexp_stats_kernel / logsumexp_stats
// (cpprob_tpu/ops/pallas_resample.py:727,743): one launch gives (m, wtot)
// = (max lw, sum exp(lw - m)), its combine done by the last CTA.
// pass1_scan_kernel replaces _pass1_kernel / _pass1 (pallas_resample.py:
// 113,771): the start slot of every particle, st_j = ceil(n * cdf_{j-1} -
// u0) clipped to [0, n], from the exclusive prefix of the normalised
// weights, in one pass (see its note below).
// pass2_tile_kernel replaces the three pass-2 variants behind
// _streaming_resample: scatter (_pass2_scatter_body,
// pallas_resample.py:516,645,706), fast (_pass2_fast_body, :326,469,499)
// and merge (_pass2_body, :164,273,304).  out holds vals[j] for the last j
// with st_j <= i at slot i.  One CTA per tile of 16,384 slots finds the
// owner of the tile's first slot by binary search, scatters the index j of
// every input whose first slot st_j lies in the tile (and that owns a slot:
// st_j < st_{j+1}) into shared memory at st_j - tile base (no two inputs
// write one position), takes a block max-scan, so every slot holds its
// owner, and writes vals[owner] row-major (scatter and fast: slot i at
// position i) or column-major within the tile (merge: slot og*128 + s of
// tile t at t*16384 + s*128 + og, the reference's layout).  It reads the
// start slots of its tile's inputs once, with no per-slot search, and is
// exact.
//
// What bounds them on an H100: memory.  The epoch reads the weights twice
// (stats, pass 1), writes the start slots and reads them back with the
// values in pass 2: ~20 B per particle, ~0.34 GB at 2^24, about 0.1 ms at
// the card's 3.35 TB/s.  The TPU's sequential grid with a Kahan carry
// becomes one single-pass scan with a decoupled look-back; the MXU scatter
// and telescoping value differences become a scatter of owner indices per
// tile, so the output is the exact expansion of the start slots, with no
// float error.
//
// Numerics: exp, the weight prefix and the slot arithmetic are float64
// (the reference's float32 prefix with a Kahan carry is exact only to
// about 2^24 particles, fault F7).  Products that feed a sum use
// round-to-nearest intrinsics, so n * x - u0 is not contracted into a fused
// multiply-add that the plain PyTorch version (ops/stream_resample.py) does
// not have.
//
// flag (int32 device scalar, may be null = on): when it is 0 the stats and
// pass-1 kernels return at once (both leave their scratch untouched) and
// pass 2 copies the values, so a chunk boundary that does not resample
// costs two near-empty launches and a copy, and the host never reads the
// flag.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;

// Shared-memory index of tile element l, padded by one word per 32 so that
// both the coalesced (l = i*kThreads + tid) and the per-thread contiguous
// (l = tid*kPer + k) access patterns are free of bank conflicts.
__device__ __forceinline__ int pad(int l) { return l + (l >> 5); }

__device__ __forceinline__ bool flag_off(const int* flag) {
  return flag != nullptr && *flag == 0;
}

// Exclusive prefix sum of x across the block; *total gets the block's sum.
// warp_tot: kT/32 doubles of shared memory.
template <int kT>
__device__ __forceinline__ double block_exclusive_scan(double x,
                                                       double* warp_tot,
                                                       double* total) {
  constexpr int kWarps = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    double wt = lane < kWarps ? warp_tot[lane] : 0.0;
    double winc = wt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += y;
    }
    if (lane < kWarps) warp_tot[lane] = winc - wt;  // exclusive warp offsets
    if (lane == 31) *total = winc;
  }
  __syncthreads();
  const double ex = warp_tot[warp] + (inc - x);
  __syncthreads();
  return ex;
}

// K14: (m, wtot) = (max lw, sum exp(lw - m)) in one launch.
//
// What bounds it: bytes, 4 B read per particle (0.022 ms at 2^24 at the
// card's calibrated 3.05e12 B/s), and the float64 work, which the card
// issues at half its float32 rate: with the CUDA math library's exp
// (~21 double-precision instructions a weight) it took longer than the
// loads (util/lse_parts.py).  So the design keeps enough loads in flight
// to cover HBM's latency and cuts the float64 work to ~12 instructions a
// weight (chip_smoke.py counts them from the SASS of the batch loop):
// - a persistent grid (the CTAs the card holds at once, from the occupancy,
//   evened out so every CTA takes the same number of batches) whose
//   threads issue kLseVec 16-byte loads (16 weights, 64 B) for a batch
//   before they use any of them, neighbouring threads on neighbouring
//   vectors; a head before the first 16-byte boundary (a view at an
//   offset) and a tail of n mod 4 are scalar loads, no copy;
// - the batch's max first, in registers, so the running sum is rescaled
//   once a batch, and only when the max rises, not once an element;
// - exp_nonpos below: a float64 exp of arguments <= 0 (every argument here
//   is a weight less a max), a 64-entry table of 2^(j/64) in shared memory
//   and a degree-5 polynomial, within a few ulp of exp;
// - the combine in the same launch: each CTA reduces its range and writes
//   its record; the last CTA to finish (an atomic ticket, as pass 1's
//   ctr[1]) folds every record and writes stats, then resets the ticket.
//   It folds them by CTA index (thread t takes records t, t + kThreads, ...
//   in order, then a fixed tree), never in the order the CTAs finished, so
//   two calls on the same weights give bit-equal stats.
// A weight at -inf adds exp(-inf) = 0; a thread whose weights are all -inf
// so far skips its exps, and a population all at -inf gives (-inf, 0).
// flag 0: every CTA returns at once and the ticket is left as it is.
constexpr int kLseVec = 4;  // 16-byte loads a thread per batch

// exp(d) for d <= 0 in float64: d = (64 k + j) ln2 / 64 + r, |r| <=
// ln2 / 128 (one fused multiply-add with a rounding constant gives 64 k + j
// in its low word), exp(r) by its Taylor polynomial of degree 5 (the
// remainder under 4e-17 relative), times tab[j] = 2^(j/64), times 2^k by
// an add to the exponent field.  The reduction's one multiply-add errs by
// |d| * 1e-16 relative at most, so a term's relative error stays under
// ~2e-15 where it weighs e^d; below -700 (and at -inf) it is 0, a term
// under 1e-304 of the largest, which is 1.  Ten double-precision
// instructions, against ~20 for the math library's exp.
__device__ __forceinline__ double exp_nonpos(double d, const double* tab) {
  constexpr double kMagic = 6755399441055744.0;       // 1.5 * 2^52
  constexpr double kInvStep = 92.33248261689366;    // 64 / ln 2
  constexpr double kStep = 0.010830424696249145;    // ln 2 / 64
  const double t = __fma_rn(d, kInvStep, kMagic);
  const int kj = __double2loint(t);
  const double r = __fma_rn(__dsub_rn(t, kMagic), -kStep, d);
  double p = 1.0 / 120.0;
  p = __fma_rn(p, r, 1.0 / 24.0);
  p = __fma_rn(p, r, 1.0 / 6.0);
  p = __fma_rn(p, r, 0.5);
  p = __fma_rn(p, r, 1.0);
  p = __fma_rn(p, r, 1.0);
  const double v = __dmul_rn(tab[kj & 63], p);
  const double e = __hiloint2double(__double2hiint(v) + (kj >> 6) * (1 << 20),
                                    __double2loint(v));
  return d < -700.0 ? 0.0 : e;
}

// Folds a batch into the thread's running (m, s): the batch's max, one
// rescale of s when it exceeds m, then exp((double)x - m) in float64.
template <int kN>
__device__ __forceinline__ void lse_fold(const float (&x)[kN], float& m,
                                         double& s, const double* tab) {
  float bm = x[0];
#pragma unroll
  for (int k = 1; k < kN; ++k) bm = fmaxf(bm, x[k]);
  if (bm > m) {
    if (m != -INFINITY)
      s = __dmul_rn(s, exp_nonpos((double)m - (double)bm, tab));
    m = bm;
  }
  if (m == -INFINITY) return;
  const double md = (double)m;
#pragma unroll
  for (int k = 0; k < kN; ++k) s = __dadd_rn(s, exp_nonpos((double)x[k] - md, tab));
}

// (m, sum exp(v - m)) of the block's per-thread pairs, where a thread's sum
// s is relative to its m; every thread gets m, v[0] the sum.
__device__ __forceinline__ float lse_block(float m, double s, double (&v)[1],
                                           const double* tab, float* redf,
                                           float* bcastf, double* redd,
                                           double* bcastd) {
  const float mb = block_max<kThreads>(m, redf, bcastf);
  v[0] = m == -INFINITY ? 0.0
                        : __dmul_rn(s, exp_nonpos((double)m - (double)mb, tab));
  block_sum<kThreads, 1>(v, redd, bcastd);
  return mb;
}

// head: the weights before lw's first 16-byte boundary (0-3, at most n);
// rec_m, rec_s: a record per CTA; ticket: zero before the launch, and left
// zero by the last CTA.
__global__ void __launch_bounds__(kThreads, 4)
lse_stats_kernel(const float* __restrict__ lw, long long n, int head,
                 const int* __restrict__ flag, float* __restrict__ rec_m,
                 double* __restrict__ rec_s, int* __restrict__ ticket,
                 double* __restrict__ stats) {
  __shared__ float redf[kThreads / 32];
  __shared__ float bcastf[1];
  __shared__ double redd[kThreads / 32];
  __shared__ double bcastd[1];
  __shared__ double tab[64];
  __shared__ int last_s;
  if (flag_off(flag)) return;
  if (threadIdx.x < 64) tab[threadIdx.x] = exp2((double)threadIdx.x / 64.0);
  __syncthreads();
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long n4 = (n - head) / 4;
  const long long tail = n - head - 4 * n4;
  float m = -INFINITY;
  double s = 0.0;
  {
    const float x[2] = {g < head ? lw[g] : -INFINITY,
                        g < tail ? lw[head + 4 * n4 + g] : -INFINITY};
    lse_fold(x, m, s, tab);
  }
  const float4* p = reinterpret_cast<const float4*>(lw + head);
  for (long long q = g; q < n4; q += kLseVec * stride) {
    float x[4 * kLseVec];
#pragma unroll
    for (int k = 0; k < kLseVec; ++k) {
      const long long i = q + k * stride;
      const float4 v = i < n4 ? __ldg(p + i)
                              : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      x[4 * k] = v.x;
      x[4 * k + 1] = v.y;
      x[4 * k + 2] = v.z;
      x[4 * k + 3] = v.w;
    }
    lse_fold(x, m, s, tab);
  }
  double v[1];
  const float mb = lse_block(m, s, v, tab, redf, bcastf, redd, bcastd);
  if (threadIdx.x == 0) {
    rec_m[blockIdx.x] = mb;
    rec_s[blockIdx.x] = v[0];
    __threadfence();
    last_s = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the last CTA: the records by CTA index, read past L1
  float mr = -INFINITY;
  double sr = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    const float mi = __ldcg(rec_m + i);
    const double si = __ldcg(rec_s + i);
    if (mi > mr) {
      if (mr != -INFINITY)
        sr = __dmul_rn(sr, exp_nonpos((double)mr - (double)mi, tab));
      mr = mi;
    }
    if (mi != -INFINITY)
      sr = __dadd_rn(sr, __dmul_rn(si, exp_nonpos((double)mi - (double)mr, tab)));
  }
  const float mt = lse_block(mr, sr, v, tab, redf, bcastf, redd, bcastd);
  if (threadIdx.x == 0) {
    stats[0] = (double)mt;
    stats[1] = v[0];
    *ticket = 0;
  }
}

// K15: pass 1 as one single-pass scan.  A CTA takes its tiles by a ticket
// (atomicAdd on ctr[0], not blockIdx: every tile before t then belongs to
// a CTA that is already running, so the look-back below always ends).  It
// loads the tile with coalesced 16-byte loads, through shared memory to the
// threads that own kPer contiguous weights each; they take e = exp(lw - m)
// in float64 once, keep it in registers, and scan the tile in float64: a
// thread's serial sum, then a block exclusive scan.  Thread 0
// publishes the tile's aggregate (status 1), the block looks back over its
// predecessors, kP1Threads at a time, to the nearest one with an inclusive
// prefix (status 2), and the tile publishes its own inclusive prefix.
// Values go out before their status word (st.release) and are read after
// it (ld.acquire), so a status seen means its value is there.  The CTAs are
// persistent and hold one tile back: each runs the body of its new tile
// before the look-back and the slots of the one before, so a look-back
// starts one body after its own aggregate went out, when the predecessors
// it waits for have mostly published theirs.
//
// The look-back adds the aggregates after the inclusive prefix it found one
// by one in tile order, so every inclusive prefix is the serial sum agg_0 +
// agg_1 + ... of the tile aggregates, whichever predecessors had published:
// the result does not depend on timing, and two calls give the same slots.
// A particle's prefix is the tile's exclusive prefix plus its prefix within
// the tile, which the threads form before the look-back (the look-back then
// delays only an add and the slot per particle).  The threads' starts
// within the tile are made non-decreasing by a block max-scan, and each
// slot is capped at the slot of the next thread's start, the last thread's
// at the slot of the tile's inclusive prefix (the very value the next tile
// reads as its exclusive prefix), so the start slots are monotone by
// construction.  The slots go out through shared memory too, as coalesced
// 16-byte stores.  The slot multiplies by 1 / wtot, taken once, in place of a
// division per particle (float64 still; a last-bit difference moves a slot
// only where n * cdf - u0 lies within ~2^-52 n of an integer).
//
// Scratch (per stream, zeroed once when the wrapper allocates it): ctr[0]
// the ticket, ctr[1] the CTAs done, status[n_tiles], vals[2 n_tiles] (the
// aggregates, then the inclusive prefixes).  The last CTA to finish (ctr[1])
// zeroes ctr and status, so the next call finds them clean with no memset
// launch and no host sync, inside a CUDA graph too.  Two streams must not
// share one scratch: the wrapper keeps one per stream.
//
// What bounds it: bytes, 4 B read and 4 B written per particle; the
// float64 work, ~32 double-precision instructions a particle in the SASS
// (the exp's polynomial and its special cases, the prefix adds, the slot
// arithmetic; chip_smoke.py counts them), takes less at half the float32
// rate.  util/pass1_parts.py times the kernel with each part taken out.

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory");
}
__device__ __forceinline__ double ld_relaxed(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

constexpr int kP1Threads = 256;  // pass 1: threads per CTA, the look-back's window
constexpr int kPer = 16;         // pass 1: particles per thread

// The exclusive prefix of tile t > 0.  Every thread of the block calls it
// and gets it.  The block polls its kP1Threads nearest predecessors at once
// (each thread one status word, spinning while it is 0), takes the nearest
// with an inclusive prefix, j, and moves its window back if there is none;
// then thread 0 adds agg[j+1 .. t-1] to incl[j] one by one, in tile order.
// found: kP1Threads / 32 ints, buf: kP1Threads doubles, res: one double.
__device__ __forceinline__ double look_back(int t, const int* status,
                                            const double* agg,
                                            const double* incl, int* found,
                                            double* buf, double* res) {
  constexpr int kWarps = kP1Threads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int hi = t - 1, j;
  for (;;) {
    const int idx = hi - tid;
    int sv = 1;
    if (idx >= 0) {
      do sv = ld_acquire(status + idx); while (sv == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, idx >= 0 && sv == 2);
    if (lane == 0) found[warp] = inc ? warp * 32 + __ffs(inc) - 1 : kP1Threads;
    __syncthreads();  // also orders the threads' acquires before the loads below
    int f = kP1Threads;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) f = min(f, found[w]);
    __syncthreads();
    if (f < kP1Threads) {
      j = hi - f;
      break;
    }
    hi -= kP1Threads;
  }
  double acc = tid == 0 ? ld_relaxed(incl + j) : 0.0;
  for (int b = j + 1; b < t; b += kP1Threads) {
    if (b + tid < t) buf[tid] = ld_relaxed(agg + b + tid);
    __syncthreads();
    if (tid == 0) {
      const int cnt = min(kP1Threads, t - b);
      for (int l = 0; l < cnt; ++l) acc = __dadd_rn(acc, buf[l]);
    }
    __syncthreads();
  }
  if (tid == 0) *res = acc;
  __syncthreads();
  return *res;
}

// The start slot of a particle whose exclusive prefix is r, rw = 1 / wtot:
// monotone non-decreasing in r (each step rounds to nearest, or is ceil or
// a clamp).
__device__ __forceinline__ int start_slot(double r, double rw, double nd,
                                          double u0, int n) {
  const double x = __dsub_rn(__dmul_rn(nd, __dmul_rn(r, rw)), u0);
  return min(max((int)ceil(x), 0), n);
}

// One tile's first half: load, exp, the scan within the tile, the
// aggregate published.  Leaves in e[] each particle's prefix within the
// tile and returns the aggregate; *next: this thread's cap within the tile
// (the next thread's start, or the aggregate for the last thread).  The
// weights arrive by coalesced 16-byte loads and pass through stage (padded
// shared memory) to the threads that own them, kPer contiguous each.
__device__ __forceinline__ double tile_body(
    int tile, const float* __restrict__ lw, long long n, int vec, double m,
    int* status, double* agg, double* incl, double (&e)[kPer], double* next,
    double* warp_tot, double* total, double* buf, float* stage) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tbase = (long long)tile * kP1Threads * kPer;
  if (vec && tbase + kP1Threads * kPer <= n) {
    const float4* p = reinterpret_cast<const float4*>(lw + tbase);
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const int l = 4 * (i * kP1Threads + tid);
      const float4 v = __ldg(p + i * kP1Threads + tid);
      stage[pad(l)] = v.x;
      stage[pad(l + 1)] = v.y;
      stage[pad(l + 2)] = v.z;
      stage[pad(l + 3)] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = i * kP1Threads + tid;
      stage[pad(l)] = tbase + l < n ? lw[tbase + l] : -INFINITY;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)  // 0 past n
      e[4 * q + i] = exp((double)stage[pad(tid * kPer + 4 * q + i)] - m);
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) s = __dadd_rn(s, e[k]);
  const double ex = block_exclusive_scan<kP1Threads>(s, warp_tot, total);
  const double a = *total;
  if (tid == 0) {  // tile 0's aggregate is its inclusive prefix
    st_relaxed(tile == 0 ? incl : agg + tile, a);
    st_release(status + tile, tile == 0 ? 2 : 1);
  }
  // each thread's start, capped at the aggregate and made non-decreasing
  // (a block max-scan), then each particle's running prefix in place of e
  double start = fmin(ex, a);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, start, o);
    if (lane >= o) start = fmax(start, y);
  }
  if (lane == 31) warp_tot[warp] = start;
  __syncthreads();
  for (int w = 0; w < warp; ++w) start = fmax(start, warp_tot[w]);
  buf[tid] = start;
  __syncthreads();
  *next = tid + 1 < kP1Threads ? buf[tid + 1] : a;
  double run = start;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const double ek = e[k];
    e[k] = run;
    run = __dadd_rn(run, ek);
  }
  __syncthreads();  // buf and warp_tot are free again
  return a;
}

// The pass-1 kernel: a persistent CTA takes tiles by ticket and runs them
// one behind the other: the body of its new tile, then the look-back and
// the slots of the tile before it, so that a tile looks back one body
// after publishing its aggregate, when its predecessors have mostly
// published theirs.  pend (dynamic shared memory, kPer x kP1Threads
// doubles): the held tile's prefixes within the tile, each thread's own.
__global__ void __launch_bounds__(kP1Threads)
pass1_scan_kernel(const float* __restrict__ lw, long long n, int vec,
                  const double* __restrict__ stats,
                  const double* __restrict__ u0p, const int* __restrict__ flag,
                  int n_tiles, int* __restrict__ ctr, int* __restrict__ status,
                  double* __restrict__ vals, int* __restrict__ st) {
  static_assert(kPer % 4 == 0, "whole 16-byte vectors per thread");
  constexpr int kWarps = kP1Threads / 32;
  extern __shared__ double pend[];
  __shared__ double warp_tot[kWarps];
  __shared__ double total, res;
  __shared__ double buf[kP1Threads];  // max-scan starts, look-back aggregates
  __shared__ int found[kWarps];
  __shared__ int tile_s, last_s;
  // a tile's weights on the way in, then the held tile's slots on the way
  // out (padded: conflict-free both ways)
  __shared__ float stage[kP1Threads * kPer + kP1Threads * kPer / 32];
  if (flag_off(flag)) return;
  const int tid = threadIdx.x;
  int* stage_i = reinterpret_cast<int*>(stage);
  double* agg = vals;
  double* incl = vals + n_tiles;
  const double m = stats[0], rw = 1.0 / stats[1], u0 = *u0p, nd = (double)n;

  int held = -1;            // the tile whose slots are still to be written
  double held_a = 0.0, held_next = 0.0;
  for (;;) {
    if (tid == 0) tile_s = atomicAdd(ctr, 1);
    __syncthreads();
    const int tile = tile_s;
    double e[kPer], next = 0.0, a = 0.0;
    if (tile < n_tiles)
      a = tile_body(tile, lw, n, vec, m, status, agg, incl, e, &next,
                          warp_tot, &total, buf, stage);
    else
      __syncthreads();  // every thread has read tile_s
    if (held >= 0) {
      double excl = 0.0;
      if (held > 0) {
        excl = look_back(held, status, agg, incl, found, buf, &res);
        if (tid == 0) {
          st_relaxed(incl + held, __dadd_rn(excl, held_a));
          st_release(status + held, 2);
        }
      }
      // capping a prefix at excl + next is capping its slot at that
      // prefix's slot (start_slot is monotone); the last thread's cap is
      // the inclusive prefix just published, the next tile's first prefix
      const int cap_slot = start_slot(__dadd_rn(excl, held_next), rw, nd, u0, (int)n);
      // through stage (free since the body's scan) to coalesced 16-byte
      // stores
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        stage_i[pad(tid * kPer + k)] =
            min(start_slot(__dadd_rn(excl, pend[k * kP1Threads + tid]), rw, nd, u0,
                           (int)n),
                cap_slot);
      __syncthreads();
      const long long tbase = (long long)held * kP1Threads * kPer;
      if (vec && tbase + kP1Threads * kPer <= n) {
        int4* out = reinterpret_cast<int4*>(st + tbase);
#pragma unroll
        for (int i = 0; i < kPer / 4; ++i) {
          const int l = 4 * (i * kP1Threads + tid);
          out[i * kP1Threads + tid] = make_int4(stage_i[pad(l)], stage_i[pad(l + 1)],
                                                stage_i[pad(l + 2)], stage_i[pad(l + 3)]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int l = i * kP1Threads + tid;
          if (tbase + l < n) st[tbase + l] = stage_i[pad(l)];
        }
      }
    }
    if (tile >= n_tiles) break;
#pragma unroll
    for (int k = 0; k < kPer; ++k) pend[k * kP1Threads + tid] = e[k];
    held = tile;
    held_a = a;
    held_next = next;
  }

  // the last CTA to finish leaves the scratch clean for the next call
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(ctr + 1, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (last_s) {
    __threadfence();
    for (int i = tid; i < n_tiles; i += kP1Threads) status[i] = 0;
    if (tid == 0) {
      ctr[0] = 0;
      ctr[1] = 0;
    }
  }
}

constexpr int kOutTile = 16384;            // slots per pass-2 tile
constexpr int kTileThreads = 1024;
constexpr int kTilePer = kOutTile / kTileThreads;
constexpr int kTileSmem = (kOutTile + kOutTile / 32) * (int)sizeof(int);

// The first j in [0, n) with st[j] > v (before: >= v), or n.
__device__ long long upper_bound(const int* st, long long n, long long v,
                                 bool strict) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    const long long s = __ldg(st + mid);
    if (strict ? s <= v : s < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 2, row-major (col_major 0) or column-major per tile (col_major 1);
// one CTA per tile, the last tile masked (merge takes whole tiles only).
__global__ void __launch_bounds__(kTileThreads)
pass2_tile_kernel(const int* __restrict__ st, const float* __restrict__ vals,
                  long long n, const int* __restrict__ flag, int col_major,
                  float* __restrict__ out) {
  extern __shared__ int own[];  // kOutTile owners, padded
  __shared__ long long range[3];
  __shared__ int warp_max[kTileThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * kOutTile;
  const int len = (int)min((long long)kOutTile, n - base);
  if (flag_off(flag)) {
    for (int l = tid; l < len; l += kTileThreads) out[base + l] = vals[base + l];
    return;
  }
  // owner of the first slot (input 0 where st_0 > base); the inputs whose
  // st_j is in the tile
  if (tid < 3)
    range[tid] = tid == 0 ? max(upper_bound(st, n, base, true) - 1, 0LL)
                          : upper_bound(st, n, base + (tid == 2 ? len : 0), false);
  for (int l = tid; l < kOutTile; l += kTileThreads) own[pad(l)] = -1;
  __syncthreads();
  if (tid == 0) own[0] = (int)range[0];
  for (long long j = range[1] + tid; j < range[2]; j += kTileThreads) {
    const int s = __ldg(st + j);
    const long long next = j + 1 < n ? (long long)__ldg(st + j + 1) : n;
    if (s < next) own[pad((int)(s - base))] = (int)j;
  }
  __syncthreads();
  // block max-scan: thread t takes slots t*kTilePer .. +kTilePer-1
  int loc[kTilePer];
  int m = -1;
#pragma unroll
  for (int k = 0; k < kTilePer; ++k) {
    m = max(m, own[pad(tid * kTilePer + k)]);
    loc[k] = m;
  }
  int inc = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = max(inc, y);
  }
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_max[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = max(w, y);
    }
    warp_max[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before = -1;
  if (warp > 0) before = max(before, warp_max[warp - 1]);
#pragma unroll
  for (int k = 0; k < kTilePer; ++k)
    own[pad(tid * kTilePer + k)] = max(before, loc[k]);
  __syncthreads();
  if (col_major) {
    for (int p = tid; p < len; p += kTileThreads)
      out[base + p] = __ldg(vals + own[pad((p & 127) * 128 + (p >> 7))]);
  } else {
    for (int l = tid; l < len; l += kTileThreads)
      out[base + l] = __ldg(vals + own[pad(l)]);
  }
}

}  // namespace

extern "C" {

int pass1_threads() { return kP1Threads; }
int pass1_per_thread() { return kPer; }
int pass2_out_tile() { return kOutTile; }

// Each returns cudaGetLastError() after its launches (0 = launched).
int lse_threads() { return kThreads; }
int lse_per_batch() { return 4 * kLseVec; }

// rec_m, rec_s (cap each) and ticket (one int, zero): the scratch.  The
// grid is at most the CTAs the card holds at once (and cap), evened out so
// that every CTA takes the same number of batches.
int lse_stats_launch(const float* lw, long long n, const int* flag,
                     float* rec_m, double* rec_s, int* ticket, int cap,
                     double* stats, void* stream) {
  static int resident = 0;  // once: the occupancy
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lse_stats_kernel, kThreads, 0);
    if (err) return err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const long long head = ((16 - (long long)((uintptr_t)lw & 15)) & 15) / 4;
  const int h = (int)(head < n ? head : n);
  const long long n4 = (n - h) / 4;
  const long long per_batch = (long long)kLseVec * kThreads;
  const long long batches = n4 > per_batch ? (n4 + per_batch - 1) / per_batch : 1;
  const long long most = resident < cap ? resident : cap;
  const long long rounds = (batches + most - 1) / most;
  const int grid = (int)((batches + rounds - 1) / rounds);
  lse_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      lw, n, h, flag, rec_m, rec_s, ticket, stats);
  return (int)cudaGetLastError();
}

// ctr (2), status (n_tiles, zero) and vals (2 n_tiles): the scratch.  The
// grid is as many CTAs as the card holds at once, at most one per tile.
int pass1_launch(const float* lw, long long n, const double* stats,
                 const double* u0, const int* flag, int* ctr, int* status,
                 double* vals, int* st, void* stream) {
  static int grid = 0;  // once: the opt-in and the occupancy
  const int smem = kPer * kP1Threads * (int)sizeof(double);
  if (grid == 0) {
    int err = (int)cudaFuncSetAttribute(
        pass1_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (!err) err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pass1_scan_kernel, kP1Threads, smem);
    if (err) return err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = sms * per_sm;
  }
  const long long tile = (long long)kP1Threads * kPer;
  const int n_tiles = (int)((n + tile - 1) / tile);
  const int vec = ((uintptr_t)lw % 16 == 0) && ((uintptr_t)st % 16 == 0);
  pass1_scan_kernel<<<grid < n_tiles ? grid : n_tiles, kP1Threads, smem,
                      (cudaStream_t)stream>>>(
      lw, n, vec, stats, u0, flag, n_tiles, ctr, status, vals, st);
  return (int)cudaGetLastError();
}

int pass2_tile_launch(const int* st, const float* vals, long long n,
                      const int* flag, int col_major, float* out,
                      void* stream) {
  static const int attr = cudaFuncSetAttribute(
      pass2_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTileSmem);
  if (attr) return attr;
  const int grid = (int)((n + kOutTile - 1) / kOutTile);
  pass2_tile_kernel<<<grid, kTileThreads, kTileSmem, (cudaStream_t)stream>>>(
      st, vals, n, flag, col_major, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
