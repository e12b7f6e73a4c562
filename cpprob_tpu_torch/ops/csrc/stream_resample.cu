// The streaming systematic resample epoch for scalar float32 populations.
//
// lse_stats_kernel + lse_combine_kernel replace _logsumexp_stats_kernel /
// logsumexp_stats (cpprob_tpu/ops/pallas_resample.py:727,743): one sweep
// gives (m, wtot) = (max lw, sum exp(lw - m)).
// pass1_tile_sums_kernel, pass1_scan_tiles_kernel and pass1_finish_kernel
// replace _pass1_kernel / _pass1 (pallas_resample.py:113,771): the start
// slot of every particle, st_j = ceil(n * cdf_{j-1} - u0) clipped to [0, n],
// from the exclusive prefix of the normalised weights.
// pass2_kernel replaces the pass-2 kernels behind _streaming_resample
// (scatter, pallas_resample.py:645,706,809): out[i] = vals[j] for the last
// j with st_j <= i, slot i at position i (the scatter kernel's row-major
// enumeration).
//
// What bounds them on an H100: memory.  The epoch reads the weights twice
// (stats, tile sums) and a third time with the values' pass, writes the
// start slots and reads them back in pass 2: ~24 B per particle, ~0.4 GB at
// 2^24, about 0.12 ms at the card's 3.35 TB/s.  The design is the simple
// right one: the TPU's sequential grid with a Kahan carry becomes
// per-tile sums, a one-CTA scan of the tile totals and a finishing pass;
// the MXU scatter and telescoping value differences become a binary
// search of the monotone start slots per output slot, so the output is
// the exact expansion of the start slots, with no float error.
//
// Numerics: exp, the weight prefix and the slot arithmetic are float64
// (the reference's float32 prefix with a Kahan carry is exact only to
// about 2^24 particles, fault F7).  Products that feed a sum use
// round-to-nearest intrinsics, so n * x - u0 is not contracted into a fused
// multiply-add that the plain PyTorch version (ops/stream_resample.py) does
// not have.
//
// flag (int32 device scalar, may be null = on): when it is 0 the stats and
// pass-1 kernels return at once and pass 2 copies the values, so a chunk
// boundary that does not resample costs three near-empty launches and one
// copy, and the host never reads the flag.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // particles per pass-1 tile
constexpr int kScanThreads = 1024;

// Shared-memory index of tile element l, padded by one word per 32 so that
// both the coalesced (l = i*kThreads + tid) and the per-thread contiguous
// (l = tid*kPerThread + k) access patterns are free of bank conflicts.
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

// K14: per-CTA (max, sum exp(lw - max)) over a grid-stride range, one
// online pass; exp and the sum in float64.
__global__ void __launch_bounds__(kThreads)
lse_stats_kernel(const float* __restrict__ lw, long long n,
                 const int* __restrict__ flag, float* __restrict__ rec_m,
                 double* __restrict__ rec_s) {
  __shared__ float redf[kThreads / 32];
  __shared__ float bcastf[1];
  __shared__ double redd[kThreads / 32];
  __shared__ double bcastd[1];
  if (flag_off(flag)) {
    if (threadIdx.x == 0) {
      rec_m[blockIdx.x] = 0.f;
      rec_s[blockIdx.x] = 1.0;
    }
    return;
  }
  float m = -INFINITY;
  double s = 0.0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < n;
       g += stride) {
    const float x = lw[g];
    if (x > m) {
      s = (m == -INFINITY)
              ? 1.0
              : __dadd_rn(__dmul_rn(s, exp((double)m - (double)x)), 1.0);
      m = x;
    } else if (x != -INFINITY) {
      s += exp((double)x - (double)m);
    }
  }
  const float mb = block_max<kThreads>(m, redf, bcastf);
  double v[1] = {(m == -INFINITY) ? 0.0 : s * exp((double)m - (double)mb)};
  block_sum<kThreads, 1>(v, redd, bcastd);
  if (threadIdx.x == 0) {
    rec_m[blockIdx.x] = mb;
    rec_s[blockIdx.x] = v[0];
  }
}

// K14's combine: one CTA folds the records into stats = (m, wtot), float64.
__global__ void __launch_bounds__(kThreads)
lse_combine_kernel(const float* __restrict__ rec_m,
                   const double* __restrict__ rec_s, int n_rec,
                   const int* __restrict__ flag, double* __restrict__ stats) {
  __shared__ float redf[kThreads / 32];
  __shared__ float bcastf[1];
  __shared__ double redd[kThreads / 32];
  __shared__ double bcastd[1];
  if (flag_off(flag)) return;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n_rec; i += kThreads) m = fmaxf(m, rec_m[i]);
  const float mb = block_max<kThreads>(m, redf, bcastf);
  double v[1] = {0.0};
  for (int i = threadIdx.x; i < n_rec; i += kThreads)
    if (rec_m[i] != -INFINITY)
      v[0] = __dadd_rn(v[0],
                       __dmul_rn(rec_s[i], exp((double)rec_m[i] - (double)mb)));
  block_sum<kThreads, 1>(v, redd, bcastd);
  if (threadIdx.x == 0) {
    stats[0] = (double)mb;
    stats[1] = v[0];
  }
}

// K15, step 1: the sum of exp(lw - m) over each tile of kTile particles.
__global__ void __launch_bounds__(kThreads)
pass1_tile_sums_kernel(const float* __restrict__ lw, long long n,
                       const double* __restrict__ stats,
                       const int* __restrict__ flag,
                       double* __restrict__ tile_sum) {
  __shared__ double red[kThreads / 32];
  __shared__ double bcast[1];
  if (flag_off(flag)) return;
  const double m = stats[0];
  const long long base = (long long)blockIdx.x * kTile;
  double v[1] = {0.0};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    if (g < n) v[0] += exp((double)lw[g] - m);
  }
  block_sum<kThreads, 1>(v, red, bcast);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = v[0];
}

// K15, step 2: one CTA turns the tile sums into exclusive tile offsets.
__global__ void __launch_bounds__(kScanThreads)
pass1_scan_tiles_kernel(const double* __restrict__ tile_sum, int n_tiles,
                        const int* __restrict__ flag,
                        double* __restrict__ tile_off) {
  __shared__ double warp_tot[kScanThreads / 32];
  __shared__ double total;
  if (flag_off(flag)) return;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per);
  const int hi = min(n_tiles, lo + per);
  double s = 0.0;
  for (int i = lo; i < hi; ++i) s += tile_sum[i];
  double run = block_exclusive_scan<kScanThreads>(s, warp_tot, &total);
  for (int i = lo; i < hi; ++i) {
    tile_off[i] = run;
    run += tile_sum[i];
  }
}

// K15, step 3: each tile's exclusive prefix in particle order (thread t
// takes particles t*kPerThread .. +kPerThread-1 of the tile, staged through
// shared memory so that global reads and writes stay coalesced), then the
// start slots.  The prefix is capped at the next tile's offset: the tile
// sums of step 1 add in another order than this pass, and without the cap
// a last particle of negligible weight could round past the next tile's
// first one and break the monotone slots that pass 2 relies on.
__global__ void __launch_bounds__(kThreads)
pass1_finish_kernel(const float* __restrict__ lw, long long n,
                    const double* __restrict__ stats,
                    const double* __restrict__ u0p,
                    const int* __restrict__ flag,
                    const double* __restrict__ tile_off,
                    int* __restrict__ st) {
  __shared__ float tile_lw[kTile + kTile / 32];
  __shared__ int tile_st[kTile + kTile / 32];
  __shared__ double warp_tot[kThreads / 32];
  __shared__ double total;
  if (flag_off(flag)) return;
  const double m = stats[0], wtot = stats[1], u0 = *u0p;
  const double nd = (double)n;
  const long long base = (long long)blockIdx.x * kTile;
  const double next =
      blockIdx.x + 1 < gridDim.x ? tile_off[blockIdx.x + 1] : INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int l = i * kThreads + threadIdx.x;
    tile_lw[pad(l)] = (base + l < n) ? lw[base + l] : -INFINITY;
  }
  __syncthreads();
  double e[kPerThread];
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    e[k] = exp((double)tile_lw[pad(threadIdx.x * kPerThread + k)] - m);
    s += e[k];
  }
  double run = tile_off[blockIdx.x] +
               block_exclusive_scan<kThreads>(s, warp_tot, &total);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const double x = __dsub_rn(__dmul_rn(nd, fmin(run, next) / wtot), u0);
    tile_st[pad(threadIdx.x * kPerThread + k)] =
        (int)fmin(fmax(ceil(x), 0.0), nd);
    run += e[k];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int l = i * kThreads + threadIdx.x;
    if (base + l < n) st[base + l] = tile_st[pad(l)];
  }
}

// K16: out[i] = vals[j] for the last j with st[j] <= i (st is monotone and
// st[0] = 0), by binary search; a copy of vals when the flag is off.
__global__ void __launch_bounds__(kThreads)
pass2_kernel(const int* __restrict__ st, const float* __restrict__ vals,
             long long n, const int* __restrict__ flag,
             float* __restrict__ out) {
  const bool off = flag_off(flag);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (off) {
      out[i] = vals[i];
      continue;
    }
    long long lo = 0, hi = n - 1;  // st[lo] <= i holds throughout
    while (lo < hi) {
      const long long mid = lo + (hi - lo + 1) / 2;
      if (__ldg(st + mid) <= i) lo = mid; else hi = mid - 1;
    }
    out[i] = __ldg(vals + lo);
  }
}

}  // namespace

extern "C" {

int stream_tile() { return kTile; }

// Each returns cudaGetLastError() after its launches (0 = launched).
int lse_stats_launch(const float* lw, long long n, const int* flag,
                     float* rec_m, double* rec_s, int grid, double* stats,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  lse_stats_kernel<<<grid, kThreads, 0, s>>>(lw, n, flag, rec_m, rec_s);
  int err = (int)cudaGetLastError();
  if (err) return err;
  lse_combine_kernel<<<1, kThreads, 0, s>>>(rec_m, rec_s, grid, flag, stats);
  return (int)cudaGetLastError();
}

int pass1_launch(const float* lw, long long n, const double* stats,
                 const double* u0, const int* flag, double* tile_sum,
                 double* tile_off, int* st, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  pass1_tile_sums_kernel<<<n_tiles, kThreads, 0, s>>>(lw, n, stats, flag,
                                                      tile_sum);
  int err = (int)cudaGetLastError();
  if (err) return err;
  pass1_scan_tiles_kernel<<<1, kScanThreads, 0, s>>>(tile_sum, n_tiles, flag,
                                                     tile_off);
  err = (int)cudaGetLastError();
  if (err) return err;
  pass1_finish_kernel<<<n_tiles, kThreads, 0, s>>>(lw, n, stats, u0, flag,
                                                   tile_off, st);
  return (int)cudaGetLastError();
}

int pass2_launch(const int* st, const float* vals, long long n,
                 const int* flag, float* out, int grid, void* stream) {
  pass2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(st, vals, n, flag,
                                                           out);
  return (int)cudaGetLastError();
}

}  // extern "C"
