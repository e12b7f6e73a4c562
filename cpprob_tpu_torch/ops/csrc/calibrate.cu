// The card's calibration kernels: micro-kernels whose rates are the
// achievable peaks of the roofline (cpprob_tpu_torch/util/roofline.py).
// Counterparts of the five Pallas micro-kernels of examples/roofline.py:
//
//   fp32_chain_kernel      (K17) <- calibrate_vpu            roofline.py:60
//   tensor_core_kernel     (K18) <- calibrate_mxu            roofline.py:86
//   add_one_kernel         (K19) <- calibrate_hbm            roofline.py:125
//   normal_rate_kernel     (K20a) and
//   philox_rate_kernel     (K20b) <- calibrate_prng          roofline.py:151
//   transcendental_kernel  (K21) <- calibrate_transcendental roofline.py:182
//
// Each computes what its TPU kernel computes, with the port's own
// constructions where the TPU's differ (Philox in place of the TPU's
// hardware generator; mma.sync tiles in place of (512, 512) VMEM chains).
// What bounds each is the resource it calibrates: the float32 FMA pipe
// (K17), the tensor cores (K18), HBM (K19), Philox's integer multiplies
// and the Box-Muller transcendentals (K20), expf + log1pf (K21).  Every
// kernel writes what its chains compute, so nvcc cannot drop the work.
//
// Numerics: round-to-nearest intrinsics where a product meets a sum, so
// the compiler contracts nothing the plain PyTorch versions
// (ops/calibrate.py) do not do; precise logf / sqrtf / sincosf / expf /
// log1pf (no fast-math intrinsics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;        // K17: independent FMA chains per element
constexpr int kTcWarps = 4;       // K18: warps per CTA
constexpr int kTcRows = 16;       // K18: rows of the chain per warp
constexpr int kTcDim = 64;        // K18: the chain's width, b is kTcDim^2
constexpr int kTcChains = 2;      // K18: chains per warp
constexpr int kTcK = kTcDim / 16; // K18: k-steps of one product
constexpr int kTcN = kTcDim / 8;  // K18: n-tiles of one product

// (float)(1 + 1e-6 i): the chain scales of K17 and K18, as the reference's
// weakly typed `x * (1.0 + 1e-6 * i)` rounds them.
__device__ __forceinline__ float chain_scale(int i) {
  return (float)(1.0 + 1e-6 * (double)i);
}

// K17: eight chains from x (1 + 1e-6 i), each `steps` fused multiply-adds
// v <- v * 1.0000001 + 1e-7, then their sum in chain order.
__global__ void __launch_bounds__(kThreads)
fp32_chain_kernel(const float* __restrict__ x, long long n, int steps,
                  float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const float x0 = x[g];
  float v[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) v[i] = __fmul_rn(x0, chain_scale(i));
#pragma unroll 4
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) v[i] = __fmaf_rn(v[i], 1.0000001f, 1e-7f);
  }
  float acc = v[0];
#pragma unroll
  for (int i = 1; i < kChains; ++i) acc = __fadd_rn(acc, v[i]);
  out[g] = acc;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p =
      __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// K18: per warp, kTcChains chains c <- (bf16(c) @ bf16(b)) * 1e-3 over its
// 16 rows of a (rows, 64), started at a (1 + 1e-6 i); `reps` products each;
// out = the chains' final values summed in chain order.  Row r of a product
// depends only on row r of c, so each warp runs its chains alone, in
// registers: b's fragments are loaded once, and the float32 accumulators of
// two neighbouring n-tiles are, element for element, the A fragment of the
// next product's k-step (m16n8k16 layouts), rounded to bf16 on the way.
__global__ void __launch_bounds__(kTcWarps * 32)
tensor_core_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   int reps, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long row0 =
      ((long long)blockIdx.x * kTcWarps + (threadIdx.x >> 5)) * kTcRows;

  uint32_t bf[kTcK][kTcN][2];
#pragma unroll
  for (int j = 0; j < kTcK; ++j)
#pragma unroll
    for (int t = 0; t < kTcN; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * j + 2 * tig + 8 * h, col = 8 * t + gid;
        bf[j][t][h] = pack_bf16(b[k * kTcDim + col], b[(k + 1) * kTcDim + col]);
      }

  uint32_t af[kTcChains][kTcK][4];
  const float* r_lo = a + (row0 + gid) * kTcDim;
  const float* r_hi = a + (row0 + gid + 8) * kTcDim;
#pragma unroll
  for (int c = 0; c < kTcChains; ++c) {
    const float s = chain_scale(c);
#pragma unroll
    for (int j = 0; j < kTcK; ++j) {
      const int k = 16 * j + 2 * tig;
      af[c][j][0] = pack_bf16(__fmul_rn(r_lo[k], s), __fmul_rn(r_lo[k + 1], s));
      af[c][j][1] = pack_bf16(__fmul_rn(r_hi[k], s), __fmul_rn(r_hi[k + 1], s));
      af[c][j][2] = pack_bf16(__fmul_rn(r_lo[k + 8], s), __fmul_rn(r_lo[k + 9], s));
      af[c][j][3] = pack_bf16(__fmul_rn(r_hi[k + 8], s), __fmul_rn(r_hi[k + 9], s));
    }
  }

  // reps >= 1 (the wrapper checks); the last product's d leaves the loop
  float d[kTcChains][kTcN][4];
  for (int rep = 0;; ++rep) {
#pragma unroll
    for (int c = 0; c < kTcChains; ++c)
#pragma unroll
      for (int t = 0; t < kTcN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[c][t][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTcK; ++j)
#pragma unroll
      for (int t = 0; t < kTcN; ++t)
#pragma unroll
        for (int c = 0; c < kTcChains; ++c) mma_bf16(d[c][t], af[c][j], bf[j][t]);
#pragma unroll
    for (int c = 0; c < kTcChains; ++c)
#pragma unroll
      for (int t = 0; t < kTcN; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[c][t][e] = __fmul_rn(d[c][t][e], 1e-3f);
    if (rep + 1 >= reps) break;
#pragma unroll
    for (int c = 0; c < kTcChains; ++c)
#pragma unroll
      for (int j = 0; j < kTcK; ++j) {
        af[c][j][0] = pack_bf16(d[c][2 * j][0], d[c][2 * j][1]);
        af[c][j][1] = pack_bf16(d[c][2 * j][2], d[c][2 * j][3]);
        af[c][j][2] = pack_bf16(d[c][2 * j + 1][0], d[c][2 * j + 1][1]);
        af[c][j][3] = pack_bf16(d[c][2 * j + 1][2], d[c][2 * j + 1][3]);
      }
  }
#pragma unroll
  for (int t = 0; t < kTcN; ++t) {
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = d[0][t][e];
#pragma unroll
      for (int c = 1; c < kTcChains; ++c) s[e] = __fadd_rn(s[e], d[c][t][e]);
    }
    const int col = 8 * t + 2 * tig;
    out[(row0 + gid) * kTcDim + col] = s[0];
    out[(row0 + gid) * kTcDim + col + 1] = s[1];
    out[(row0 + gid + 8) * kTcDim + col] = s[2];
    out[(row0 + gid + 8) * kTcDim + col + 1] = s[3];
  }
}

// K19: out = x + 1, 16-byte loads and stores, grid-stride.
__global__ void __launch_bounds__(kThreads)
add_one_kernel(const float4* __restrict__ x, long long n4,
               float4* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 v = x[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    out[i] = v;
  }
}

// K20a: acc = x, then for each pair p: acc += r cos, acc += r sin of the
// Box-Muller pair on Philox counter (element, p, stream); out = acc * 1e-9.
__global__ void __launch_bounds__(kThreads)
normal_rate_kernel(const float* __restrict__ x, long long n, int pairs,
                   uint32_t stream, uint32_t k0, uint32_t k1,
                   float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const uint2 key = make_uint2(k0, k1);
  float acc = x[g];
  for (int p = 0; p < pairs; ++p) {
    const float2 z = philox_normal_pair((uint32_t)g, (uint32_t)p, stream, key);
    acc = __fadd_rn(__fadd_rn(acc, z.x), z.y);
  }
  out[g] = __fmul_rn(acc, 1e-9f);
}

// K20b: acc = x, then for each call c: acc += the uniform of word 0 of
// Philox at counter (element, c, stream); out = acc * 1e-9.
__global__ void __launch_bounds__(kThreads)
philox_rate_kernel(const float* __restrict__ x, long long n, int calls,
                   uint32_t stream, uint32_t k0, uint32_t k1,
                   float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const uint2 key = make_uint2(k0, k1);
  float acc = x[g];
  for (int c = 0; c < calls; ++c) {
    const uint4 w =
        philox4x32_10(make_uint4((uint32_t)g, (uint32_t)c, stream, 0u), key);
    acc = __fadd_rn(acc, philox_u01(w.x));
  }
  out[g] = __fmul_rn(acc, 1e-9f);
}

// K21: `chain` steps of a <- log1p(exp(-|a|)) + 0.3.
__global__ void __launch_bounds__(kThreads)
transcendental_kernel(const float* __restrict__ x, long long n, int chain,
                      float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  float a = x[g];
  for (int s = 0; s < chain; ++s) a = __fadd_rn(log1pf(expf(-fabsf(a))), 0.3f);
  out[g] = a;
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The K18 tile: rows per CTA, the chain's width, chains per warp.
int tc_rows_per_cta() { return kTcWarps * kTcRows; }
int tc_dim() { return kTcDim; }
int tc_chains() { return kTcChains; }

// Each returns cudaGetLastError() after its launch (0 = launched).
int fp32_chain_launch(const float* x, long long n, int steps, float* out,
                      void* stream) {
  fp32_chain_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, n, steps, out);
  return (int)cudaGetLastError();
}

int tensor_core_launch(const float* a, const float* b, long long rows,
                       int reps, float* out, void* stream) {
  const int grid = (int)(rows / (kTcWarps * kTcRows));
  tensor_core_kernel<<<grid, kTcWarps * 32, 0, (cudaStream_t)stream>>>(
      a, b, reps, out);
  return (int)cudaGetLastError();
}

int add_one_launch(const float* x, long long n, float* out, int grid,
                   void* stream) {
  add_one_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), n / 4, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

int normal_rate_launch(const float* x, long long n, int pairs, uint32_t stream_id,
                       uint32_t k0, uint32_t k1, float* out, void* stream) {
  normal_rate_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, n, pairs, stream_id, k0, k1, out);
  return (int)cudaGetLastError();
}

int philox_rate_launch(const float* x, long long n, int calls, uint32_t stream_id,
                       uint32_t k0, uint32_t k1, float* out, void* stream) {
  philox_rate_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, n, calls, stream_id, k0, k1, out);
  return (int)cudaGetLastError();
}

int transcendental_launch(const float* x, long long n, int chain, float* out,
                          void* stream) {
  transcendental_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, n, chain, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
