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
// hardware generator; 64-row wgmma chains in registers in place of
// (512, 512) VMEM chains).
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
constexpr int kTcThreads = 128;   // K18: one warpgroup per CTA
constexpr int kTcRows = 64;       // K18: rows of the chain per warpgroup
constexpr int kTcDim = 64;        // K18: the chain's width, b is kTcDim^2
constexpr int kTcK = kTcDim / 16; // K18: k-steps of one product
constexpr int kTcAcc = kTcDim / 2; // K18: float32 accumulators per thread
constexpr int kTcChains = 2;      // K18: chains per warpgroup

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

// --- K18 on wgmma -----------------------------------------------------------
// b^T in shared memory in wgmma's K-major layout with the 128-byte swizzle:
// row n (column n of b) holds b[0..63][n], 64 bf16 = 128 B, and its 16-byte
// chunk c (k = 8c .. 8c+7) sits at chunk c ^ (n % 8).  Index in bf16 units.
__device__ __forceinline__ int swizzled(int n, int k) {
  return n * kTcDim + ((((k >> 3) ^ (n & 7))) << 3) + (k & 7);
}

// The matrix descriptor of that layout: start address, leading byte offset
// (unused by a swizzled K-major operand), 1024 B between groups of 8 rows,
// 128-byte swizzle.  A k-step of 16 bf16 (32 B) adds 2 to the address field.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of d across a fence or a wait.
__device__ __forceinline__ void fence_acc(float (&d)[kTcAcc]) {
#pragma unroll
  for (int i = 0; i < kTcAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a (64x16 bf16, registers) @ b (16x64 bf16, shared memory, desc);
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[kTcAcc],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// One product of a chain: four k-steps, committed as one group.
__device__ __forceinline__ void chain_product(float (&d)[kTcAcc],
                                              const uint32_t (&af)[kTcK][4],
                                              uint64_t desc) {
  wgmma_fence();
  fence_acc(d);
#pragma unroll
  for (int j = 0; j < kTcK; ++j) wgmma_64x64x16(d, af[j], desc + 2 * j, j > 0);
  wgmma_commit();
}

// K18: per warpgroup (one CTA), kTcChains chains c <- (bf16(c) @ bf16(b))
// * 1e-3 over its 64 rows of a (rows, 64), started at a (1 + 1e-6 i); `reps`
// products each; out = the chains' final values summed in chain order.
// Row r of a product depends only on row r of c, so each warpgroup runs its
// chains alone: b, rounded to bf16, is staged once into shared memory
// (8 KB, swizzled, read by descriptor), and a chain's A operand stays in
// registers: the float32 accumulators of two neighbouring n8 columns are,
// element for element, the A fragment of the next product's k-step, rounded
// to bf16 on the way.  Each product is four wgmma m64n64k16 in one commit
// group; the chains' groups are issued one after another, then one
// wait_group 0 and the chains' scale-and-repack.  The epilogue of one CTA
// overlaps the products of the others on its SM (four CTAs of 122
// registers): waiting for chain c's group alone (wait_group 1) so that
// its epilogue overlaps the other chains' products made ptxas serialize
// every wgmma (C7514, reads of accumulators between a wgmma and its wait)
// and ran slower on an H100 80GB HBM3 at 700 W.
__global__ void __launch_bounds__(kTcThreads, 1)
tensor_core_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   int reps, float* __restrict__ out) {
  __shared__ __align__(1024) __nv_bfloat16 sb[kTcDim * kTcDim];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = tid; i < kTcDim * kTcDim; i += kTcThreads)
    sb[swizzled(i % kTcDim, i / kTcDim)] = __float2bfloat16_rn(b[i]);
  // the generic-proxy stores above, before wgmma reads them (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc = smem_desc(sb);

  // warp w of the warpgroup holds rows 16 w .. 16 w + 15 of the fragments
  const long long row0 = (long long)blockIdx.x * kTcRows + 16 * warp;
  const float* r_lo = a + (row0 + gid) * kTcDim;
  const float* r_hi = a + (row0 + gid + 8) * kTcDim;
  uint32_t af[kTcChains][kTcK][4];
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

  // d[c][4t + e]: rows gid (e < 2) and gid + 8, columns 8t + 2 tig + e % 2
  float d[kTcChains][kTcAcc];
#pragma unroll
  for (int c = 0; c < kTcChains; ++c) chain_product(d[c], af[c], desc);
  for (int rep = 1; rep < reps; ++rep) {  // reps >= 1 (the wrapper checks)
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kTcChains; ++c) {
      fence_acc(d[c]);
#pragma unroll
      for (int j = 0; j < kTcK; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          af[c][j][h] = pack_bf16(__fmul_rn(d[c][8 * j + 2 * h], 1e-3f),
                                  __fmul_rn(d[c][8 * j + 2 * h + 1], 1e-3f));
    }
#pragma unroll
    for (int c = 0; c < kTcChains; ++c) chain_product(d[c], af[c], desc);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kTcChains; ++c) fence_acc(d[c]);
#pragma unroll
  for (int t = 0; t < kTcDim / 8; ++t) {
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] = __fmul_rn(d[0][4 * t + e], 1e-3f);
#pragma unroll
      for (int c = 1; c < kTcChains; ++c)
        s[e] = __fadd_rn(s[e], __fmul_rn(d[c][4 * t + e], 1e-3f));
    }
    const int col = 8 * t + 2 * tig;
    *reinterpret_cast<float2*>(out + (row0 + gid) * kTcDim + col) = make_float2(s[0], s[1]);
    *reinterpret_cast<float2*>(out + (row0 + gid + 8) * kTcDim + col) = make_float2(s[2], s[3]);
  }
}

// K19: out = x + 1, one float4 a thread with streaming cache hints
// (ld.global.cs / st.global.cs: the 512 MB stream is not kept in L2), a
// grid that covers the array once (PyTorch's elementwise shape).  Two or
// four float4s in flight a thread, plain loads and stores, or one wave of
// resident CTAs striding over the array were no faster (PERF.md §6).
__global__ void __launch_bounds__(kThreads)
add_one_kernel(const float4* __restrict__ x, long long n4,
               float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 v = __ldcs(x + i);
    __stcs(out + i, make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f));
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

// The K18 tile: rows per CTA (one warpgroup), the chain's width.
int tc_rows_per_cta() { return kTcRows; }
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
  tensor_core_kernel<<<(int)(rows / kTcRows), kTcThreads, 0,
                       (cudaStream_t)stream>>>(a, b, reps, out);
  return (int)cudaGetLastError();
}

int add_one_launch(const float* x, long long n, float* out, void* stream) {
  const long long n4 = n / 4;
  add_one_kernel<<<(int)((n4 + kThreads - 1) / kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), n4, reinterpret_cast<float4*>(out));
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
