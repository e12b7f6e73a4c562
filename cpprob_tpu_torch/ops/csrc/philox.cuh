// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// port's kernels.  Bit-identical to cpprob_tpu_torch/ops/philox.py, so a
// kernel and its plain PyTorch version draw the same numbers from the same
// (key, counter).
#pragma once

#include <math.h>
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;  // the bump after the last round is never used
    k.y += 0xBB67AE85u;
  }
  return c;
}

// A launch's Philox key: two words on the device, which the caller writes
// before the launch (ops/philox.py launch_key), so that a replayed CUDA
// graph of the launch draws from the key of its query.  load_key reads
// them once, into two registers.
__device__ __forceinline__ uint2 load_key(const uint32_t* key) {
  return make_uint2(__ldg(key), __ldg(key + 1));
}

// The key as a kernel holds it between its draws: LaunchKey<false> in two
// registers (load_key); LaunchKey<true>, for a kernel with no two
// registers to spare, in shared memory (key_s), copied there by the CTA's
// first thread before a barrier that every thread reaches and read at each
// use (a volatile read, which the compiler may not hoist).
template <bool kShared>
struct LaunchKey {
  uint2 k;
  __device__ __forceinline__ LaunchKey(uint2*, const uint32_t* key)
      : k(load_key(key)) {}
  __device__ __forceinline__ uint2 operator()() const { return k; }
};

template <>
struct LaunchKey<true> {
  const volatile uint2* s;
  __device__ __forceinline__ LaunchKey(uint2* key_s, const uint32_t* key)
      : s(key_s) {
    if (threadIdx.x == 0) *key_s = load_key(key);
    __syncthreads();
  }
  __device__ __forceinline__ uint2 operator()() const {
    return make_uint2(s->x, s->y);
  }
};

// Top 24 bits of a word -> float in [0, 1), exactly.
__device__ __forceinline__ float philox_u01(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// One Box-Muller pair (r cos, r sin) from Philox counter (g, pair, plane, 0):
// u1 from word 0 (clamped to >= 1e-12), u2 from word 1; precise logf, sqrtf
// and sincosf, products rounded to nearest, so the plain PyTorch version
// (ops/fused_lg.py _normal_pair) rounds the same way.
__device__ __forceinline__ float2 philox_normal_pair(uint32_t g, uint32_t pair,
                                                     uint32_t plane,
                                                     uint2 key) {
  const uint4 b = philox4x32_10(make_uint4(g, pair, plane, 0u), key);
  const float u1 = fmaxf(philox_u01(b.x), 1e-12f);
  const float u2 = philox_u01(b.y);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float sn, cs;
  sincosf(__fmul_rn(6.28318530717958648f, u2), &sn, &cs);
  return make_float2(__fmul_rn(r, cs), __fmul_rn(r, sn));
}
