// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// port's kernels.  Bit-identical to cpprob_tpu_torch/ops/philox.py, so a
// kernel and its plain PyTorch version draw the same numbers from the same
// (key, counter).
#pragma once

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

// Top 24 bits of a word -> float in [0, 1), exactly.
__device__ __forceinline__ float philox_u01(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}
