// Device helpers shared by the transition kernels (transition_conv.cuh,
// int8_transition.cu).

#pragma once

#include <stdint.h>

namespace scm {

// Philox4x32-10 (Salmon et al., SC'11): counter = (lo, hi, 0, 0), key = seed.
// Returns the first output word.  Mirrored bit for bit by
// ops/kernels/fused_transition.py::philox_uniform.
__device__ __forceinline__ uint32_t philox_u32(unsigned long long counter,
                                               unsigned long long seed) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32), c2 = 0, c3 = 0;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return c0;
}

// The sample head's uniform for element `counter` of the output: the top 24
// bits of the Philox word, scaled to [0, 1).
__device__ __forceinline__ float philox_uniform(unsigned long long counter,
                                                unsigned long long seed) {
  return (float)(philox_u32(counter, seed) >> 8) * (1.0f / 16777216.0f);
}

// Circular index for an offset of at most one period.
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

}  // namespace scm
