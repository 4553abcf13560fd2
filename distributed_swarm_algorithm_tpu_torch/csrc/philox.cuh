// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), the counter-based generator of the fused optimizer kernels.
//
// It takes the place of the TPU's on-chip generator
// (pltpu.prng_random_bits in distributed_swarm_algorithm_tpu/ops/pallas/
// pso_fused.py:_uniform_bits).  A kernel never keeps generator state: the
// four 32-bit words of one draw are a pure function of a 128-bit counter
// and a 64-bit key, so a draw depends on what it is for (which particle,
// which dimensions, which step, which stream) and not on the launch
// geometry.  The plain PyTorch version of a kernel computes the same
// function in integer tensor arithmetic (ops/cuda/pso_fused.py:
// philox4x32_10) and so draws the same numbers.
//
// Known answer (Random123's kat_vectors): counter 0,0,0,0 and key 0,0 give
// 6627e8d5 e169c58d bc57ac4c 9b00dbd8.

#pragma once

#include <cstdint>

namespace dsa {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

struct Philox4 {
  uint32_t v[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// U[0, 1) from 32 random bits: the top 23 bits become the mantissa of a
// float in [1, 2), minus 1 (the TPU kernel's own construction).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace dsa
