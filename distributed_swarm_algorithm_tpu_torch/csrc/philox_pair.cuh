// Two Philox4x32-10 streams drawn together, with the work that depends only
// on the lane or only on the step hoisted out of the per-group calls: the
// grey-wolf, PSO, bat, cuckoo and tempering kernels' streams 0 and 1, the
// Harris-hawks kernel's 0 and 1, 2 and 3, 5 and 6.
//
// A kernel draws, for particle `lane`, group g of four indices and global
// step `ctr`, the words philox4x32_10(lane, g, ctr, s, seed, 0) of two
// streams s = s0 and s1 (philox.cuh, unchanged: every other kernel includes
// it).
// Written out, the first three rounds of those two calls share work:
//
//   round 0   M0 lane (the lane only) and M1 ctr (the step only);
//   round 1   M0 (hi(M1 ctr) ^ g ^ seed) is the same for both streams;
//             M1 (hi(M0 lane) ^ s) depends on the lane and the stream only;
//   round 2   M0 c0 multiplies a word of the lane, the stream and the step,
//             and M1 c2 a word of the group that both streams share.
//
// So a launch computes three products a lane (PhiloxPairLane), a step two
// more (PhiloxPairStep), and a group of both streams 2 + 7 x 2 x 2 = 30
// where the two plain calls take 40.  The words are philox4x32_10's bit for
// bit; tests hold them together (dsa_gwo_philox_check in gwo_fused.cu for
// streams 0 and 1, dsa_hho_philox_check in hho_fused.cu for the others).

#pragma once

#include <cstdint>

#include "philox.cuh"

namespace dsa {

struct PhiloxPairLane {
  uint32_t lo_lane;   // lo(M0 lane): round 0's c3
  uint32_t hi_s[2];   // hi(M1 (hi(M0 lane) ^ s)): round 1, per stream
  uint32_t lo_s[2];   // lo(M1 (hi(M0 lane) ^ s)): round 1's c1, per stream
};
// (Entry k of hi_s and lo_s is stream s_k of philox_pair_lane's.)

struct PhiloxPairStep {
  uint32_t c0_base;   // hi(M1 ctr) ^ seed: round 0's c0 without g
  uint32_t hi_a[2];   // hi(M0 A_s), A_s round 1's c0 of stream s
  uint32_t lo_a[2];   // lo(M0 A_s): round 2's c3
  uint32_t seed;
};

// The lane's products for streams s0 and s1 (by default 0 and 1).
__device__ __forceinline__ PhiloxPairLane philox_pair_lane(uint32_t lane,
                                                          uint32_t s0 = 0u,
                                                          uint32_t s1 = 1u) {
  const uint32_t hi = __umulhi(kPhiloxM0, lane);
  PhiloxPairLane p;
  p.lo_lane = kPhiloxM0 * lane;
  const uint32_t streams[2] = {s0, s1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    p.hi_s[k] = __umulhi(kPhiloxM1, hi ^ streams[k]);
    p.lo_s[k] = kPhiloxM1 * (hi ^ streams[k]);
  }
  return p;
}

__device__ __forceinline__ PhiloxPairStep philox_pair_step(
    const PhiloxPairLane& l, uint32_t ctr, uint32_t seed) {
  const uint32_t lo_c = kPhiloxM1 * ctr;
  PhiloxPairStep p;
  p.c0_base = __umulhi(kPhiloxM1, ctr) ^ seed;
  p.seed = seed;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t a = l.hi_s[s] ^ lo_c ^ (seed + kPhiloxW0);
    p.hi_a[s] = __umulhi(kPhiloxM0, a);
    p.lo_a[s] = kPhiloxM0 * a;
  }
  return p;
}

// The words of both streams for group g: out[k] = philox4x32_10(lane, g,
// ctr, s_k, seed, 0).
__device__ __forceinline__ void philox_pair_group(const PhiloxPairLane& l,
                                                  const PhiloxPairStep& st,
                                                  uint32_t g,
                                                  Philox4 out[2]) {
  // Round 1's shared product and round 2's.
  const uint32_t c0 = st.c0_base ^ g;
  const uint32_t hi1 = __umulhi(kPhiloxM0, c0), lo1 = kPhiloxM0 * c0;
  const uint32_t c2 = hi1 ^ l.lo_lane ^ kPhiloxW1;
  const uint32_t hi2 = __umulhi(kPhiloxM1, c2), lo2 = kPhiloxM1 * c2;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // The counter after round 2, then rounds 3 to 9.
    uint32_t x0 = hi2 ^ l.lo_s[s] ^ (st.seed + 2u * kPhiloxW0);
    uint32_t x1 = lo2;
    uint32_t x2 = st.hi_a[s] ^ lo1 ^ (2u * kPhiloxW1);
    uint32_t x3 = st.lo_a[s];
#pragma unroll
    for (uint32_t round = 3; round < 10; ++round) {
      const uint32_t h0 = __umulhi(kPhiloxM0, x0), m0 = kPhiloxM0 * x0;
      const uint32_t h1 = __umulhi(kPhiloxM1, x2), m1 = kPhiloxM1 * x2;
      const uint32_t n0 = h1 ^ x1 ^ (st.seed + round * kPhiloxW0);
      const uint32_t n2 = h0 ^ x3 ^ (round * kPhiloxW1);
      x0 = n0;
      x1 = m1;
      x2 = n2;
      x3 = m0;
    }
    out[s] = Philox4{{x0, x1, x2, x3}};
  }
}

}  // namespace dsa
