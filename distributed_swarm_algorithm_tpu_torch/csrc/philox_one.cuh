// One Philox4x32-10 stream with the work that depends only on the lane or
// only on the step hoisted out of the per-group calls: philox_pair.cuh's
// scheme for a single stream s (the DE kernel's crossover, stream 0; the
// cuckoo kernel's walk and abandonment, streams 2 and 3; the ABC kernel's
// rows, stream 1; the bat kernel's eps past its first group, stream 0; the
// tempering kernel's rows, stream 2; the Harris-hawks kernel's dive step,
// stream 4, and its rows, stream 7).
//
// For lane `lane`, group g and global step `ctr` the words are
// philox4x32_10(lane, g, ctr, s, seed, 0) (philox.cuh).  Round 0 multiplies
// the lane and the step alone; round 1's second product depends on the
// lane and the stream, its first on the group; round 2's first product on
// the lane, the stream and the step.  So a launch computes three products a
// lane (PhiloxOneLane), a step two more (PhiloxOneStep), and a group 2 + 7
// x 2 = 16 where the plain call takes 20.  The words are philox4x32_10's
// bit for bit; tests hold them together (dsa_de_philox_check in
// de_fused.cu, dsa_bat_philox_check in bat_fused.cu, dsa_pt_philox_check
// in tempering_fused.cu, dsa_hho_philox_check in hho_fused.cu).

#pragma once

#include <cstdint>

#include "philox.cuh"
#include "philox_pair.cuh"

namespace dsa {

struct PhiloxOneLane {
  uint32_t lo_lane;   // lo(M0 lane): round 0's c3
  uint32_t hi_s;      // hi(M1 (hi(M0 lane) ^ s)): round 1
  uint32_t lo_s;      // lo(M1 (hi(M0 lane) ^ s)): round 1's c1
};

struct PhiloxOneStep {
  uint32_t c0_base;   // hi(M1 ctr) ^ seed: round 0's c0 without g
  uint32_t hi_a;      // hi(M0 A), A round 1's c0
  uint32_t lo_a;      // lo(M0 A): round 2's c3
  uint32_t seed;
};

__device__ __forceinline__ PhiloxOneLane philox_one_lane(uint32_t lane,
                                                        uint32_t s) {
  const uint32_t hi = __umulhi(kPhiloxM0, lane) ^ s;
  return PhiloxOneLane{kPhiloxM0 * lane, __umulhi(kPhiloxM1, hi),
                       kPhiloxM1 * hi};
}

__device__ __forceinline__ PhiloxOneStep philox_one_step(
    const PhiloxOneLane& l, uint32_t ctr, uint32_t seed) {
  const uint32_t a = l.hi_s ^ (kPhiloxM1 * ctr) ^ (seed + kPhiloxW0);
  return PhiloxOneStep{__umulhi(kPhiloxM1, ctr) ^ seed,
                       __umulhi(kPhiloxM0, a), kPhiloxM0 * a, seed};
}

// Entry s (0 or 1) of philox_pair.cuh's hoisted products, for the stream
// philox_pair_lane put there: what philox_one_lane and philox_one_step
// compute for that stream, so a kernel that draws a group of both streams
// draws more groups of one stream without computing them again.
__device__ __forceinline__ PhiloxOneLane philox_one_of_pair(
    const PhiloxPairLane& l, int s) {
  return PhiloxOneLane{l.lo_lane, l.hi_s[s], l.lo_s[s]};
}

__device__ __forceinline__ PhiloxOneStep philox_one_of_pair(
    const PhiloxPairStep& st, int s) {
  return PhiloxOneStep{st.c0_base, st.hi_a[s], st.lo_a[s], st.seed};
}

// philox4x32_10(lane, g, ctr, s, seed, 0) for the lane and step hoisted.
__device__ __forceinline__ Philox4 philox_one_group(const PhiloxOneLane& l,
                                                   const PhiloxOneStep& st,
                                                   uint32_t g) {
  const uint32_t c0 = st.c0_base ^ g;
  const uint32_t hi1 = __umulhi(kPhiloxM0, c0), lo1 = kPhiloxM0 * c0;
  const uint32_t c2 = hi1 ^ l.lo_lane ^ kPhiloxW1;
  // The counter after round 2, then rounds 3 to 9.
  uint32_t x0 = __umulhi(kPhiloxM1, c2) ^ l.lo_s ^ (st.seed + 2u * kPhiloxW0);
  uint32_t x1 = kPhiloxM1 * c2;
  uint32_t x2 = st.hi_a ^ lo1 ^ (2u * kPhiloxW1);
  uint32_t x3 = st.lo_a;
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
  return Philox4{{x0, x1, x2, x3}};
}

}  // namespace dsa
