// The JAX package's fast-math primitives as device functions, for the
// fused optimizer kernels (csrc/salp_fused.cu, ga_fused.cu, mfo_fused.cu,
// cuckoo_fused.cu, hho_fused.cu, abc_fused.cu, tempering_fused.cu).
//
// They replace the Mosaic helpers of the TPU kernels:
//   distributed_swarm_algorithm_tpu/ops/pallas/firefly_fused.py: _exp2_poly,
//     exp2_fast (2^t: the exponent field times a degree-5 polynomial);
//   distributed_swarm_algorithm_tpu/ops/pallas/cuckoo_fused.py: _log2_fast
//     (log2 x: the exponent field plus a degree-6 mantissa polynomial) and
//     _normal_pair (Box-Muller from two uniforms over that log2 and the
//     objectives header's cos 2 pi polynomial).
// Each Horner step is a separate IEEE product and sum (never contracted
// into a multiply-add), in the order of the plain PyTorch versions
// (ops/cuda/fast_math.py), so kernel and plain version agree bit for bit.

#pragma once

#include <cstdint>

#include "swarm_objectives.cuh"

namespace dsa {
namespace fast {

using obj::add;
using obj::mul;
using obj::sub;

// 2^f for f in [-0.5, 0.5]: degree-5 Horner, each step a product and a sum.
__device__ __forceinline__ float exp2_poly(float f) {
  float p = mul(f, static_cast<float>(0.001339527949));
  p = mul(f, add(static_cast<float>(0.009670762865), p));
  p = mul(f, add(static_cast<float>(0.055503406814), p));
  p = mul(f, add(static_cast<float>(0.240222117415), p));
  p = mul(f, add(static_cast<float>(0.693147200062), p));
  return add(static_cast<float>(1.000000052277), p);
}

// 2^t: t = n + f with n = rint(t), 2^n built in the exponent field, times
// the polynomial; exactly 0 below the normal range.
__device__ __forceinline__ float exp2_fast(float t) {
  const float nr = rintf(t);
  const float f = sub(t, nr);
  const int ni = static_cast<int>(fminf(fmaxf(nr, -126.0f), 126.0f));
  const float two_n = __int_as_float((ni + 127) << 23);
  const float val = mul(two_n, exp2_poly(f));
  return t < -126.0f ? 0.0f : val;
}

__device__ __forceinline__ float exp_fast(float x) {
  return exp2_fast(mul(x, static_cast<float>(1.4426950408889634)));
}

// log2 x for x > 0: the unbiased exponent plus a degree-6 polynomial in the
// mantissa m in [1, 2), Horner from the highest coefficient.
__device__ __forceinline__ float log2_fast(float x) {
  const uint32_t bits = __float_as_uint(x);
  const int e = static_cast<int>((bits >> 23) & 0xFFu) - 127;
  const float m = __uint_as_float((bits & 0x7FFFFFu) | 0x3F800000u);
  float p = static_cast<float>(-0.024825585616);
  p = add(mul(p, m), static_cast<float>(0.266858603621));
  p = add(mul(p, m), static_cast<float>(-1.234262243474));
  p = add(mul(p, m), static_cast<float>(3.218830782097));
  p = add(mul(p, m), static_cast<float>(-5.264107973620));
  p = add(mul(p, m), static_cast<float>(6.065828547204));
  p = add(mul(p, m), static_cast<float>(-3.028317064600));
  return add(static_cast<float>(e), p);
}

// clip(v, lo, hi) = min(max(v, lo), hi) with a NaN kept NaN, as torch.clamp
// and jnp.clip keep it (fminf and fmaxf would drop it).  A Box-Muller pair
// is NaN where its first uniform is 0 (log2_fast(1) is +5e-6): the move it
// feeds must stay NaN, so that its fitness fails every comparison.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// min(v, 0) with a NaN kept NaN, as torch.clamp(max=0) and jnp.minimum.
__device__ __forceinline__ float min0(float v) { return v > 0.0f ? 0.0f : v; }

// Two standard normals by Box-Muller from two U[0, 1) draws:
// r = sqrt(-2 ln 2 * log2(1 - u1)) (1 - u1 lies in (0, 1]; -2 ln 2 is one
// f32 constant, as the JAX package folds the Python product), n1 = r cos
// 2 pi u2, n2 = r sin 2 pi u2.
__device__ __forceinline__ void normal_pair(float u1, float u2, float& n1,
                                            float& n2) {
  const float r = __fsqrt_rn(
      mul(static_cast<float>(-2.0 * 0.6931471805599453),
          log2_fast(sub(1.0f, u1))));
  n1 = mul(r, obj::cos2pi(u2));
  n2 = mul(r, obj::sin2pi(u2));
}

// The cosine half of normal_pair alone.
__device__ __forceinline__ float normal_cos(float u1, float u2) {
  const float r = __fsqrt_rn(
      mul(static_cast<float>(-2.0 * 0.6931471805599453),
          log2_fast(sub(1.0f, u1))));
  return mul(r, obj::cos2pi(u2));
}

// |n2|^(-1/beta) as 2^(-inv_beta log2(|n2| + 1e-12)): the denominator of a
// Mantegna Levy step (neg_inv_beta = -1/beta as one f32).
__device__ __forceinline__ float levy_power(float n2, float neg_inv_beta) {
  return exp2_fast(mul(neg_inv_beta, log2_fast(add(fabsf(n2), 1e-12f))));
}

}  // namespace fast
}  // namespace dsa
