// The ten benchmark objectives as device functions, for the fused optimizer
// kernels (csrc/pso_fused.cu first; the other families' kernels include this
// header too).
//
// They replace the transposed registry OBJECTIVES_T of
// distributed_swarm_algorithm_tpu/ops/pallas/pso_fused.py (lines 88-235),
// which the TPU kernels evaluate on [D, TILE_N] tiles.  Here one thread
// evaluates one particle: `x(d)` returns coordinate d of that particle
// (from shared memory or registers, the kernel decides) and the sums over d
// run in order, d = 0, 1, ....
//
// Arithmetic.  An optimizer branches on `fit < best`, so a last-bit
// difference flips a select and the trajectories part.  Every operation is
// therefore an IEEE intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn,
// rintf), which the compiler never contracts into a multiply-add, in the
// order of the plain PyTorch version (ops/cuda/pso_fused.py: OBJECTIVES_T,
// which sums row by row).  Kernel and plain version then agree bit for bit
// on nine objectives; ackley calls expf, whose last bit is the library's.
//
// Trigonometry.  Every call has the form cos(2 pi t) or a phase shift of
// it, so the range reduction is one rintf, and a degree-7 polynomial in f^2
// (f = t - rint(t)) replaces the transcendental: the TPU kernel's own
// polynomial (pso_fused.py:_cos2pi, max error 5.7e-7 through a float32
// Horner), kept so that the plain version matches the JAX registry to a few
// ulps and the kernel owes nothing to a math library.  cospif could replace
// it on this card, with a stated band against the polynomial.

#pragma once

namespace dsa {

enum Objective : int {
  kSphere = 0,
  kRastrigin = 1,
  kAckley = 2,
  kRosenbrock = 3,
  kGriewank = 4,
  kSchwefel = 5,
  kLevy = 6,
  kZakharov = 7,
  kStyblinskiTang = 8,
  kMichalewicz = 9,
  kObjectiveCount = 10,
};

namespace obj {

constexpr double kPi = 3.141592653589793;
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kHalfPiF = static_cast<float>(kPi / 2.0);
constexpr float kInvTwoPiF = static_cast<float>(1.0 / (2.0 * kPi));
constexpr float kEF = static_cast<float>(2.718281828459045);

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

// cos(2 pi t): one-round range reduction and an even polynomial, Horner
// with a separate product and sum per step.
__device__ __forceinline__ float cos2pi(float t) {
  const float f = sub(t, rintf(t));
  const float z = sq(f);
  float p = static_cast<float>(-1.4609579972486311);
  p = add(mul(p, z), static_cast<float>(7.8066162731190429));
  p = add(mul(p, z), static_cast<float>(-26.406763442656118));
  p = add(mul(p, z), static_cast<float>(60.242465057957851));
  p = add(mul(p, z), static_cast<float>(-85.456685407770465));
  p = add(mul(p, z), static_cast<float>(64.939390114297879));
  p = add(mul(p, z), static_cast<float>(-19.739208758219114));
  p = add(mul(p, z), static_cast<float>(0.99999999991936284));
  return p;
}

// sin(2 pi t) = cos(2 pi (t - 1/4)).
__device__ __forceinline__ float sin2pi(float t) {
  return cos2pi(sub(t, 0.25f));
}

// cos(u) and sin(u) for radian arguments of moderate size.
__device__ __forceinline__ float cosx(float u) {
  return cos2pi(mul(u, kInvTwoPiF));
}
__device__ __forceinline__ float sinx(float u) {
  return cos2pi(sub(mul(u, kInvTwoPiF), 0.25f));
}

template <class X>
__device__ __forceinline__ float sum_squares(const X& x, int dim) {
  float s = sq(x(0));
  for (int d = 1; d < dim; ++d) s = add(s, sq(x(d)));
  return s;
}

// The objectives that are a sum of per-dimension terms, split into the
// term of one coordinate and the step that closes the sum s = term(x_0) +
// ... + term(x_{D-1}) (added in that order), so that a kernel can fold the
// sum into its update loop (csrc/pso_fused.cu).  -0 is the identity of the
// sum: s = -0 + term(x_0) is term(x_0) bit for bit.
__device__ __forceinline__ float sphere_term(float v) { return sq(v); }
__device__ __forceinline__ float sphere_close(float s, int) { return s; }

__device__ __forceinline__ float rastrigin_term(float v) {
  return sub(sq(v), mul(10.0f, cos2pi(v)));
}
__device__ __forceinline__ float rastrigin_close(float s, int dim) {
  return add(static_cast<float>(10.0 * dim), s);
}

__device__ __forceinline__ float schwefel_term(float v) {
  return mul(v, sinx(__fsqrt_rn(fabsf(v))));
}
__device__ __forceinline__ float schwefel_close(float s, int dim) {
  return sub(static_cast<float>(418.9829 * dim), s);
}

__device__ __forceinline__ float styblinski_tang_term(float v) {
  return add(sub(sq(sq(v)), mul(mul(16.0f, v), v)), mul(5.0f, v));
}
__device__ __forceinline__ float styblinski_tang_close(float s, int dim) {
  return add(mul(0.5f, s), static_cast<float>(39.16616570377142 * dim));
}

template <class X>
__device__ float sphere(const X& x, int dim) {
  return sum_squares(x, dim);
}

template <class X>
__device__ float rastrigin(const X& x, int dim) {
  float s = 0.0f;
  for (int d = 0; d < dim; ++d) {
    const float term = rastrigin_term(x(d));
    s = d == 0 ? term : add(s, term);
  }
  return rastrigin_close(s, dim);
}

template <class X>
__device__ float ackley(const X& x, int dim) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int d = 0; d < dim; ++d) {
    const float v = x(d);
    s1 = d == 0 ? sq(v) : add(s1, sq(v));
    s2 = d == 0 ? cos2pi(v) : add(s2, cos2pi(v));
  }
  const float fd = static_cast<float>(dim);
  s1 = div(s1, fd);
  s2 = div(s2, fd);
  const float a = mul(-20.0f, expf(mul(-0.2f, __fsqrt_rn(s1))));
  return add(add(sub(a, expf(s2)), 20.0f), kEF);
}

template <class X>
__device__ float rosenbrock(const X& x, int dim) {
  float s = 0.0f;
  for (int d = 0; d + 1 < dim; ++d) {
    const float lo = x(d);
    const float a = sub(x(d + 1), sq(lo));
    const float b = sub(1.0f, lo);
    const float term = add(mul(mul(100.0f, a), a), sq(b));
    s = d == 0 ? term : add(s, term);
  }
  return s;
}

template <class X>
__device__ float griewank(const X& x, int dim) {
  float s = 0.0f, p = 1.0f;
  for (int d = 0; d < dim; ++d) {
    const float v = x(d);
    const float c = cosx(div(v, __fsqrt_rn(static_cast<float>(d + 1))));
    s = d == 0 ? sq(v) : add(s, sq(v));
    p = d == 0 ? c : mul(p, c);
  }
  return add(sub(div(s, 4000.0f), p), 1.0f);
}

template <class X>
__device__ float schwefel(const X& x, int dim) {
  float s = 0.0f;
  for (int d = 0; d < dim; ++d) {
    const float term = schwefel_term(x(d));
    s = d == 0 ? term : add(s, term);
  }
  return schwefel_close(s, dim);
}

__device__ __forceinline__ float levy_w(float v) {
  return add(1.0f, div(sub(v, 1.0f), 4.0f));
}

template <class X>
__device__ float levy(const X& x, int dim) {
  const float head = sq(sin2pi(mul(levy_w(x(0)), 0.5f)));  // sin(pi w)^2
  float mid = 0.0f;
  for (int d = 0; d + 1 < dim; ++d) {
    const float w = levy_w(x(d));
    const float s = sinx(add(mul(kPiF, w), 1.0f));
    const float term = mul(sq(sub(w, 1.0f)), add(1.0f, mul(10.0f, sq(s))));
    mid = d == 0 ? term : add(mid, term);
  }
  const float wd = levy_w(x(dim - 1));
  const float tail = mul(sq(sub(wd, 1.0f)), add(1.0f, sq(sin2pi(wd))));
  return add(add(head, mid), tail);
}

template <class X>
__device__ float zakharov(const X& x, int dim) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int d = 0; d < dim; ++d) {
    const float v = x(d);
    const float lin = mul(mul(0.5f, static_cast<float>(d + 1)), v);
    s1 = d == 0 ? sq(v) : add(s1, sq(v));
    s2 = d == 0 ? lin : add(s2, lin);
  }
  const float s2_2 = sq(s2);
  return add(add(s1, s2_2), sq(s2_2));
}

template <class X>
__device__ float styblinski_tang(const X& x, int dim) {
  float s = 0.0f;
  for (int d = 0; d < dim; ++d) {
    const float term = styblinski_tang_term(x(d));
    s = d == 0 ? term : add(s, term);
  }
  return styblinski_tang_close(s, dim);
}

// On the symmetric search domain [-pi/2, pi/2], shifted onto the canonical
// [0, pi].  The 20th power is the chain x^4 * x^16 of repeated squares.
template <class X>
__device__ float michalewicz(const X& x, int dim) {
  float s = 0.0f;
  for (int d = 0; d < dim; ++d) {
    const float v = add(x(d), kHalfPiF);
    const float phase =
        div(mul(mul(static_cast<float>(d + 1), v), v), kPiF);
    const float p4 = sq(sq(sinx(phase)));
    const float p16 = sq(sq(p4));
    const float term = mul(sinx(v), mul(p4, p16));
    s = d == 0 ? term : add(s, term);
  }
  return -s;
}

}  // namespace obj

// Objective `which` at the particle whose coordinates `x(0..dim-1)` gives.
// `which` is uniform over a launch, so the switch does not diverge.
template <class X>
__device__ float evaluate_objective(int which, const X& x, int dim) {
  switch (which) {
    case kSphere: return obj::sphere(x, dim);
    case kRastrigin: return obj::rastrigin(x, dim);
    case kAckley: return obj::ackley(x, dim);
    case kRosenbrock: return obj::rosenbrock(x, dim);
    case kGriewank: return obj::griewank(x, dim);
    case kSchwefel: return obj::schwefel(x, dim);
    case kLevy: return obj::levy(x, dim);
    case kZakharov: return obj::zakharov(x, dim);
    case kStyblinskiTang: return obj::styblinski_tang(x, dim);
    default: return obj::michalewicz(x, dim);
  }
}

// The objective of a launch, fixed at compile time (the kernels that are
// templates on it: pso_fused.cu, de_fused.cu, cuckoo_fused.cu).  kFold: a
// sum of per-dimension terms, which a kernel folds into its update loop
// (each term added as its coordinate moves, in ascending d, from -0, then
// closed); otherwise a second pass over the particle's coordinates.
template <int kObj>
struct ObjectiveOf {
  static constexpr bool kFold =
      kObj == kSphere || kObj == kRastrigin || kObj == kSchwefel
      || kObj == kStyblinskiTang;
  __device__ __forceinline__ static float term(float v) {
    switch (kObj) {
      case kSphere: return obj::sphere_term(v);
      case kRastrigin: return obj::rastrigin_term(v);
      case kSchwefel: return obj::schwefel_term(v);
      default: return obj::styblinski_tang_term(v);
    }
  }
  __device__ __forceinline__ static float close(float s, int dim) {
    switch (kObj) {
      case kSphere: return obj::sphere_close(s, dim);
      case kRastrigin: return obj::rastrigin_close(s, dim);
      case kSchwefel: return obj::schwefel_close(s, dim);
      default: return obj::styblinski_tang_close(s, dim);
    }
  }
  template <class X>
  __device__ __forceinline__ static float whole(const X& x, int dim) {
    return evaluate_objective(kObj, x, dim);
  }
};

}  // namespace dsa
