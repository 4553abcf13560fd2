// Fused moth-flame iterations for Hopper (sm_90a): k spiral flights in one
// pass, each flame updated in place by its own moth at every step.
//
// dsa_mfo_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/mfo_fused.py:fused_mfo_step_t
//   (body _make_kernel).
//
// What one launch computes, for the moths and the flames in the transposed
// layout [D, N], k_steps times, for the moth in global column j:
//
//   l     = u (1 - r_lo) + r_lo,   r_lo = scalars[2] / 65536  (per element)
//   flame = j < n_flames ? flames[:, j] : last       (last fixed per launch)
//   x     = clip(|flame - x| 2^(b l log2 e) cos(2 pi l) + flame, +-hw)
//   mfit  = f(x);  if mfit < flame_fit[j]: flames[:, j], flame_fit[j] = x,
//   mfit
//
// and the outputs are the moths, their last fitness, the flames and their
// fitness.  n_flames and r_lo are read from the device.  The pairing is
// positional, so lanes are independent.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; u is
// stream 0 over the dimensions, counter (lane, block of four dimensions,
// global step, 0).  With r_l given as an operand (one step only) the kernel
// reads it instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no
// contraction; 2^x is fast_math.cuh's exp2_fast and cos 2 pi l the
// objectives header's polynomial, so kernel and plain version agree bit for
// bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin.
// Bytes: moths, flames and flame fitness read once, the four outputs
// written once: 4 (4 D + 3) N + 4 D bytes, 0.52 GB, 0.154 ms at 3.35 TB/s.
// Operations per element and step: the draw (28), l (3), the flame select
// (1), |flame - x| (2), 2^(b l log2 e) (20), cos 2 pi l (17), the spiral
// and the clip (5), rastrigin (23), the flame update (2): 101; per moth and
// step 3 (the own test, the flame fitness test and select); 2.5e10 a
// launch, 0.38 ms at 67 TFLOP/s: operations bound it.
//
// Design (first, simple version).  One thread per moth: a block stages its
// moths and their flames in dynamic shared memory as two [D][block] tiles,
// the thread index fastest (no bank conflicts, no barriers); the clamp
// flame is read from global memory (the same [D] for every thread).  The
// outputs are written out of place.  The block is 128 threads where the
// two tiles fit the 227 KB a block may take, else 64, else 32 (D <= 908).
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/mfo_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;

struct MfoArgs {
  const int* scalars;     // [3] i32: seed, n_flames, r_lo in 16.16
  const float* last;      // [D] the clamp flame
  const float* pos;       // [D, N]
  const float* flames;    // [D, N]
  const float* flame_fit; // [N]
  const float* r_l;       // [D, N] or null: draw in the kernel
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  float* flames_out;      // [D, N]
  float* flame_fit_out;   // [N]
  int n;
  int dim;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float b, half_width;
};

struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::fast::exp2_fast;
using dsa::obj::add;
using dsa::obj::div;
using dsa::obj::mul;
using dsa::obj::sub;

__global__ void mfo_fused_kernel(const MfoArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  float* s_flame = smem + static_cast<size_t>(dim) * block + t;
  for (int d = 0; d < dim; ++d) {
    s_pos[d * block] = a.pos[d * n + lane];
    s_flame[d * block] = a.flames[d * n + lane];
  }
  float ffit = a.flame_fit[lane];
  float mfit = 0.0f;

  const bool host_rng = a.r_l != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const bool own = lane < a.scalars[1];
  const float r_lo = div(static_cast<float>(a.scalars[2]), 65536.0f);
  const float span = sub(1.0f, r_lo);
  const float log2e = static_cast<float>(1.4426950408889634);

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    for (int d0 = 0; d0 < dim; d0 += 4) {
      float u[4];
      if (host_rng) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = d0 + q < dim ? a.r_l[(d0 + q) * n + lane] : 0.0f;
        }
      } else {
        const dsa::Philox4 p = dsa::philox4x32_10(
            static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2), ctr,
            0u, seed, 0u);
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = dsa::uniform_from_bits(p.v[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + q;
        if (d < dim) {
          const float l = add(mul(u[q], span), r_lo);
          const float flame = own ? s_flame[d * block] : a.last[d];
          const float dist = fabsf(sub(flame, s_pos[d * block]));
          const float v = add(
              mul(mul(dist, exp2_fast(mul(mul(a.b, l), log2e))),
                  dsa::obj::cos2pi(l)),
              flame);
          s_pos[d * block] = fminf(fmaxf(v, -a.half_width), a.half_width);
        }
      }
    }
    mfit = dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
    if (mfit < ffit) {
      ffit = mfit;
      for (int d = 0; d < dim; ++d) s_flame[d * block] = s_pos[d * block];
    }
  }

  for (int d = 0; d < dim; ++d) {
    a.pos_out[d * n + lane] = s_pos[d * block];
    a.flames_out[d * n + lane] = s_flame[d * block];
  }
  a.fit_out[lane] = mfit;
  a.flame_fit_out[lane] = ffit;
}

// Threads per block: the largest of 128, 64, 32 whose two tiles fit, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (2ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_mfo_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: last [D], pos and flames [D, N],
// flame_fit [N], the draw r_l [D, N] (or null), pos_out and flames_out
// [D, N], fit_out and flame_fit_out [N]; scalars [3] i32 (seed, n_flames,
// r_lo in 16.16 fixed point).  N is a multiple of tile_n (the kernel does
// not depend on the tile).  Launched on `stream` without synchronising.
// Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_mfo_fused_f32(
    const int* scalars, const float* last, const float* pos,
    const float* flames, const float* flame_fit, const float* r_l,
    float* pos_out, float* fit_out, float* flames_out, float* flame_fit_out,
    int n, int dim, int tile_n, int k_steps, unsigned step0, int objective,
    float b, float half_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || block == 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      (r_l && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MfoArgs a{scalars, last, pos, flames, flame_fit, r_l, pos_out,
                  fit_out, flames_out, flame_fit_out, n, dim, k_steps, step0,
                  objective, b, half_width};
  const size_t shared = 2ull * dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(mfo_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  mfo_fused_kernel<<<blocks, block, shared,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
