// Fused bat-algorithm steps for Hopper (sm_90a): k generations of the
// whole colony in one pass.
//
// dsa_bat_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/bat_fused.py:fused_bat_step_t
//   (body _make_kernel).
//
// What one launch computes, for arrays in the transposed layout [D, N]
// (bats along the fast axis) and the rows fit, loud, pulse [N], k_steps
// times:
//
//   beta, u_walk, u_acc = three uniforms per bat, eps = 2 u - 1 per element
//   freq = f_min + (f_max - f_min) beta
//   vel' = vel + (pos - best) freq;  cand = pos + vel'
//   where u_walk > pulse: cand = best + (sigma_local half_width mean_a) eps
//   cand clipped to +-half_width;  cfit = objective(cand)
//   accept = cfit <= fit and u_acc < loud; where accepted:
//     pos = cand, vel = vel', fit = cfit, loud = alpha loud,
//     pulse = r0 (1 - exp(-gamma tf)), tf = t0 + step + 1
//
// with the incumbent best and the colony's mean loudness held fixed over
// the launch (the wrapper's caller refreshes both between launches), and
// t0, the iteration at the launch's start, read from the device.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed.  eps takes
// stream 0 with the counter (lane, block of four dimensions, global step,
// 0); beta, u_walk and u_acc are words 0, 1 and 2 of one call with the
// counter (lane, 0, global step, 1).  No launch geometry enters, so the
// plain PyTorch version draws the same numbers.  With the draws given as
// operands the kernel reads them instead (one step only), which is how
// tests feed this kernel and the TPU kernel the same numbers.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction
// (see swarm_objectives.cuh); the pulse calls expf, as torch.exp does on the
// card.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin.  Bytes:
// pos and vel read and written once, fit, loud and pulse likewise: 8 (2 D +
// 3) N bytes, 0.53 GB, 0.16 ms at 3.35 TB/s.  Operations per element and
// step: a quarter of a Philox call with the eps uniform and its map (30),
// the walk and the flight with their select and clip (9), rastrigin (23),
// the pos and vel selects (2): 64; per bat and step 134 (the row call and
// its three uniforms, the tests, the loudness and the pulse); 1.7e10 a
// launch, 0.26 ms at 67 TFLOP/s: operations bound it.  Measured at that
// shape on an NVIDIA H100 80GB HBM3 at 700 W: 0.96 ms a launch, 3.7 times
// the bound (PERF.md).
//
// Design (first, simple version).  One thread per bat, as B5: a block
// stages its bats' pos, vel and cand in dynamic shared memory as
// [3][D][block] with the thread index fastest (a thread owns a column, so
// no bank conflicts and no barriers), loops k_steps times over it and
// writes everything once.  vel' is recomputed on accept rather than
// stored.  The block is 128 threads where 3 D 128 floats fit the 227 KB a
// block may take, else 64, else 32 (D <= 605); above 48 KB the entry opts
// in with cudaFuncSetAttribute.  The ragged edge is masked.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/bat_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;

struct BatArgs {
  const int* scalars;     // [2] i32 on the device: seed, block-start iteration
  const float* best;      // [D]
  const float* mean_a;    // [1]
  const float* pos;       // [D, N]
  const float* vel;       // [D, N]
  const float* fit;       // [N]
  const float* loud;      // [N]
  const float* pulse;     // [N]
  const float* r_beta;    // [N] or null: draw in the kernel
  const float* r_walk;    // [N]
  const float* r_eps;     // [D, N] in [0, 1)
  const float* r_acc;     // [N]
  float* pos_out;
  float* vel_out;
  float* fit_out;
  float* loud_out;
  float* pulse_out;
  int n;
  int dim;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float f_min, f_span, local_scale, alpha, neg_gamma, r0, half_width;
};

struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ float clip(float v, float hw) {
  return fminf(fmaxf(v, -hw), hw);
}

__global__ void bat_fused_kernel(const BatArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  float* s_vel = s_pos + static_cast<size_t>(dim) * block;
  float* s_cand = s_vel + static_cast<size_t>(dim) * block;

  for (int d = 0; d < dim; ++d) {
    const size_t at = d * n + lane;
    s_pos[d * block] = a.pos[at];
    s_vel[d * block] = a.vel[at];
  }
  float fit = a.fit[lane];
  float loud = a.loud[lane];
  float pulse = a.pulse[lane];
  const float local_amp = mul(a.local_scale, *a.mean_a);
  const float t0 = static_cast<float>(a.scalars[1]);
  const bool host_rng = a.r_beta != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    float u_beta, u_walk, u_acc;
    if (host_rng) {
      u_beta = a.r_beta[lane];
      u_walk = a.r_walk[lane];
      u_acc = a.r_acc[lane];
    } else {
      const dsa::Philox4 rows = dsa::philox4x32_10(
          static_cast<uint32_t>(lane), 0u, ctr, 1u, seed, 0u);
      u_beta = dsa::uniform_from_bits(rows.v[0]);
      u_walk = dsa::uniform_from_bits(rows.v[1]);
      u_acc = dsa::uniform_from_bits(rows.v[2]);
    }
    const float freq = add(a.f_min, mul(a.f_span, u_beta));
    const bool walk = u_walk > pulse;

    for (int d0 = 0; d0 < dim; d0 += 4) {
      float ue[4];
      if (host_rng) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ue[j] = d0 + j < dim ? a.r_eps[(d0 + j) * n + lane] : 0.0f;
        }
      } else {
        const dsa::Philox4 e = dsa::philox4x32_10(
            static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2), ctr,
            0u, seed, 0u);
#pragma unroll
        for (int j = 0; j < 4; ++j) ue[j] = dsa::uniform_from_bits(e.v[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + j;
        if (d < dim) {
          const float b = a.best[d];
          float c;
          if (walk) {
            c = add(b, mul(local_amp, sub(mul(2.0f, ue[j]), 1.0f)));
          } else {
            const float x = s_pos[d * block];
            c = add(x, add(s_vel[d * block], mul(sub(x, b), freq)));
          }
          s_cand[d * block] = clip(c, a.half_width);
        }
      }
    }
    const float cfit =
        dsa::evaluate_objective(a.objective, Column{s_cand, block}, dim);
    if (cfit <= fit && u_acc < loud) {
      for (int d = 0; d < dim; ++d) {
        const float x = s_pos[d * block];
        s_vel[d * block] = add(s_vel[d * block], mul(sub(x, a.best[d]), freq));
        s_pos[d * block] = s_cand[d * block];
      }
      fit = cfit;
      loud = mul(loud, a.alpha);
      const float tf = add(t0, static_cast<float>(step + 1));
      pulse = mul(a.r0, sub(1.0f, expf(mul(a.neg_gamma, tf))));
    }
  }

  for (int d = 0; d < dim; ++d) {
    const size_t at = d * n + lane;
    a.pos_out[at] = s_pos[d * block];
    a.vel_out[at] = s_vel[d * block];
  }
  a.fit_out[lane] = fit;
  a.loud_out[lane] = loud;
  a.pulse_out[lane] = pulse;
}

// Threads per block: the largest of 128, 64, 32 whose tile fits, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (3ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_bat_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: best [D], mean_a [1], pos/vel
// [D, N], fit/loud/pulse [N], the draws r_beta/r_walk/r_acc [N] and r_eps
// [D, N] (all four or none), the outputs like the inputs; scalars [2] i32
// (seed, block-start iteration).  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_bat_fused_f32(
    const int* scalars, const float* best, const float* mean_a,
    const float* pos, const float* vel, const float* fit, const float* loud,
    const float* pulse, const float* r_beta, const float* r_walk,
    const float* r_eps, const float* r_acc, float* pos_out, float* vel_out,
    float* fit_out, float* loud_out, float* pulse_out, int n, int dim,
    int k_steps, unsigned step0, int objective, float f_min, float f_span,
    float local_scale, float alpha, float neg_gamma, float r0,
    float half_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  const bool some = r_beta || r_walk || r_eps || r_acc;
  const bool all = r_beta && r_walk && r_eps && r_acc;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || block == 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || some != all ||
      (all && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BatArgs a{scalars, best, mean_a, pos, vel, fit, loud, pulse,
                  r_beta, r_walk, r_eps, r_acc, pos_out, vel_out, fit_out,
                  loud_out, pulse_out, n, dim, k_steps, step0, objective,
                  f_min, f_span, local_scale, alpha, neg_gamma, r0,
                  half_width};
  const size_t shared = 3ull * dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(bat_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  bat_fused_kernel<<<blocks, block, shared,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
