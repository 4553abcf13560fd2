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
// launch, 0.26 ms at 67 TFLOP/s: operations bound it.
//
// Design (rule 2's redesign).  One thread per bat.  The first version
// (0.96 ms a launch at that shape on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md) staged pos, vel and the candidate as three [D][block] tiles
// (46 KB a block of 128 at D = 30: 16 warps an SM), drew every group of four
// dimensions and every step's row with a plain philox4x32_10 call, masked
// every element with d < D, read the best column from global memory at
// every element, branched between the walk and the flight with the loads
// behind the branch, and evaluated the objective in a second pass behind a
// runtime switch.  Two variants now, which the wrapper's geometry picks
// (ops/cuda/bat_fused.py: bat_geometry) and the entry checks:
//
// Variant 0, no candidate tile (D <= 226; the main path).  A block of 128
// bats stages the best column and its bats' pos and vel, [D][128] each with
// the thread fastest (31 KB at D = 30: 7 blocks, 28 warps an SM), loops
// k_steps times over them and writes everything once:
//   - each step draws group 0 of the eps stream and the row with one
//     philox_pair_group call (streams 0 and 1 share their first rounds) and
//     groups 1 .. ceil(D / 4) - 1 of the eps stream with philox_one.cuh,
//     the lane's products once a launch and the step's once a step;
//   - templates on D mod 4 (the chunks of four run unmasked, the last D mod
//     4 dimensions are a chunk of their own), on the objective and on the
//     draws' source, so the step loop of the main path holds only what it
//     runs (chip_smoke.py's SASS census gives its issue floor);
//   - every element loads x, v and the staged best unconditionally and
//     computes both the walk and the flight, then selects: loads behind a
//     branch go out one at a time;
//   - no candidate: a sum of per-dimension terms (sphere, rastrigin,
//     schwefel, styblinski_tang) folds each candidate's term into the chunk
//     loop in ascending d from -0, the plain version's order; the other
//     objectives evaluate a column that rebuilds each candidate element from
//     the same operands (a walking bat draws each eps group again, once);
//     on acceptance the candidate and vel' are rebuilt the same way, a
//     walking bat redrawing its eps groups: the same operations on the same
//     operands, so the same bits.
//
// Variant 1, the first version (226 < D <= 605), kept as it was: three
// [D][block] tiles in dynamic shared memory, the block 128 threads where
// they fit, else 64, else 32.
//
// Above 48 KB of shared memory a block the entry opts in with
// cudaFuncSetAttribute.  The ragged edge of N leaves after the only
// barrier.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/bat_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox_one.cuh"
#include "philox_pair.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kLanes = 128;   // variant 0's block

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

// --------------------------------------------------------------------------
// Variant 0: no candidate tile.
// --------------------------------------------------------------------------

// Shared memory of a block: the best column (padded to four) and the
// bats' pos and vel, [D][128] each.
size_t staged_bytes(int dim) {
  return (2ull * dim * kLanes + ((dim + 3) & ~3)) * sizeof(float);
}

// One bat at one step: its columns in shared memory (stride kLanes), the
// staged best, and the step's frequency and gate.
struct Bat {
  float* x;
  float* v;
  const float* best;
  float freq, amp, hw;
  bool walk;
};

// The flight's velocity vel' = vel + (x - best) freq.
__device__ __forceinline__ float new_velocity(float x, float v, float b,
                                              float freq) {
  return add(v, mul(sub(x, b), freq));
}

// The candidate of one element: the walk and the flight both computed, then
// selected and clipped.
__device__ __forceinline__ float candidate(const Bat& bat, float x, float vn,
                                           float b, float u) {
  const float local = add(b, mul(bat.amp, sub(mul(2.0f, u), 1.0f)));
  const float fly = add(x, vn);
  return clip(bat.walk ? local : fly, bat.hw);
}

// The eps uniforms of chunk q: the operand's (kHost, one step) or the
// kernel's stream 0.
template <int kN, bool kHost>
__device__ __forceinline__ void eps_uniforms(const BatArgs& a,
                                             const dsa::PhiloxOneLane& pl,
                                             const dsa::PhiloxOneStep& ps,
                                             int lane, int q, float u[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      u[j] = a.r_eps[static_cast<size_t>(4 * q + j) * a.n + lane];
    }
  } else {
    const dsa::Philox4 w =
        dsa::philox_one_group(pl, ps, static_cast<uint32_t>(q));
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = dsa::uniform_from_bits(w.v[j]);
  }
}

// Chunk q of the candidate: each element's objective term into s.
template <int kN, class Obj>
__device__ __forceinline__ void candidate_chunk(const Bat& bat, int q,
                                                const float u[4], float& s) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float x = bat.x[d * kLanes];
    const float b = bat.best[d];
    const float vn = new_velocity(x, bat.v[d * kLanes], b, bat.freq);
    s = add(s, Obj::term(candidate(bat, x, vn, b, u[j])));
  }
}

// Chunk q of an accepted step: pos = the candidate, vel = vel'.
template <int kN>
__device__ __forceinline__ void accept_chunk(const Bat& bat, int q,
                                             const float u[4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float x = bat.x[d * kLanes];
    const float b = bat.best[d];
    const float vn = new_velocity(x, bat.v[d * kLanes], b, bat.freq);
    bat.x[d * kLanes] = candidate(bat, x, vn, b, u[j]);
    bat.v[d * kLanes] = vn;
  }
}

// The candidate's element d, rebuilt from its operands, for the objectives
// that are not a sum of per-dimension terms (evaluate_objective reads the
// elements in ascending order, so a walking bat draws each group once).
template <bool kHost>
struct Candidates {
  const float* r_eps;   // [D, N] (kHost)
  size_t n;
  Bat bat;
  dsa::PhiloxOneLane pl;
  dsa::PhiloxOneStep ps;
  int lane;
  mutable int group;
  mutable uint32_t w0, w1, w2, w3;
  __device__ __forceinline__ float operator()(int d) const {
    float u = 0.0f;
    if (bat.walk) {
      if constexpr (kHost) {
        u = r_eps[static_cast<size_t>(d) * n + lane];
      } else {
        if ((d >> 2) != group) {
          group = d >> 2;
          const dsa::Philox4 w =
              dsa::philox_one_group(pl, ps, static_cast<uint32_t>(group));
          w0 = w.v[0];
          w1 = w.v[1];
          w2 = w.v[2];
          w3 = w.v[3];
        }
        const uint32_t bits =
            (d & 2) ? ((d & 1) ? w3 : w2) : ((d & 1) ? w1 : w0);
        u = dsa::uniform_from_bits(bits);
      }
    }
    const float x = bat.x[d * kLanes];
    const float b = bat.best[d];
    return candidate(bat, x, new_velocity(x, bat.v[d * kLanes], b, bat.freq),
                     b, u);
  }
};

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kLanes) bat_step_kernel(const BatArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int dim = a.dim;
  float* s_best = smem;
  for (int e = t; e < dim; e += kLanes) s_best[e] = a.best[e];
  __syncthreads();   // the only barrier: the ragged edge may leave after it
  const long long lane_ll = static_cast<long long>(blockIdx.x) * kLanes + t;
  if (lane_ll >= a.n) return;
  const int lane = static_cast<int>(lane_ll);
  const size_t n = static_cast<size_t>(a.n);

  Bat bat;
  bat.x = smem + ((dim + 3) & ~3) + t;
  bat.v = bat.x + static_cast<size_t>(dim) * kLanes;
  bat.best = s_best;
  bat.amp = mul(a.local_scale, *a.mean_a);
  bat.hw = a.half_width;
  for (int d = 0; d < dim; ++d) {
    bat.x[d * kLanes] = a.pos[d * n + lane];
    bat.v[d * kLanes] = a.vel[d * n + lane];
  }
  float fit = a.fit[lane];
  float loud = a.loud[lane];
  float pulse = a.pulse[lane];
  const float t0 = static_cast<float>(a.scalars[1]);
  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const dsa::PhiloxPairLane pl =
      dsa::philox_pair_lane(static_cast<uint32_t>(lane));
  const dsa::PhiloxOneLane pl0 = dsa::philox_one_of_pair(pl, 0);
  const int full = dim >> 2;   // chunks of four; kR dimensions after them

  for (int step = 0; step < a.k_steps; ++step) {
    float u_beta, u_walk, u_acc;
    float u0[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // eps group 0 (device draws)
    dsa::PhiloxOneStep ps0{};
    if constexpr (kHost) {
      u_beta = a.r_beta[lane];
      u_walk = a.r_walk[lane];
      u_acc = a.r_acc[lane];
    } else {
      // Group 0 of the eps stream and the row: one call for both streams.
      const dsa::PhiloxPairStep ps = dsa::philox_pair_step(
          pl, a.step0 + static_cast<uint32_t>(step), seed);
      dsa::Philox4 w[2];
      dsa::philox_pair_group(pl, ps, 0u, w);
      u_beta = dsa::uniform_from_bits(w[1].v[0]);
      u_walk = dsa::uniform_from_bits(w[1].v[1]);
      u_acc = dsa::uniform_from_bits(w[1].v[2]);
#pragma unroll
      for (int j = 0; j < 4; ++j) u0[j] = dsa::uniform_from_bits(w[0].v[j]);
      ps0 = dsa::philox_one_of_pair(ps, 0);
    }
    bat.freq = add(a.f_min, mul(a.f_span, u_beta));
    bat.walk = u_walk > pulse;

    float cfit;
    if constexpr (Obj::kFold) {
      float s = -0.0f;
      float u[4];
      if (full > 0) {
        if constexpr (kHost) {
          eps_uniforms<4, true>(a, pl0, ps0, lane, 0, u);
          candidate_chunk<4, Obj>(bat, 0, u, s);
        } else {
          candidate_chunk<4, Obj>(bat, 0, u0, s);
        }
#pragma unroll 1
        for (int q = 1; q < full; ++q) {
          eps_uniforms<4, kHost>(a, pl0, ps0, lane, q, u);
          candidate_chunk<4, Obj>(bat, q, u, s);
        }
      }
      if constexpr (kR != 0) {
        if constexpr (kHost) {
          eps_uniforms<kR, true>(a, pl0, ps0, lane, full, u);
        } else if (full == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) u[j] = u0[j];
        } else {
          eps_uniforms<kR, false>(a, pl0, ps0, lane, full, u);
        }
        candidate_chunk<kR, Obj>(bat, full, u, s);
      }
      cfit = Obj::close(s, dim);
    } else {
      // The column draws group 0 again (group -1: none drawn yet).
      const Candidates<kHost> c{a.r_eps, n,  bat, pl0, ps0,
                                lane,    -1, 0u,  0u,  0u, 0u};
      cfit = Obj::whole(c, dim);
    }

    if (cfit <= fit && u_acc < loud) {
      // The candidate and vel' again, from the same operands; a walking
      // bat draws its eps groups again.
      float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
      for (int q = 0; q < full; ++q) {
        if (bat.walk) eps_uniforms<4, kHost>(a, pl0, ps0, lane, q, u);
        accept_chunk<4>(bat, q, u);
      }
      if constexpr (kR != 0) {
        if (bat.walk) eps_uniforms<kR, kHost>(a, pl0, ps0, lane, full, u);
        accept_chunk<kR>(bat, full, u);
      }
      fit = cfit;
      loud = mul(loud, a.alpha);
      const float tf = add(t0, static_cast<float>(step + 1));
      pulse = mul(a.r0, sub(1.0f, expf(mul(a.neg_gamma, tf))));
    }
  }

  for (int d = 0; d < dim; ++d) {
    const size_t at = d * n + lane;
    a.pos_out[at] = bat.x[d * kLanes];
    a.vel_out[at] = bat.v[d * kLanes];
  }
  a.fit_out[lane] = fit;
  a.loud_out[lane] = loud;
  a.pulse_out[lane] = pulse;
}

// --------------------------------------------------------------------------
// Variant 1: the first version, a candidate tile beside pos and vel.
// --------------------------------------------------------------------------

__global__ void bat_cand_tile_kernel(const BatArgs a) {
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

// Variant 1's threads per block: the largest of 128, 64, 32 whose three
// tiles fit, or 0 (D > 605): the kernel's envelope.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (3ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

cudaError_t allow_shared(const void* kernel, size_t shared) {
  if (shared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shared));
}

template <int kR, int kObj, bool kHost>
cudaError_t launch_staged(const BatArgs& a, size_t shared, cudaStream_t s) {
  auto* kernel = bat_step_kernel<kR, kObj, kHost>;
  const cudaError_t err =
      allow_shared(reinterpret_cast<const void*>(kernel), shared);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (static_cast<unsigned>(a.n) + kLanes - 1) / kLanes;
  kernel<<<blocks, kLanes, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const BatArgs& a, size_t shared, cudaStream_t s) {
  return a.r_beta != nullptr ? launch_staged<kR, kObj, true>(a, shared, s)
                             : launch_staged<kR, kObj, false>(a, shared, s);
}

template <int kR>
cudaError_t launch_objective(const BatArgs& a, size_t shared,
                             cudaStream_t s) {
#define DSA_BAT_CASE(k) \
  case dsa::k:          \
    return launch_source<kR, dsa::k>(a, shared, s);
  switch (a.objective) {
    DSA_BAT_CASE(kSphere)
    DSA_BAT_CASE(kRastrigin)
    DSA_BAT_CASE(kAckley)
    DSA_BAT_CASE(kRosenbrock)
    DSA_BAT_CASE(kGriewank)
    DSA_BAT_CASE(kSchwefel)
    DSA_BAT_CASE(kLevy)
    DSA_BAT_CASE(kZakharov)
    DSA_BAT_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, shared, s);
  }
#undef DSA_BAT_CASE
}

// Whether the entry runs `variant` with blocks of `lanes` bats and `shared`
// bytes at this D: variant 0 needs blocks of 128 and exactly its staged
// bytes within a block's shared memory; variant 1 the first version's block
// and tiles.
bool geometry_ok(int variant, int lanes, int shared, int dim) {
  if (variant == 0) {
    return lanes == kLanes &&
           static_cast<size_t>(shared) == staged_bytes(dim) &&
           static_cast<size_t>(shared) <= kMaxSharedBytes;
  }
  return variant == 1 && lanes != 0 && lanes == pick_block(dim) &&
         static_cast<size_t>(shared) == 3ull * dim * lanes * sizeof(float);
}

// The words the main kernel draws for (lane, group g, step, seed): the eps
// stream's group g (from the pair call for g = 0, else from philox_one.cuh
// on the pair's hoisted products) and the row (stream 1, group 0), beside
// philox4x32_10's.
__global__ void philox_check_kernel(const uint32_t* lanes,
                                    const uint32_t* gs, const uint32_t* ctrs,
                                    const uint32_t* seeds, int n,
                                    uint32_t* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const dsa::PhiloxPairLane pl = dsa::philox_pair_lane(lanes[e]);
  const dsa::PhiloxPairStep ps = dsa::philox_pair_step(pl, ctrs[e], seeds[e]);
  dsa::Philox4 w[2];
  dsa::philox_pair_group(pl, ps, 0u, w);
  const dsa::Philox4 eps =
      gs[e] == 0u ? w[0]
                  : dsa::philox_one_group(dsa::philox_one_of_pair(pl, 0),
                                          dsa::philox_one_of_pair(ps, 0),
                                          gs[e]);
  const dsa::Philox4 r_eps =
      dsa::philox4x32_10(lanes[e], gs[e], ctrs[e], 0u, seeds[e], 0u);
  const dsa::Philox4 r_row =
      dsa::philox4x32_10(lanes[e], 0u, ctrs[e], 1u, seeds[e], 0u);
  uint32_t* o = out + static_cast<size_t>(e) * 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = eps.v[j];
    o[4 + j] = w[1].v[j];
    o[8 + j] = r_eps.v[j];
    o[12 + j] = r_row.v[j];
  }
}

}  // namespace

// Variant 1's threads per block for `dim` (0: outside the envelope).
extern "C" int dsa_bat_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: best [D], mean_a [1], pos/vel
// [D, N], fit/loud/pulse [N], the draws r_beta/r_walk/r_acc [N] and r_eps
// [D, N] (all four or none), the outputs like the inputs; scalars [2] i32
// (seed, block-start iteration).  The geometry (variant, lanes a block,
// shared bytes a block) is the wrapper's (bat_geometry); one this entry
// cannot run is refused.  Launched on `stream` without synchronising.
// Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_bat_fused_f32(
    const int* scalars, const float* best, const float* mean_a,
    const float* pos, const float* vel, const float* fit, const float* loud,
    const float* pulse, const float* r_beta, const float* r_walk,
    const float* r_eps, const float* r_acc, float* pos_out, float* vel_out,
    float* fit_out, float* loud_out, float* pulse_out, int n, int dim,
    int k_steps, unsigned step0, int objective, float f_min, float f_span,
    float local_scale, float alpha, float neg_gamma, float r0,
    float half_width, int variant, int lanes, int shared, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool some = r_beta || r_walk || r_eps || r_acc;
  const bool all = r_beta && r_walk && r_eps && r_acc;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || some != all ||
      (all && k_steps != 1) || !geometry_ok(variant, lanes, shared, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BatArgs a{scalars, best, mean_a, pos, vel, fit, loud, pulse,
                  r_beta, r_walk, r_eps, r_acc, pos_out, vel_out, fit_out,
                  loud_out, pulse_out, n, dim, k_steps, step0, objective,
                  f_min, f_span, local_scale, alpha, neg_gamma, r0,
                  half_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, shared, s); break;
      case 1: err = launch_objective<1>(a, shared, s); break;
      case 2: err = launch_objective<2>(a, shared, s); break;
      default: err = launch_objective<3>(a, shared, s);
    }
  } else {
    err = allow_shared(reinterpret_cast<const void*>(bat_cand_tile_kernel),
                       shared);
    if (err == cudaSuccess) {
      const unsigned blocks = (static_cast<unsigned>(n) + lanes - 1) / lanes;
      bat_cand_tile_kernel<<<blocks, lanes, shared, s>>>(a);
      err = cudaGetLastError();
    }
  }
  // A refused call leaves its error pending: clear it, so that the next
  // launch does not report it as its own.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The words of the main kernel's hoisted draws beside philox4x32_10's, for
// n counters (lane, group, step) and seeds: out [n, 16], the eps stream's
// group and the row as drawn, then as philox4x32_10 draws them.
extern "C" int dsa_bat_philox_check(const unsigned* lanes, const unsigned* gs,
                                    const unsigned* ctrs,
                                    const unsigned* seeds, int n,
                                    unsigned* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  philox_check_kernel<<<(n + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lanes, gs, ctrs, seeds, n, out);
  return static_cast<int>(cudaGetLastError());
}
