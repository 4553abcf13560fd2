// Fused particle-swarm steps for Hopper (sm_90a): k PSO iterations in one
// pass over the swarm, for one swarm and for a stack of islands.
//
// dsa_pso_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/pso_fused.py:fused_pso_step_t
//   (body _make_kernel),
// dsa_islands_fused_f32 replaces
//   distributed_swarm_algorithm_tpu/ops/pallas/islands_fused.py:
//   _islands_step_t,
// which runs the same body over all islands' particles laid side by side,
// each particle reading its own island's best.  Both entries launch one
// kernel template; the island flag only picks the column of `gbest`.
//
// What one launch computes, for arrays in the transposed layout [D, N]
// (particles along the fast axis), k_steps times:
//
//   r1, r2 = two uniforms per element
//   vel = w vel + (c1 r1)(bpos - pos) + (c2 r2)(g - pos), clamped to +-vmax
//   pos = pos + vel, clipped to +-half_width
//   fit = objective(pos)
//   where fit < bfit: bfit = fit, bpos = pos
//
// with g held fixed over the launch (the swarm's or the island's best at
// its start), and optionally each block's best (bfit, lane) candidate, which
// the wrapper reduces to the swarm's.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed, with the
// counter (lane, block of four dimensions, global step index, stream), the
// stream being 0 for r1 and 1 for r2.  Nothing of the launch geometry
// enters, so the plain PyTorch version draws the same numbers and the two
// are comparable over a whole launch.  With r1/r2 given as operands the
// kernel reads them instead (one step only), which is how tests feed this
// kernel and the TPU kernel the same numbers.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction
// (see swarm_objectives.cuh), so kernel and plain version take the same
// `fit < bfit` decisions.
//
// Bound on this card.  Bytes: pos, vel, bpos and bfit read once and written
// once per launch, 8 (3 D + 1) N bytes: 0.76 GB at N = 1,048,576, D = 30,
// 0.23 ms at 3.35 TB/s, whatever k_steps is.  Operations per element and
// step: 2 Philox calls per 4 elements (10 rounds of 4 multiplies and 6
// adds or xors each, 50 per element), 6 to make the two uniforms, 14 for
// the update with its clamps, and the objective (rastrigin: 23): 93.  At
// k_steps = 64 that is 1.9e11 operations, 2.8 ms at the f32 peak of
// 67 TFLOP/s: operations bound it from k_steps of about 6 up, and the Philox
// rounds are more than half of them.  Measured at that shape on an NVIDIA
// H100 80GB HBM3 at 700 W: 7.8 ms a launch, 2.8 times the bound (PERF.md).
//
// Design (first, simple version).  One thread per particle.  A block stages
// its particles' pos, vel and bpos once in dynamic shared memory as
// [3][D][block] with the thread index fastest (a thread owns a column, so
// there are no bank conflicts and no barriers), loops k_steps times over
// it, and writes everything once.  The block is 128 threads where
// 3 D 128 floats fit the 227 KB a block may take, else 64, else 32 (the
// entry picks; D <= 605).  Above 48 KB the entry opts in with
// cudaFuncSetAttribute.  The ragged edge is masked in the kernel, so N
// needs no padding.  Not done yet: more than one generator call in flight
// per thread, keeping the column in registers for small D, and a cheaper
// generator (fewer rounds, or 16-bit uniforms from one call).
//
// Built with nvcc for sm_90a into a shared library with plain C entries
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/pso_fused.py,
// ops/cuda/islands_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

// Shared memory one block may take on sm_90 (232,448 bytes).
constexpr size_t kMaxSharedBytes = 227 * 1024;

struct PsoArgs {
  const int* seed;        // [1] i32 on the device
  const float* gbest;     // [D] or [D, n_islands]
  const float* pos;       // [D, N]
  const float* vel;
  const float* bpos;
  const float* bfit;      // [N]
  const float* r1;        // [D, N] or null: draw in the kernel
  const float* r2;
  float* pos_out;
  float* vel_out;
  float* bpos_out;
  float* bfit_out;
  float* block_fit;       // [blocks] or null: no candidates
  int* block_lane;        // [blocks]
  int n;
  int dim;
  int n_islands;          // columns of gbest (island kernel)
  int lanes_per_island;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float w, c1, c2, vmax, half_width;
};

// One particle's coordinates in the staged tile: element d at p[d * stride].
struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

__device__ __forceinline__ bool better(float fit, int lane, float other_fit,
                                       int other_lane) {
  return fit < other_fit || (fit == other_fit && lane < other_lane);
}

template <bool kIslands>
__global__ void pso_fused_kernel(const PsoArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  const bool live = lane_ll < a.n;
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  float* s_pos = smem + t;
  float* s_vel = s_pos + static_cast<size_t>(dim) * block;
  float* s_bpos = s_vel + static_cast<size_t>(dim) * block;

  float bfit = __int_as_float(0x7f800000);  // +inf for the masked edge
  if (live) {
    const size_t n = static_cast<size_t>(a.n);
    for (int d = 0; d < dim; ++d) {
      const size_t at = d * n + lane;
      s_pos[d * block] = a.pos[at];
      s_vel[d * block] = a.vel[at];
      s_bpos[d * block] = a.bpos[at];
    }
    bfit = a.bfit[lane];
    const int g_stride = kIslands ? a.n_islands : 1;
    const float* g = a.gbest + (kIslands ? lane / a.lanes_per_island : 0);
    const bool host_rng = a.r1 != nullptr;
    const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(*a.seed);

    for (int step = 0; step < a.k_steps; ++step) {
      for (int d0 = 0; d0 < dim; d0 += 4) {
        float r1[4], r2[4];
        if (host_rng) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = d0 + j < dim;
            r1[j] = in ? a.r1[(d0 + j) * n + lane] : 0.0f;
            r2[j] = in ? a.r2[(d0 + j) * n + lane] : 0.0f;
          }
        } else {
          const uint32_t c1 = static_cast<uint32_t>(d0 >> 2);
          const uint32_t c2 = a.step0 + static_cast<uint32_t>(step);
          const dsa::Philox4 u1 = dsa::philox4x32_10(
              static_cast<uint32_t>(lane), c1, c2, 0u, seed, 0u);
          const dsa::Philox4 u2 = dsa::philox4x32_10(
              static_cast<uint32_t>(lane), c1, c2, 1u, seed, 0u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            r1[j] = dsa::uniform_from_bits(u1.v[j]);
            r2[j] = dsa::uniform_from_bits(u2.v[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + j;
          if (d < dim) {
            const float x = s_pos[d * block];
            const float b = s_bpos[d * block];
            const float gd = g[d * g_stride];
            float v = __fadd_rn(
                __fadd_rn(__fmul_rn(a.w, s_vel[d * block]),
                          __fmul_rn(__fmul_rn(a.c1, r1[j]), __fsub_rn(b, x))),
                __fmul_rn(__fmul_rn(a.c2, r2[j]), __fsub_rn(gd, x)));
            v = fminf(fmaxf(v, -a.vmax), a.vmax);
            s_vel[d * block] = v;
            s_pos[d * block] =
                fminf(fmaxf(__fadd_rn(x, v), -a.half_width), a.half_width);
          }
        }
      }
      const float fit =
          dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
      if (fit < bfit) {
        bfit = fit;
        for (int d = 0; d < dim; ++d) s_bpos[d * block] = s_pos[d * block];
      }
    }

    for (int d = 0; d < dim; ++d) {
      const size_t at = d * n + lane;
      a.pos_out[at] = s_pos[d * block];
      a.vel_out[at] = s_vel[d * block];
      a.bpos_out[at] = s_bpos[d * block];
    }
    a.bfit_out[lane] = bfit;
  }

  if (a.block_fit == nullptr) return;  // uniform over the launch
  // The block's best pbest: lowest fitness, lowest lane among equals.
  __shared__ float w_fit[32];
  __shared__ int w_lane[32];
  float best = bfit;
  int best_lane = live ? lane : 0x7fffffff;
  for (int off = 16; off > 0; off >>= 1) {
    const float of = __shfl_down_sync(0xffffffffu, best, off);
    const int ol = __shfl_down_sync(0xffffffffu, best_lane, off);
    if (better(of, ol, best, best_lane)) {
      best = of;
      best_lane = ol;
    }
  }
  if ((t & 31) == 0) {
    w_fit[t >> 5] = best;
    w_lane[t >> 5] = best_lane;
  }
  __syncthreads();
  if (t == 0) {
    for (int wi = 1; wi < (block >> 5); ++wi) {
      if (better(w_fit[wi], w_lane[wi], best, best_lane)) {
        best = w_fit[wi];
        best_lane = w_lane[wi];
      }
    }
    a.block_fit[blockIdx.x] = best;
    a.block_lane[blockIdx.x] = best_lane;
  }
}

// Threads per block: the largest of 128, 64, 32 whose tile fits, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (3ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

template <bool kIslands>
int launch(const PsoArgs& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(a.dim);
  if (a.n <= 0 || a.dim <= 0 || a.k_steps <= 0 || block == 0 ||
      a.objective < 0 || a.objective >= dsa::kObjectiveCount ||
      (kIslands && (a.n_islands <= 0 || a.lanes_per_island <= 0)) ||
      ((a.r1 == nullptr) != (a.r2 == nullptr)) ||
      (a.r1 != nullptr && a.k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = 3ull * a.dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(pso_fused_kernel<kIslands>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(a.n) + block - 1) / block;
  pso_fused_kernel<kIslands><<<blocks, block, shared,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Threads per block the entries use for `dim` (0: outside the envelope), so
// that the wrapper sizes the candidate arrays and states the envelope.
extern "C" int dsa_pso_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: gbest [D], pos/vel/bpos [D, N],
// bfit [N], r1/r2 [D, N] or null, the outputs like the inputs, block_fit /
// block_lane [ceil(N / block)] or null; seed [1] i32.  Launched on `stream`
// without synchronising.  Returns the CUDA error of the launch (0 when
// accepted).
extern "C" int dsa_pso_fused_f32(
    const int* seed, const float* gbest, const float* pos, const float* vel,
    const float* bpos, const float* bfit, const float* r1, const float* r2,
    float* pos_out, float* vel_out, float* bpos_out, float* bfit_out,
    float* block_fit, int* block_lane, int n, int dim, int k_steps,
    unsigned step0, int objective, float w, float c1, float c2, float vmax,
    float half_width, int device, void* stream) {
  const PsoArgs a{seed, gbest, pos, vel, bpos, bfit, r1, r2, pos_out, vel_out,
                  bpos_out, bfit_out, block_fit, block_lane, n, dim, 1, n,
                  k_steps, step0, objective, w, c1, c2, vmax, half_width};
  return launch<false>(a, device, stream);
}

// The same over n_islands islands of lanes_per_island particles each, laid
// side by side (N = n_islands * lanes_per_island): gbest is [D, n_islands]
// and lane l reads column l / lanes_per_island.  No candidates.
extern "C" int dsa_islands_fused_f32(
    const int* seed, const float* gbest, const float* pos, const float* vel,
    const float* bpos, const float* bfit, const float* r1, const float* r2,
    float* pos_out, float* vel_out, float* bpos_out, float* bfit_out, int n,
    int dim, int n_islands, int lanes_per_island, int k_steps, unsigned step0,
    int objective, float w, float c1, float c2, float vmax, float half_width,
    int device, void* stream) {
  if (n_islands <= 0 || lanes_per_island <= 0 ||
      static_cast<long long>(n_islands) * lanes_per_island != n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PsoArgs a{seed, gbest, pos, vel, bpos, bfit, r1, r2, pos_out, vel_out,
                  bpos_out, bfit_out, nullptr, nullptr, n, dim, n_islands,
                  lanes_per_island, k_steps, step0, objective, w, c1, c2,
                  vmax, half_width};
  return launch<true>(a, device, stream);
}
