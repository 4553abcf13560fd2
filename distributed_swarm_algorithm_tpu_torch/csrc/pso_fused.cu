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
// rounds are more than half of them.  The bound counts Philox's integer
// work at the f32 rate; its 32-bit products issue on the pipe that also
// runs f32 multiply-adds, at half that rate.  The first version took
// 7.8 ms a launch at that shape (PERF.md; chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W).
//
// Design (rule 2's redesign).  One thread per particle.  A block stages
// its particles' pos, vel and bpos once in dynamic shared memory as
// [3][D][block] with the thread index fastest (a thread owns a column, so
// there are no bank conflicts), loops k_steps times over it, and writes
// everything once.  The block is 128 threads where 3 D 128 floats fit the
// 227 KB a block may take, else 64, else 32 (the entry picks; D <= 605);
// above 48 KB the entry opts in with cudaFuncSetAttribute.  The ragged edge
// of N is masked.  The first version drew each stream with a plain
// philox4x32_10 call, masked every element with d < D, read the gbest
// column from global memory at every element and step, and evaluated the
// objective in a second pass behind a runtime switch.  Now:
//   - both streams of a group come from one philox_pair_group call
//     (philox_pair.cuh, as the grey-wolf kernel draws): 30 products where
//     two calls take 40, the lane's work once a launch and the step's once
//     a step;
//   - the kernel is a template on D mod 4: the chunks of four run with no
//     mask, and the last D mod 4 dimensions are a chunk of their own;
//   - the objective is a template parameter (one kernel each, picked by
//     the entry; swarm_objectives.cuh: ObjectiveOf); sphere, rastrigin,
//     schwefel and styblinski_tang, sums of
//     per-dimension terms, fold each term into the update loop as its
//     coordinate moves (ascending d, from -0, the plain version's order),
//     the others keep the second pass over the staged column;
//   - the gbest column is staged once a block in shared memory (the
//     island's, where the block lies in one island and it fits; else read
//     from global memory);
//   - the uniforms' source (the kernel's Philox or the operands) is a
//     template parameter too, so the step loop of the main path holds only
//     what it runs (chip_smoke.py counts its SASS for the issue floor).
// Tried and left out, each timed against this version on the card (PERF.md):
// blocks of 64 or 32 threads (18 or 19 warps an SM where shared memory
// holds 16 at 128: 2% faster, not worth a new envelope), the chunk loop
// unrolled by 2 or 4 (1% slower), and the pbest write folded into the next
// step's update as a select and a predicated store a coordinate, in place
// of the copy loop a warp runs when one of its lanes improved (3-5%
// slower).
//
// Built with nvcc for sm_90a into a shared library with plain C entries
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/pso_fused.py,
// ops/cuda/islands_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox_pair.cuh"
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
  float w, c1, c2, vmax, half_width;
  int g_in_shared;        // 1: the block's gbest column fits shared memory
};

// One particle's coordinates in the staged tile: element d at p[d * stride].
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

__device__ __forceinline__ bool better(float fit, int lane, float other_fit,
                                       int other_lane) {
  return fit < other_fit || (fit == other_fit && lane < other_lane);
}

// What a thread carries through the step loop.
struct Lane {
  float* s_pos;           // column of the thread in [D][block]
  float* s_vel;
  float* s_bpos;
  int block;
  const float* g;         // the gbest column: shared (stride 1) or global
  int g_stride;
  int lane;
  size_t n;
};

// The update of chunk q (dimensions 4 q .. 4 q + kN - 1) at one step, with
// its uniforms; folds each moved coordinate's term into `s`.  The gbest
// column is read through one generic pointer, staged or not, so that the
// step has one code path.
template <int kN, class Obj>
__device__ __forceinline__ void update_chunk(const PsoArgs& a, const Lane& l,
                                             int q, const float r1[4],
                                             const float r2[4], float& s) {
  const int d0 = 4 * q;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float gd = l.g[(d0 + j) * l.g_stride];
    const int at = (d0 + j) * l.block;
    const float x = l.s_pos[at];
    const float b = l.s_bpos[at];
    float v = add(
        add(mul(a.w, l.s_vel[at]), mul(mul(a.c1, r1[j]), sub(b, x))),
        mul(mul(a.c2, r2[j]), sub(gd, x)));
    v = fminf(fmaxf(v, -a.vmax), a.vmax);
    const float p = fminf(fmaxf(add(x, v), -a.half_width), a.half_width);
    l.s_vel[at] = v;
    l.s_pos[at] = p;
    if constexpr (Obj::kFold) s = add(s, Obj::term(p));
  }
}

// The uniforms of chunk q: the operands' (kHost, one step) or the kernel's
// two Philox streams, drawn together (philox_pair.cuh).
template <int kN, bool kHost>
__device__ __forceinline__ void chunk_uniforms(
    const PsoArgs& a, const Lane& l, const dsa::PhiloxPairLane& pl,
    const dsa::PhiloxPairStep& ps, int q, float r1[4], float r2[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const size_t at = (4 * q + j) * l.n + l.lane;
      r1[j] = a.r1[at];
      r2[j] = a.r2[at];
    }
  } else {
    dsa::Philox4 w[2];
    dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(q), w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r1[j] = dsa::uniform_from_bits(w[0].v[j]);
      r2[j] = dsa::uniform_from_bits(w[1].v[j]);
    }
  }
}

// k_steps steps of one particle; returns its pbest fitness.
template <int kR, int kObj, bool kHost>
__device__ __forceinline__ float run_steps(const PsoArgs& a, const Lane& l,
                                           float bfit) {
  using Obj = dsa::ObjectiveOf<kObj>;
  const int dim = a.dim;
  const int full = dim >> 2;   // chunks of four; kR dimensions after them
  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(*a.seed);
  const dsa::PhiloxPairLane pl =
      dsa::philox_pair_lane(static_cast<uint32_t>(l.lane));
  for (int step = 0; step < a.k_steps; ++step) {
    const dsa::PhiloxPairStep ps = dsa::philox_pair_step(
        pl, a.step0 + static_cast<uint32_t>(step), seed);
    float s = -0.0f;
    for (int q = 0; q < full; ++q) {
      float r1[4], r2[4];
      chunk_uniforms<4, kHost>(a, l, pl, ps, q, r1, r2);
      update_chunk<4, Obj>(a, l, q, r1, r2, s);
    }
    if (kR != 0) {
      float r1[4], r2[4];
      chunk_uniforms<kR, kHost>(a, l, pl, ps, full, r1, r2);
      update_chunk<kR, Obj>(a, l, full, r1, r2, s);
    }
    float fit;
    if constexpr (Obj::kFold) {
      fit = Obj::close(s, dim);
    } else {
      fit = Obj::whole(Column{l.s_pos, l.block}, dim);
    }
    if (fit < bfit) {
      bfit = fit;
      for (int d = 0; d < dim; ++d) {
        l.s_bpos[d * l.block] = l.s_pos[d * l.block];
      }
    }
  }
  return bfit;
}

// kR = D mod 4, the objective and the source of the uniforms (kHost: the
// operands) are template parameters, so a step has no runtime mask, no
// objective switch and one code path; the island flag only picks the gbest
// column at entry.
template <int kR, int kObj, bool kHost>
__global__ void pso_fused_kernel(const PsoArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int dim4 = (dim + 3) & ~3;
  const long long first = static_cast<long long>(blockIdx.x) * block;
  const long long lane_ll = first + t;
  const bool live = lane_ll < a.n;
  const int lane = static_cast<int>(lane_ll);
  const bool islands = a.n_islands > 1;
  // The block's gbest column, staged once where the block lies in one
  // island (always for one swarm) and it fits.
  const int isl0 = islands ? static_cast<int>(first / a.lanes_per_island) : 0;
  const long long last = min(first + block, static_cast<long long>(a.n)) - 1;
  const int isl1 = islands ? static_cast<int>(last / a.lanes_per_island) : 0;
  const bool g_shared = a.g_in_shared && isl0 == isl1;
  float* s_g = smem;
  float* tile = smem + (a.g_in_shared ? dim4 : 0);
  if (g_shared) {
    for (int e = t; e < dim4; e += block) {
      s_g[e] = e < dim ? a.gbest[e * a.n_islands + isl0] : 0.0f;
    }
  }
  __syncthreads();

  Lane l;
  l.s_pos = tile + t;
  l.s_vel = l.s_pos + static_cast<size_t>(dim) * block;
  l.s_bpos = l.s_vel + static_cast<size_t>(dim) * block;
  l.block = block;
  l.g = g_shared ? s_g
                 : a.gbest + (islands && live ? lane / a.lanes_per_island : 0);
  l.g_stride = g_shared ? 1 : a.n_islands;
  l.lane = lane;
  l.n = static_cast<size_t>(a.n);

  float bfit = __int_as_float(0x7f800000);  // +inf for the masked edge
  if (live) {
    for (int d = 0; d < dim; ++d) {
      const size_t at = d * l.n + lane;
      l.s_pos[d * block] = a.pos[at];
      l.s_vel[d * block] = a.vel[at];
      l.s_bpos[d * block] = a.bpos[at];
    }
    bfit = run_steps<kR, kObj, kHost>(a, l, a.bfit[lane]);
    for (int d = 0; d < dim; ++d) {
      const size_t at = d * l.n + lane;
      a.pos_out[at] = l.s_pos[d * block];
      a.vel_out[at] = l.s_vel[d * block];
      a.bpos_out[at] = l.s_bpos[d * block];
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

template <int kR, int kObj, bool kHost>
cudaError_t launch_variant(const PsoArgs& a, unsigned blocks, int block,
                           size_t shared, cudaStream_t s) {
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pso_fused_kernel<kR, kObj, kHost>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  pso_fused_kernel<kR, kObj, kHost><<<blocks, block, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_kernel(const PsoArgs& a, unsigned blocks, int block,
                          size_t shared, cudaStream_t s) {
  return a.r1 != nullptr
             ? launch_variant<kR, kObj, true>(a, blocks, block, shared, s)
             : launch_variant<kR, kObj, false>(a, blocks, block, shared, s);
}

template <int kR>
cudaError_t launch_objective(const PsoArgs& a, int objective,
                             unsigned blocks, int block, size_t shared,
                             cudaStream_t s) {
#define DSA_PSO_CASE(k)                                                  \
  case dsa::k:                                                           \
    return launch_kernel<kR, dsa::k>(a, blocks, block, shared, s);
  switch (objective) {
    DSA_PSO_CASE(kSphere)
    DSA_PSO_CASE(kRastrigin)
    DSA_PSO_CASE(kAckley)
    DSA_PSO_CASE(kRosenbrock)
    DSA_PSO_CASE(kGriewank)
    DSA_PSO_CASE(kSchwefel)
    DSA_PSO_CASE(kLevy)
    DSA_PSO_CASE(kZakharov)
    DSA_PSO_CASE(kStyblinskiTang)
    default:
      return launch_kernel<kR, dsa::kMichalewicz>(a, blocks, block, shared, s);
  }
#undef DSA_PSO_CASE
}

int launch(PsoArgs a, int objective, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(a.dim);
  if (a.n <= 0 || a.dim <= 0 || a.k_steps <= 0 || block == 0 ||
      objective < 0 || objective >= dsa::kObjectiveCount ||
      a.n_islands <= 0 || a.lanes_per_island <= 0 ||
      ((a.r1 == nullptr) != (a.r2 == nullptr)) ||
      (a.r1 != nullptr && a.k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t tile = 3ull * a.dim * block * sizeof(float);
  const size_t g_bytes = ((a.dim + 3ull) & ~3ull) * sizeof(float);
  a.g_in_shared = tile + g_bytes <= kMaxSharedBytes;
  const size_t shared = tile + (a.g_in_shared ? g_bytes : 0);
  const unsigned blocks = (static_cast<unsigned>(a.n) + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.dim & 3) {
    case 0: err = launch_objective<0>(a, objective, blocks, block, shared, s);
      break;
    case 1: err = launch_objective<1>(a, objective, blocks, block, shared, s);
      break;
    case 2: err = launch_objective<2>(a, objective, blocks, block, shared, s);
      break;
    default: err = launch_objective<3>(a, objective, blocks, block, shared, s);
  }
  return static_cast<int>(err);
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
                  k_steps, step0, w, c1, c2, vmax, half_width, 0};
  return launch(a, objective, device, stream);
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
                  lanes_per_island, k_steps, step0, w, c1, c2, vmax,
                  half_width, 0};
  return launch(a, objective, device, stream);
}
