// Fused artificial-bee-colony cycles for Hopper (sm_90a): k cycles in one
// pass, each tile kept in step at every cycle.
//
// dsa_abc_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/abc_fused.py:fused_abc_step_t
//   (body _make_kernel).
//
// What one launch computes, for the sources in the transposed layout
// [D, N], N a whole number of tiles of tile_n lanes, k_steps times, for
// lane j of tile i (roll(X, l)[j] = X[(j - l) mod tile_n]; la, lb =
// shift[step % 8][0:2]):
//
//   mutate(b, p, u, v) = clip(b + onehot(floor(u D)) ((2 v - 1)(b - p)))
//                        over every dimension (no dimension moves where
//                        u D rounds up to D)
//   employed:  c = mutate(x, roll(X, dl1 + la), ud1, up1), X the tile's
//              CURRENT sources; x, f, tr = c, f(c), 0 where f(c) < f,
//              else tr + 1
//   onlooker:  q = 1 / (1 + max(f, 0)) + max(-f, 0);  probed = ug < q /
//              max(max_tile q, 1e-12);  c = mutate(x, roll(P, dl2 + lb),
//              ud2, up2), P the launch's input tile i + s; where probed:
//              x, f, tr = c, f(c), 0 if f(c) < f, else tr + 1
//   scout:     where tr > limit: x = (2 u - 1) hw, f = f(x), tr = 0.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; the scout
// plane is stream 0 over the dimensions, counter (lane, block of four
// dimensions, global step, 0); ud1, up1, ug, ud2 are the words of the call
// (lane, 0, global step, 1), up2 word 0 of (lane, 1, global step, 1).
// The onlooker's candidate is evaluated on probed lanes only and the
// scout's on exhausted lanes only: the result is the TPU kernel's, which
// evaluates both on every lane.  With the draws given as operands (one step
// only) the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no
// contraction, so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin
// (chip_smoke.py: FAM_OPS counts the operations from this source, the
// probed and exhausted lanes from the plain version's run on the same
// inputs).  Bytes: pos, fit and trials read once, written once: 4 (2 D +
// 4) N bytes, 0.27 GB, 0.08 ms at 3.35 TB/s.  Operations: per element and
// step the employed candidate (evaluated and written), rastrigin; per
// probed element the onlooker's; per lane the row draws, the quality, the
// gate and the reductions.  Operations bound it.
//
// Design (first, simple version).  The employed partner rolls the tile's
// current sources and the gate takes a maximum over the tile, so one block
// of up to 512 threads runs one tile, each thread holding lanes t, t + 512,
// ... .  The tile (480 KB at 4,096 x 30) does not fit shared memory: the
// cycles ping-pong in global memory between the outputs and a scratch
// triple, the last landing in the outputs; a cycle reads the previous one
// (its source) and writes the next (its destination), so the employed
// partner reads never meet a write, and a __syncthreads() after each
// cycle's writes orders them.  A candidate differs from its base in one
// dimension: it is evaluated from a functor over the base and the partner,
// and written out only where accepted.  The maximum of the quality is a
// block reduction between the employed and the onlooker phases.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/abc_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr uint32_t kRowStream = 1;

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS); the two
// partners read the first two columns.
__constant__ int kLaneShift[8][2] = {
    {1, 45}, {3, 51}, {7, 57}, {11, 63}, {17, 71}, {23, 77}, {29, 83},
    {37, 95},
};

struct AbcArgs {
  const int* scalars;   // [4] i32: seed, onlooker tile shift, dl1, dl2
  const float* pos;     // [D, N] the launch's input
  const float* fit;     // [N]
  const int* trials;    // [N]
  const float* rows;    // [5, N] or null: draw in the kernel
  const float* fresh;   // [D, N]
  float* pos_out;       // [D, N]
  float* fit_out;       // [N]
  int* trials_out;      // [N]
  float* scratch_pos;   // [D, N] (the outputs when k_steps == 1)
  float* scratch_fit;   // [N]
  int* scratch_trials;  // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;       // global index of the launch's first step
  int objective;
  int limit;
  float half_width;
};

using dsa::obj::add;
using dsa::obj::div;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

// No NaN reaches a clip here (the moves draw no normals), so the plain
// fminf/fmaxf form is torch.clamp's.
__device__ __forceinline__ float clip(float v, float hw) {
  return fminf(fmaxf(v, -hw), hw);
}

// Coordinate d of mutate(base, partner): every dimension computed as the
// one-hot product computes it.
struct Mutant {
  const float* base;
  const float* partner;
  size_t stride;
  int j;
  float phi;
  float hw;
  __device__ __forceinline__ float operator()(int d) const {
    const float b = base[d * stride];
    const float mask = d == j ? 1.0f : 0.0f;
    return clip(add(b, mul(mask, mul(phi, sub(b, partner[d * stride])))),
                hw);
  }
};

struct Column {
  const float* p;
  size_t stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

__device__ __forceinline__ float quality(float f) {
  return add(div(1.0f, add(1.0f, fmaxf(f, 0.0f))), fmaxf(-f, 0.0f));
}

// The five row uniforms of `lane` at counter `ctr`.
__device__ __forceinline__ void row_draws(const AbcArgs& a, bool host_rng,
                                          uint32_t seed, uint32_t ctr,
                                          size_t lane, float r[5]) {
  if (host_rng) {
    const size_t n = static_cast<size_t>(a.n);
#pragma unroll
    for (int k = 0; k < 5; ++k) r[k] = a.rows[k * n + lane];
  } else {
    const uint32_t c0 = static_cast<uint32_t>(lane);
    const dsa::Philox4 p0 =
        dsa::philox4x32_10(c0, 0u, ctr, kRowStream, seed, 0u);
    const dsa::Philox4 p1 =
        dsa::philox4x32_10(c0, 1u, ctr, kRowStream, seed, 0u);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = dsa::uniform_from_bits(p0.v[k]);
    r[4] = dsa::uniform_from_bits(p1.v[0]);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    abc_fused_kernel(const AbcArgs a) {
  __shared__ float slot[kMaxThreads / 32];
  __shared__ float block_max;
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  const long long tile_n = a.tile_n;
  const long long n_tiles = a.n / tile_n;
  const long long tile = blockIdx.x;
  const size_t base = static_cast<size_t>(tile * tile_n);
  const float hw = a.half_width;
  const float fdim = static_cast<float>(dim);

  const bool host_rng = a.rows != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const float* snap = a.pos + wrap(tile + a.scalars[1], n_tiles) * tile_n;
  const long long dl1 = a.scalars[2], dl2 = a.scalars[3];

  const float* src_pos = a.pos;
  const float* src_fit = a.fit;
  const int* src_tr = a.trials;
  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const bool to_out = ((a.k_steps - 1 - step) & 1) == 0;
    float* dst_pos = to_out ? a.pos_out : a.scratch_pos;
    float* dst_fit = to_out ? a.fit_out : a.scratch_fit;
    int* dst_tr = to_out ? a.trials_out : a.scratch_trials;
    const int la = kLaneShift[step & 7][0];
    const int lb = kLaneShift[step & 7][1];

    // Employed bees, and the tile's largest quality after them.
    float qmax = -__int_as_float(0x7f800000);
    for (int jl = t; jl < tile_n; jl += threads) {
      const size_t lane = base + jl;
      float r[5];
      row_draws(a, host_rng, seed, ctr, lane, r);
      const Mutant m{src_pos + lane,
                     src_pos + base + wrap(jl - dl1 - la, tile_n), n,
                     static_cast<int>(floorf(mul(r[0], fdim))),
                     sub(mul(2.0f, r[1]), 1.0f), hw};
      const float cfit = dsa::evaluate_objective(a.objective, m, dim);
      float f = src_fit[lane];
      int tr = src_tr[lane];
      if (cfit < f) {
        for (int d = 0; d < dim; ++d) dst_pos[d * n + lane] = m(d);
        f = cfit;
        tr = 0;
      } else {
        for (int d = 0; d < dim; ++d) {
          dst_pos[d * n + lane] = src_pos[d * n + lane];
        }
        tr += 1;
      }
      dst_fit[lane] = f;
      dst_tr[lane] = tr;
      qmax = fmaxf(qmax, quality(f));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmax = fmaxf(qmax, __shfl_down_sync(0xffffffffu, qmax, off));
    }
    if ((t & 31) == 0) slot[t >> 5] = qmax;
    __syncthreads();
    if (t < 32) {
      const int warps = (threads + 31) / 32;
      qmax = t < warps ? slot[t] : -__int_as_float(0x7f800000);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        qmax = fmaxf(qmax, __shfl_down_sync(0xffffffffu, qmax, off));
      }
      if (t == 0) block_max = fmaxf(qmax, 1e-12f);
    }
    __syncthreads();
    const float gate_den = block_max;

    // Onlooker bees, then scouts: each lane reads only itself and the
    // launch's input.
    for (int jl = t; jl < tile_n; jl += threads) {
      const size_t lane = base + jl;
      float r[5];
      row_draws(a, host_rng, seed, ctr, lane, r);
      float f = dst_fit[lane];
      int tr = dst_tr[lane];
      if (r[2] < div(quality(f), gate_den)) {
        const Mutant m{dst_pos + lane,
                       snap + wrap(jl - dl2 - lb, tile_n), n,
                       static_cast<int>(floorf(mul(r[3], fdim))),
                       sub(mul(2.0f, r[4]), 1.0f), hw};
        const float cfit = dsa::evaluate_objective(a.objective, m, dim);
        if (cfit < f) {
          // Element d of the candidate reads element d of its base only.
          for (int d = 0; d < dim; ++d) dst_pos[d * n + lane] = m(d);
          f = cfit;
          tr = 0;
        } else {
          tr += 1;
        }
      }
      if (tr > a.limit) {
        for (int d0 = 0; d0 < dim; d0 += 4) {
          float u[4];
          if (host_rng) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              u[q] = d0 + q < dim
                         ? a.fresh[static_cast<size_t>(d0 + q) * n + lane]
                         : 0.0f;
            }
          } else {
            const dsa::Philox4 p = dsa::philox4x32_10(
                static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2),
                ctr, 0u, seed, 0u);
#pragma unroll
            for (int q = 0; q < 4; ++q) u[q] = dsa::uniform_from_bits(p.v[q]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (d0 + q < dim) {
              dst_pos[static_cast<size_t>(d0 + q) * n + lane] =
                  mul(sub(mul(2.0f, u[q]), 1.0f), hw);
            }
          }
        }
        f = dsa::evaluate_objective(a.objective, Column{dst_pos + lane, n},
                                    dim);
        tr = 0;
      }
      dst_fit[lane] = f;
      dst_tr[lane] = tr;
    }
    __syncthreads();
    src_pos = dst_pos;
    src_fit = dst_fit;
    src_tr = dst_tr;
  }
}

}  // namespace

// Threads of the block that runs one tile of `tile_n` lanes.
extern "C" int dsa_abc_fused_threads(int tile_n) {
  const int warps = (tile_n + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

// pos [D, N], fit [N] f32 and trials [N] i32, the draws rows [5, N] and
// fresh [D, N] f32 (both or none), the outputs and the scratch triple of
// the same shapes (only read as a distinct triple when k_steps > 1), all
// contiguous on `device`; scalars [4] i32.  N is a multiple of tile_n.
// Launched on `stream` without synchronising, one block per tile.  Returns
// the CUDA error of the launch (0 when accepted).
extern "C" int dsa_abc_fused_f32(
    const int* scalars, const float* pos, const float* fit,
    const int* trials, const float* rows, const float* fresh,
    float* pos_out, float* fit_out, int* trials_out, float* scratch_pos,
    float* scratch_fit, int* scratch_trials, int n, int dim, int tile_n,
    int k_steps, unsigned step0, int objective, int limit, float half_width,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      (rows == nullptr) != (fresh == nullptr) || (rows && k_steps != 1) ||
      (k_steps > 1 && (scratch_pos == pos_out || scratch_fit == fit_out ||
                       scratch_trials == trials_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AbcArgs a{scalars, pos, fit, trials, rows, fresh, pos_out, fit_out,
                  trials_out, scratch_pos, scratch_fit, scratch_trials, n,
                  dim, tile_n, k_steps, step0, objective, limit, half_width};
  const unsigned blocks = static_cast<unsigned>(n / tile_n);
  abc_fused_kernel<<<blocks, dsa_abc_fused_threads(tile_n), 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
