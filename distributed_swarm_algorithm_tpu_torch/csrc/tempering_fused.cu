// Fused parallel tempering for Hopper (sm_90a): k Metropolis steps and their
// replica exchanges in one pass, the best state visited recorded at every
// step.
//
// dsa_pt_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/tempering_fused.py:
//   fused_pt_step_t (body _make_kernel).
//
// What one launch computes, for the chains in the transposed layout [D, N],
// N a whole number of tiles of tile_n lanes (tile_n even), k_steps times,
// for the chain in lane j (column c of its tile, global column g):
//
//   cand = clip(x + sigma_j n), n the cosine half of a Box-Muller pair;
//   x, f = cand, f(cand) where u_acc < exp_fast(min((f - f(cand)) beta_j, 0))
//   the lane's running best (fitness and position) where f < best
//   where it = it0 + step + 1 is a multiple of swap_every, with parity p =
//   (it / swap_every) % 2: lanes (c, c + 1) with (c - p) even pair up; the
//   pair is valid unless p = 1 and c is the tile's last lane, and unless
//   g + 1 >= n_real (the padding never exchanges); a valid pair swaps
//   configurations and fitness where u_swap(lower) < exp_fast(min((beta_l -
//   beta_u)(f_l - f_u), 0)).  Both members of a pair read the same product,
//   so the lower lane decides for both.
//
// and the outputs are the chains, their fitness and, per block, the least
// running best of its own lanes (first lane on ties) and its position; the
// wrapper takes the first least block (ops/cuda/tempering_fused.py), which
// is the lowest column holding the launch's least visited fitness, the TPU
// kernel's grid-ordered result.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; the pair's
// uniforms are streams 0 and 1 over the dimensions, counter (lane, block of
// four dimensions, global step, stream); u_acc and u_swap are words 0 and 1
// of the call (lane, 0, global step, 2).  With the draws given as operands
// (one step only) the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// log2, 2^x and cos 2 pi x through fast_math.cuh and the objectives header,
// so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 16 steps, rastrigin
// (chip_smoke.py: FAM_OPS counts the operations from this source).  Bytes:
// pos, fit, sigma and beta read once, pos and fit written once: 4 (2 D + 4)
// N bytes, 0.27 GB, 0.08 ms at 3.35 TB/s.  Operations: per element and step
// the pair's two Philox calls and uniforms, the cosine half, the move and
// its clip, rastrigin and the acceptance's copy; per lane and step the row
// call, the acceptance, the running best, and at a round the pair's test.
// Operations bound it.
//
// Design: blocks of B lanes inside a tile, with a halo of h lanes on each
// side, h the most exchange rounds the launch can hold (ceil(k /
// swap_every)).  A round couples a lane with a neighbour, so after r rounds
// a lane depends on lanes within r of it: the block stages its B + 2h
// lanes' chains in shared memory, moves all of them (the halo's moves from
// the same Philox counters as their own blocks draw), exchanges within the
// window, and writes back only its own B, whose dependence never leaves the
// window.  A round is two barriers; the steps between rounds need none.
// The window's lanes outside the tile take no part (no pair crosses a tile
// boundary when tile_n is even).  Shared memory: the window's positions and
// candidates [D][W], the own lanes' running-best positions [D][B], and the
// window's fitness, inverse temperature and swap uniform [W], W = B + 2h
// rounded up to a warp; B is 128 where that fits the 227 KB a block may
// take, else 64, else 32.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/tempering_fused.py).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
// Kept for the static shared memory of the block reduction.
constexpr size_t kStaticReserve = 1024;
constexpr uint32_t kRowStream = 2;

struct PtArgs {
  const int* scalars;   // [3] i32: seed, it0, n_real
  const float* pos;     // [D, N]
  const float* fit;     // [N]
  const float* sigma;   // [N]
  const float* beta;    // [N]
  const float* r_n;     // [D, N] or null: draw in the kernel
  const float* r_acc;   // [N]
  const float* r_swap;  // [N]
  float* pos_out;       // [D, N]
  float* fit_out;       // [N]
  float* block_fit;     // [blocks]
  float* block_pos;     // [D, blocks]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;       // global index of the launch's first step
  int objective;
  int swap_every;
  int own;              // B: the lanes a block owns
  int halo;             // h
  float half_width;
};

struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::fast::exp_fast;
using dsa::fast::min0;
using dsa::fast::normal_cos;
using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ int window_of(int own, int halo) {
  return (own + 2 * halo + 31) / 32 * 32;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// (v, i) replaces (bv, bi) in an argmin: strictly less, or equal at a lower
// index.
__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void pt_fused_kernel(const PtArgs a) {
  extern __shared__ float smem[];
  __shared__ float slot_v[32];
  __shared__ int slot_i[32];
  __shared__ int win_i;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int own = a.own;
  const int halo = a.halo;
  const int w_len = window_of(own, halo);
  const size_t n = static_cast<size_t>(a.n);
  const int tile_n = a.tile_n;
  const int per_tile = (tile_n + own - 1) / own;
  const int tile = blockIdx.x / per_tile;
  const int c0 = (blockIdx.x % per_tile) * own;  // first own column
  float* s_pos = smem;                                   // [D][W]
  float* s_cand = s_pos + static_cast<size_t>(dim) * w_len;  // [D][W]
  float* s_rb = s_cand + static_cast<size_t>(dim) * w_len;   // [D][B]
  float* s_fit = s_rb + static_cast<size_t>(dim) * own;      // [W]
  float* s_beta = s_fit + w_len;                             // [W]
  float* s_u = s_beta + w_len;                               // [W]

  // Window lane t holds tile column c; own lanes are [c0, c0 + B) of it.
  const int c = c0 - halo + t;
  const bool active = t < own + 2 * halo && c >= 0 && c < tile_n;
  const int r = t - halo;                        // own index
  const bool mine = active && r >= 0 && r < own;
  const long long g = static_cast<long long>(tile) * tile_n + c;
  const size_t lane = active ? static_cast<size_t>(g) : 0;

  const bool host_rng = a.r_n != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const int it0 = a.scalars[1];
  const long long n_real = a.scalars[2];
  const float hw = a.half_width;

  float fit = inf(), sigma = 0.0f, beta = 0.0f, rb_fit = inf();
  if (active) {
    for (int d = 0; d < dim; ++d) {
      const float x = a.pos[d * n + lane];
      s_pos[d * w_len + t] = x;
      if (mine) s_rb[d * own + r] = x;
    }
    fit = a.fit[lane];
    sigma = a.sigma[lane];
    beta = a.beta[lane];
    rb_fit = fit;
  }
  s_beta[t] = beta;

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    if (active) {
      // Metropolis move.
      for (int d0 = 0; d0 < dim; d0 += 4) {
        float nz[4];
        if (host_rng) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            nz[q] = d0 + q < dim ? a.r_n[static_cast<size_t>(d0 + q) * n + lane]
                                 : 0.0f;
          }
        } else {
          const uint32_t gd = static_cast<uint32_t>(d0 >> 2);
          const uint32_t c0w = static_cast<uint32_t>(lane);
          const dsa::Philox4 p0 = dsa::philox4x32_10(c0w, gd, ctr, 0u, seed, 0u);
          const dsa::Philox4 p1 = dsa::philox4x32_10(c0w, gd, ctr, 1u, seed, 0u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            nz[q] = normal_cos(dsa::uniform_from_bits(p0.v[q]),
                               dsa::uniform_from_bits(p1.v[q]));
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = d0 + q;
          if (d < dim) {
            s_cand[d * w_len + t] = dsa::fast::clip(
                add(s_pos[d * w_len + t], mul(sigma, nz[q])), -hw, hw);
          }
        }
      }
      const float cfit = dsa::evaluate_objective(
          a.objective, Column{s_cand + t, w_len}, dim);
      float u_acc, u_swap;
      if (host_rng) {
        u_acc = a.r_acc[lane];
        u_swap = a.r_swap[lane];
      } else {
        const dsa::Philox4 p = dsa::philox4x32_10(
            static_cast<uint32_t>(lane), 0u, ctr, kRowStream, seed, 0u);
        u_acc = dsa::uniform_from_bits(p.v[0]);
        u_swap = dsa::uniform_from_bits(p.v[1]);
      }
      if (u_acc < exp_fast(min0(mul(sub(fit, cfit), beta)))) {
        for (int d = 0; d < dim; ++d) {
          s_pos[d * w_len + t] = s_cand[d * w_len + t];
        }
        fit = cfit;
      }
      if (mine && fit < rb_fit) {
        rb_fit = fit;
        for (int d = 0; d < dim; ++d) s_rb[d * own + r] = s_pos[d * w_len + t];
      }
      s_fit[t] = fit;
      s_u[t] = u_swap;
    }

    // Replica exchange, where this step ends a round.
    const long long it = static_cast<long long>(it0) + step + 1;
    if (it % a.swap_every == 0) {
      __syncthreads();
      const long long parity = (it / a.swap_every) % 2;
      const bool lower = ((c - parity) & 1) == 0;
      if (active && lower && t + 1 < own + 2 * halo && c + 1 < tile_n &&
          (parity == 0 || (c >= 1 && c <= tile_n - 2)) && g + 1 < n_real) {
        const float fu = s_fit[t + 1];
        const float delta = mul(sub(beta, s_beta[t + 1]), sub(fit, fu));
        if (s_u[t] < exp_fast(min0(delta))) {
          for (int d = 0; d < dim; ++d) {
            const float x = s_pos[d * w_len + t];
            s_pos[d * w_len + t] = s_pos[d * w_len + t + 1];
            s_pos[d * w_len + t + 1] = x;
          }
          s_fit[t + 1] = fit;
          s_fit[t] = fu;
        }
      }
      __syncthreads();
      fit = s_fit[t];
    }
  }

  if (mine) {
    for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = s_pos[d * w_len + t];
    a.fit_out[lane] = fit;
  }

  // The block's least running best, the first own lane on ties.
  float v = mine ? rb_fit : inf();
  int i = mine ? r : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (wins(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if ((t & 31) == 0) {
    slot_v[t >> 5] = v;
    slot_i[t >> 5] = i;
  }
  __syncthreads();
  if (t < 32) {
    const int warps = w_len / 32;
    v = t < warps ? slot_v[t] : inf();
    i = t < warps ? slot_i[t] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (wins(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (t == 0) {
      win_i = i;
      a.block_fit[blockIdx.x] = v;
    }
  }
  __syncthreads();
  const int best = win_i;
  const size_t blocks = gridDim.x;
  for (int d = t; d < dim; d += blockDim.x) {
    a.block_pos[d * blocks + blockIdx.x] =
        best == INT_MAX ? 0.0f : s_rb[d * own + best];
  }
}

size_t shared_bytes(int dim, int own, int halo) {
  const size_t w = (own + 2 * halo + 31) / 32 * 32;
  return (2 * w + own) * dim * sizeof(float) + 3 * w * sizeof(float);
}

// Lanes a block owns: the largest of 128, 64, 32 whose buffers fit, or 0.
int pick_block(int dim, int halo) {
  for (int own = 128; own >= 32; own >>= 1) {
    if (shared_bytes(dim, own, halo) + kStaticReserve <= kMaxSharedBytes) {
      return own;
    }
  }
  return 0;
}

}  // namespace

// Lanes a block owns for `dim` and `halo` (0: outside the envelope).
extern "C" int dsa_pt_fused_block(int dim, int halo) {
  return pick_block(dim, halo);
}

// All arrays f32, contiguous, on `device`: pos [D, N], fit, sigma, beta
// [N], the draws r_n [D, N], r_acc, r_swap [N] (all three or none), pos_out
// [D, N], fit_out [N], and per block block_fit [blocks] and block_pos
// [D, blocks], blocks = (N / tile_n) ceil(tile_n / B);
// scalars [3] i32.  N is a multiple of tile_n, tile_n even, halo at least
// ceil(k_steps / swap_every).  Launched on `stream` without synchronising.
// Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_pt_fused_f32(
    const int* scalars, const float* pos, const float* fit,
    const float* sigma, const float* beta, const float* r_n,
    const float* r_acc, const float* r_swap, float* pos_out, float* fit_out,
    float* block_fit, float* block_pos, int n, int dim,
    int tile_n, int k_steps, unsigned step0, int objective, int swap_every,
    int halo, float half_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int own = pick_block(dim, halo);
  const bool some = r_n || r_acc || r_swap;
  const bool all = r_n && r_acc && r_swap;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || own == 0 || tile_n <= 0 ||
      tile_n % 2 != 0 || n % tile_n != 0 || swap_every <= 0 ||
      halo * swap_every < k_steps || halo > 64 || objective < 0 ||
      objective >= dsa::kObjectiveCount || some != all ||
      (all && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PtArgs a{scalars, pos, fit, sigma, beta, r_n, r_acc, r_swap,
                 pos_out, fit_out, block_fit, block_pos, n, dim,
                 tile_n, k_steps, step0, objective, swap_every, own, halo,
                 half_width};
  const size_t shared = shared_bytes(dim, own, halo);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(pt_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_tile = (tile_n + own - 1) / own;
  const unsigned blocks = static_cast<unsigned>(n / tile_n) * per_tile;
  const int threads = (own + 2 * halo + 31) / 32 * 32;
  pt_fused_kernel<<<blocks, threads, shared,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
