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
// Blocks and halos.  A round couples a lane with a neighbour, so after r
// rounds a lane depends on lanes within r of it.  A block owns B lanes of a
// tile and stages them with a halo of h lanes on each side, h the most
// exchange rounds the launch can hold (ceil(k / swap_every)): it moves all
// of its window's lanes (the halo's moves from the same Philox counters as
// their own blocks draw), exchanges within the window, and writes back only
// its own B, whose dependence never leaves the window.  A round is two
// barriers; the steps between rounds need none.  The window's lanes outside
// the tile take no part (no pair crosses a tile boundary when tile_n is
// even).
//
// Design (rule 2's redesign).  The first version (3.420 ms a launch at the
// main path's shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) owns 128
// lanes a block, so its window of 136 at h = 4 runs in 160 threads, the
// fifth warp three quarters idle; it keeps the window's positions and
// candidates and the own lanes' running-best positions as [D][W], [D][W]
// and [D][128] tiles (55.7 KB at D = 30: 20 warps an SM), draws every group
// of four dimensions with two plain philox4x32_10 calls and every step's
// row with a third, masks every element with d < D, evaluates the objective
// in a second pass behind a runtime switch and copies an accepted
// candidate.  Two variants now, which the wrapper's geometry picks
// (ops/cuda/tempering_fused.py: pt_geometry) and the entry checks:
//
// Variant 0, warps filled with owned chains (the main path).  A window of
// 256 threads owns B = 256 - 2h lanes (248 at h = 4: 17 blocks a tile of
// 4,096, 94% of the threads on owned chains; the last block of a tile owns
// fewer):
//   - each group of four dimensions draws streams 0 and 1 with one
//     philox_pair_group call on the lane's products (once a launch) and the
//     step's (once a step), and the row with philox_one.cuh;
//   - templates on D mod 4 (the chunks of four run unmasked, the last D mod
//     4 dimensions a chunk of their own), on the objective and on the
//     draws' source, so the step loop of the main path holds only what it
//     runs (chip_smoke.py's SASS census gives its issue floor); a sum of
//     per-dimension terms (sphere, rastrigin, schwefel, styblinski_tang)
//     folds into the move loop in ascending d from -0, the plain version's
//     order; the other objectives keep a second pass;
//   - the running best is kept per warp, not per lane: (fit, own index)
//     replaces the warp's best where it is strictly less in that order,
//     which gives the block the per-lane rule's result (each lane's best
//     moves only on a strict improvement, so the first lane of the least
//     value holds the position of its first visit), in a [D][8] tile; a
//     warp none of whose lanes beats its best pays one ballot;
//   - the window holds two [D][256] planes and each lane the index of the
//     plane that holds its position; the candidate goes to the other, and
//     an acceptance flips the index (no copy); 65 KB at D = 30, D <= 109.
//
// Variant 1, the first version, kept as it was (pt_cand_tile_kernel) for
// the widths variant 0 does not hold (D = 110 to 360 at the widest halo).
//
// Above 48 KB of shared memory a block the entry opts in with
// cudaFuncSetAttribute.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/tempering_fused.py).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "philox_one.cuh"
#include "philox_pair.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
// Kept for the static shared memory of the block reduction.
constexpr size_t kStaticReserve = 1024;
constexpr uint32_t kRowStream = 2;
constexpr int kWindow = 256;            // variant 0's threads a block
constexpr int kWarps = kWindow / 32;
// Variant 0's blocks an SM that its registers must allow (85 a thread):
// its shared memory holds 3 at D = 30, and without the bound ptxas kept
// 64 registers and spilled in some instantiations.
constexpr int kMinBlocks = 3;
constexpr unsigned kFull = 0xffffffffu;

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

// --------------------------------------------------------------------------
// Variant 0: warps filled with owned chains.
// --------------------------------------------------------------------------

// Dynamic shared memory of a variant-0 block: two planes [D][256] of
// positions and candidates; the warps' running bests [D][8]; the window's
// fitness, inverse temperature, swap uniform and plane index [256].
size_t main_bytes(int dim) {
  return (2ull * dim * kWindow + 1ull * dim * kWarps + 4ull * kWindow) *
         sizeof(float);
}

// The proposal of one lane at one step: the normals of a group of four
// dimensions, from the operand (kHost, one step) or from the kernel's
// streams 0 and 1, and the move.
template <bool kHost>
struct Proposal {
  const float* r_n;   // [D, N] (kHost)
  size_t n;
  size_t lane;
  dsa::PhiloxPairLane pl;
  dsa::PhiloxPairStep ps;
  float sigma, hw;

  template <int kN>
  __device__ __forceinline__ void normals(int q, float nz[4]) const {
    if constexpr (kHost) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        nz[j] = r_n[static_cast<size_t>(4 * q + j) * n + lane];
      }
    } else {
      dsa::Philox4 w[2];
      dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(q), w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nz[j] = normal_cos(dsa::uniform_from_bits(w[0].v[j]),
                           dsa::uniform_from_bits(w[1].v[j]));
      }
    }
  }

  __device__ __forceinline__ float move(float x, float nz) const {
    return dsa::fast::clip(add(x, mul(sigma, nz)), -hw, hw);
  }
};

// Chunk q of the candidate: each element from the current plane `x`, into
// the other plane `c`, its objective term into s (kFold).
template <int kN, class Obj, bool kHost>
__device__ __forceinline__ void candidate_chunk(const Proposal<kHost>& p,
                                                const float* x, float* c,
                                                int q, float& s) {
  float nz[4];
  p.template normals<kN>(q, nz);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float v = p.move(x[d * kWindow], nz[j]);
    c[d * kWindow] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

// The warp's running best (wv, wl: value and own index, the same in every
// lane) takes the least (fit, own index) of the lanes that are strictly
// less in that order, and its position, the column at s_x + at of the
// winning lane, goes to the warp's column of s_rb.  Called by every lane
// of the warp.
__device__ __forceinline__ void warp_best(bool mine, float fit, int r,
                                          const float* s_x, int at,
                                          float& wv, int& wl, float* s_rb,
                                          int dim) {
  const bool better = mine && wins(fit, r, wv, wl);
  if (__ballot_sync(kFull, better) == 0) return;
  float v = better ? fit : inf();
  int i = better ? r : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (wins(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  wv = v;
  wl = i;
  const int src = __ffs(__ballot_sync(kFull, better && r == i)) - 1;
  const float* col = s_x + __shfl_sync(kFull, at, src);
  __syncwarp();   // the winner's column, written by its lane, is visible
  const int w = threadIdx.x >> 5;
  for (int d = threadIdx.x & 31; d < dim; d += 32) {
    s_rb[d * kWarps + w] = col[d * kWindow];
  }
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kWindow, kMinBlocks)
    pt_step_kernel(const PtArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float slot_v[kWarps];
  __shared__ int slot_i[kWarps];
  __shared__ int win_w;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int own = a.own;
  const int halo = a.halo;
  const size_t n = static_cast<size_t>(a.n);
  const int tile_n = a.tile_n;
  const int per_tile = (tile_n + own - 1) / own;
  const int tile = blockIdx.x / per_tile;
  const int c0 = (blockIdx.x % per_tile) * own;  // first own column
  const int plane = dim * kWindow;
  float* s_x = smem;                                    // [2][D][W]
  float* s_rb = s_x + 2 * plane;                        // [D][8]
  float* s_fit = s_rb + dim * kWarps;                   // [W]
  float* s_beta = s_fit + kWindow;                      // [W]
  float* s_u = s_beta + kWindow;                        // [W]
  int* s_cur = reinterpret_cast<int*>(s_u + kWindow);   // [W]

  // Window lane t holds tile column c; own lanes are [c0, c0 + B) of it.
  const int c = c0 - halo + t;
  const bool active = c >= 0 && c < tile_n;
  const int r = t - halo;                        // own index
  const bool mine = active && r >= 0 && r < own;
  const long long g = static_cast<long long>(tile) * tile_n + c;
  const size_t lane = active ? static_cast<size_t>(g) : 0;

  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const int it0 = a.scalars[1];
  const long long n_real = a.scalars[2];

  // The plane holding the lane's position: 0 or `plane`.
  int cur = 0;
  float fit = inf(), beta = 0.0f;
  Proposal<kHost> p;
  p.r_n = a.r_n;
  p.n = n;
  p.lane = lane;
  p.sigma = 0.0f;
  p.hw = a.half_width;
  if (active) {
    for (int d = 0; d < dim; ++d) s_x[d * kWindow + t] = a.pos[d * n + lane];
    fit = a.fit[lane];
    p.sigma = a.sigma[lane];
    beta = a.beta[lane];
  }
  s_fit[t] = fit;
  s_beta[t] = beta;
  p.pl = dsa::philox_pair_lane(static_cast<uint32_t>(lane));
  const dsa::PhiloxOneLane rl =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), kRowStream);
  const int full = dim >> 2;   // chunks of four; kR dimensions after them

  // Where the rounds fall: it = it0 + step + 1 = q swap_every + rem (it0,
  // the run's iteration, is not negative), kept step by step so that the
  // loop divides nothing.
  const long long it1 = static_cast<long long>(it0) + 1;
  int rem = static_cast<int>(it1 % a.swap_every);
  long long q_round = it1 / a.swap_every;

  // The warp's running best, from the launch's input.
  float wv = inf();
  int wl = INT_MAX;
  warp_best(mine, fit, r, s_x, t, wv, wl, s_rb, dim);

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    if (active) {
      float* x = s_x + cur + t;
      float* cand = s_x + (plane - cur) + t;
      if constexpr (!kHost) p.ps = dsa::philox_pair_step(p.pl, ctr, seed);
      // Metropolis move.
      float s = -0.0f;
#pragma unroll 1
      for (int q = 0; q < full; ++q) {
        candidate_chunk<4, Obj>(p, x, cand, q, s);
      }
      if constexpr (kR != 0) {
        candidate_chunk<kR, Obj>(p, x, cand, full, s);
      }
      float cfit;
      if constexpr (Obj::kFold) {
        cfit = Obj::close(s, dim);
      } else {
        cfit = Obj::whole(Column{cand, kWindow}, dim);
      }
      float u_acc, u_swap;
      if constexpr (kHost) {
        u_acc = a.r_acc[lane];
        u_swap = a.r_swap[lane];
      } else {
        const dsa::Philox4 w = dsa::philox_one_group(
            rl, dsa::philox_one_step(rl, ctr, seed), 0u);
        u_acc = dsa::uniform_from_bits(w.v[0]);
        u_swap = dsa::uniform_from_bits(w.v[1]);
      }
      if (u_acc < exp_fast(min0(mul(sub(fit, cfit), beta)))) {
        cur = plane - cur;
        fit = cfit;
      }
      s_fit[t] = fit;
      s_u[t] = u_swap;
    }
    warp_best(mine, fit, r, s_x, cur + t, wv, wl, s_rb, dim);

    // Replica exchange, where this step ends a round.
    if (rem == 0) {
      s_cur[t] = cur;
      __syncthreads();
      const int parity = static_cast<int>(q_round & 1);
      const bool lower = ((c - parity) & 1) == 0;
      if (active && lower && t + 1 < kWindow && c + 1 < tile_n &&
          (parity == 0 || (c >= 1 && c <= tile_n - 2)) && g + 1 < n_real) {
        const float fu = s_fit[t + 1];
        const float delta = mul(sub(beta, s_beta[t + 1]), sub(fit, fu));
        if (s_u[t] < exp_fast(min0(delta))) {
          float* mine_x = s_x + cur + t;
          float* their_x = s_x + s_cur[t + 1] + t + 1;
          for (int d = 0; d < dim; ++d) {
            const float v = mine_x[d * kWindow];
            mine_x[d * kWindow] = their_x[d * kWindow];
            their_x[d * kWindow] = v;
          }
          s_fit[t + 1] = fit;
          s_fit[t] = fu;
        }
      }
      __syncthreads();
      fit = s_fit[t];
    }
    if (++rem == a.swap_every) {
      rem = 0;
      ++q_round;
    }
  }

  if (mine) {
    const float* x = s_x + cur + t;
    for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = x[d * kWindow];
    a.fit_out[lane] = fit;
  }

  // The block's least running best: the least (value, own index) of its
  // warps'.
  if ((t & 31) == 0) {
    slot_v[t >> 5] = wv;
    slot_i[t >> 5] = wl;
  }
  __syncthreads();
  if (t < 32) {
    float v = t < kWarps ? slot_v[t] : inf();
    int i = t < kWarps ? slot_i[t] : INT_MAX;
    int w = t;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, off);
      const int oi = __shfl_down_sync(kFull, i, off);
      const int ow = __shfl_down_sync(kFull, w, off);
      if (wins(ov, oi, v, i)) {
        v = ov;
        i = oi;
        w = ow;
      }
    }
    if (t == 0) {
      win_w = w;
      a.block_fit[blockIdx.x] = v;
    }
  }
  __syncthreads();
  const int best = win_w;
  const size_t blocks = gridDim.x;
  for (int d = t; d < dim; d += kWindow) {
    a.block_pos[d * blocks + blockIdx.x] = s_rb[d * kWarps + best];
  }
}

// --------------------------------------------------------------------------
// Variant 1: the first version, a candidate tile and per-lane running bests.
// --------------------------------------------------------------------------

__global__ void pt_cand_tile_kernel(const PtArgs a) {
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

// Variant 1's lanes a block owns: the largest of 128, 64, 32 whose buffers
// fit, or 0 (the kernel's envelope: D <= 360 at the widest halo).
int pick_block(int dim, int halo) {
  for (int own = 128; own >= 32; own >>= 1) {
    if (shared_bytes(dim, own, halo) + kStaticReserve <= kMaxSharedBytes) {
      return own;
    }
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
cudaError_t launch_main(const PtArgs& a, unsigned blocks, size_t shared,
                        cudaStream_t s) {
  auto* kernel = pt_step_kernel<kR, kObj, kHost>;
  const cudaError_t err =
      allow_shared(reinterpret_cast<const void*>(kernel), shared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWindow, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_draws(const PtArgs& a, unsigned blocks, size_t shared,
                         cudaStream_t s) {
  return a.r_n != nullptr
             ? launch_main<kR, kObj, true>(a, blocks, shared, s)
             : launch_main<kR, kObj, false>(a, blocks, shared, s);
}

template <int kR>
cudaError_t launch_objective(const PtArgs& a, unsigned blocks, size_t shared,
                             cudaStream_t s) {
#define DSA_PT_CASE(k) \
  case dsa::k:         \
    return launch_draws<kR, dsa::k>(a, blocks, shared, s);
  switch (a.objective) {
    DSA_PT_CASE(kSphere)
    DSA_PT_CASE(kRastrigin)
    DSA_PT_CASE(kAckley)
    DSA_PT_CASE(kRosenbrock)
    DSA_PT_CASE(kGriewank)
    DSA_PT_CASE(kSchwefel)
    DSA_PT_CASE(kLevy)
    DSA_PT_CASE(kZakharov)
    DSA_PT_CASE(kStyblinskiTang)
    default:
      return launch_draws<kR, dsa::kMichalewicz>(a, blocks, shared, s);
  }
#undef DSA_PT_CASE
}

// Whether the entry runs `variant` with windows of `window` threads owning
// `own` lanes and `shared` bytes a block, at this D and halo: variant 0
// needs windows of 256 owning 256 - 2h lanes and exactly its layout's
// bytes; variant 1 the first version's block, window and bytes.
bool geometry_ok(int variant, int window, int own, int shared, int dim,
                 int halo) {
  if (shared < 0 ||
      static_cast<size_t>(shared) + kStaticReserve > kMaxSharedBytes) {
    return false;
  }
  if (variant == 0) {
    return window == kWindow && own == kWindow - 2 * halo && own > 0 &&
           static_cast<size_t>(shared) == main_bytes(dim);
  }
  return variant == 1 && own != 0 &&
         own == pick_block(dim, halo) && window == (own + 2 * halo + 31) /
                                                      32 * 32 &&
         static_cast<size_t>(shared) == shared_bytes(dim, own, halo);
}

// The words the main kernel draws for (lane, group g, step, seed): streams
// 0 and 1 of group g from the pair call, and the row (stream 2, group 0)
// from philox_one.cuh, beside philox4x32_10's.
__global__ void philox_check_kernel(const uint32_t* lanes,
                                    const uint32_t* gs, const uint32_t* ctrs,
                                    const uint32_t* seeds, int n,
                                    uint32_t* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const dsa::PhiloxPairLane pl = dsa::philox_pair_lane(lanes[e]);
  dsa::Philox4 w[2];
  dsa::philox_pair_group(pl, dsa::philox_pair_step(pl, ctrs[e], seeds[e]),
                         gs[e], w);
  const dsa::PhiloxOneLane rl = dsa::philox_one_lane(lanes[e], kRowStream);
  const dsa::Philox4 row = dsa::philox_one_group(
      rl, dsa::philox_one_step(rl, ctrs[e], seeds[e]), 0u);
  const dsa::Philox4 r0 =
      dsa::philox4x32_10(lanes[e], gs[e], ctrs[e], 0u, seeds[e], 0u);
  const dsa::Philox4 r1 =
      dsa::philox4x32_10(lanes[e], gs[e], ctrs[e], 1u, seeds[e], 0u);
  const dsa::Philox4 r_row =
      dsa::philox4x32_10(lanes[e], 0u, ctrs[e], kRowStream, seeds[e], 0u);
  uint32_t* o = out + static_cast<size_t>(e) * 24;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = w[0].v[j];
    o[4 + j] = w[1].v[j];
    o[8 + j] = row.v[j];
    o[12 + j] = r0.v[j];
    o[16 + j] = r1.v[j];
    o[20 + j] = r_row.v[j];
  }
}

}  // namespace

// Variant 1's lanes a block owns for `dim` and `halo` (0: outside the
// envelope).
extern "C" int dsa_pt_fused_block(int dim, int halo) {
  return pick_block(dim, halo);
}

// All arrays f32, contiguous, on `device`: pos [D, N], fit, sigma, beta
// [N], the draws r_n [D, N], r_acc, r_swap [N] (all three or none), pos_out
// [D, N], fit_out [N], and per block block_fit [blocks] and block_pos
// [D, blocks], blocks = (N / tile_n) ceil(tile_n / own); scalars [3] i32.
// N is a multiple of tile_n, tile_n even, halo at least ceil(k_steps /
// swap_every).  The geometry (variant, window, own lanes, shared bytes a
// block) is the wrapper's (pt_geometry); one this entry
// cannot run is refused.  Launched on `stream` without synchronising.
// Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_pt_fused_f32(
    const int* scalars, const float* pos, const float* fit,
    const float* sigma, const float* beta, const float* r_n,
    const float* r_acc, const float* r_swap, float* pos_out, float* fit_out,
    float* block_fit, float* block_pos, int n, int dim,
    int tile_n, int k_steps, unsigned step0, int objective, int swap_every,
    int halo, float half_width, int variant, int window, int own, int shared,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool some = r_n || r_acc || r_swap;
  const bool all = r_n && r_acc && r_swap;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      tile_n % 2 != 0 || n % tile_n != 0 || swap_every <= 0 || halo < 0 ||
      halo * swap_every < k_steps || halo > 64 || objective < 0 ||
      objective >= dsa::kObjectiveCount || some != all ||
      (all && k_steps != 1) ||
      !geometry_ok(variant, window, own, shared, dim, halo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PtArgs a{scalars, pos, fit, sigma, beta, r_n, r_acc, r_swap,
                 pos_out, fit_out, block_fit, block_pos, n, dim,
                 tile_n, k_steps, step0, objective, swap_every, own, halo,
                 half_width};
  const int per_tile = (tile_n + own - 1) / own;
  const unsigned blocks = static_cast<unsigned>(n / tile_n) * per_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, blocks, shared, s); break;
      case 1: err = launch_objective<1>(a, blocks, shared, s); break;
      case 2: err = launch_objective<2>(a, blocks, shared, s); break;
      default: err = launch_objective<3>(a, blocks, shared, s);
    }
  } else {
    err = allow_shared(reinterpret_cast<const void*>(pt_cand_tile_kernel),
                       shared);
    if (err == cudaSuccess) {
      pt_cand_tile_kernel<<<blocks, window, shared, s>>>(a);
      err = cudaGetLastError();
    }
  }
  // A refused call leaves its error pending: clear it, so that the next
  // launch does not report it as its own.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The words of the main kernel's hoisted draws beside philox4x32_10's, for
// n counters (lane, group, step) and seeds: out [n, 24], streams 0 and 1 of
// the group and the row as drawn, then as philox4x32_10 draws them.
extern "C" int dsa_pt_philox_check(const unsigned* lanes, const unsigned* gs,
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
