// Fused cuckoo-search generations for Hopper (sm_90a): k generations in one
// pass, each tile kept in step at every generation.
//
// dsa_cuckoo_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/cuckoo_fused.py:
//   fused_cuckoo_step_t (body _make_kernel).
//
// What one launch computes, for pos in the transposed layout [D, N], N a
// whole number of tiles of tile_n lanes, k_steps times, for lane j of tile
// i (roll(X, l)[j] = X[(j - l) mod tile_n], jnp.roll's direction; sa, sb,
// sc = shift[step % 8]):
//
//   levy  = (sigma n1) 2^(-log2(|n2| + 1e-12) / beta)
//   cand  = clip(x + (step_scale levy)(x - best), +-hw)   (x the CURRENT
//           generation, best the launch's input [D])
//   egg   = roll(cand, l_egg + sa) over the tile's candidates of this
//           generation; x, f = egg, f(egg) where f(egg) < f(x)
//   where u_ab < pa: x = clip(x + u_walk (roll(P1, l_p1 + sb)
//                                         - roll(P2, l_p2 + sc)), +-hw),
//           f = f(x), P1 and P2 the launch's input tiles i + s1, i + s2.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; the
// Box-Muller pair (n1 its cosine half, n2 its sine half) takes its uniforms
// from streams 0 and 1, the walk from stream 2, over the dimensions, counter
// (lane, block of four dimensions, global step, stream); u_ab is word 0 of
// the call (lane, 0, global step, 3).  With the four given as operands (one
// step only) the kernel reads them instead.  The walk is drawn, and the
// fresh nest evaluated, only where the lane is abandoned: the result is the
// same as the TPU kernel's, which evaluates every lane.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// log2, 2^x and cos 2 pi x through fast_math.cuh and the objectives header,
// so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin
// (chip_smoke.py: FAM_OPS counts the operations from this source).  Bytes:
// pos and fit read once, written once, best read once: 4 (2 D + 2) N + 4 D
// bytes, 0.26 GB, 0.08 ms at 3.35 TB/s.  Operations: per element and step
// the pair's two Philox calls and uniforms, Box-Muller, the Levy power, the
// flight and its clip, rastrigin, the egg's select; per abandoned element
// the walk's draw, the walk and its clip and rastrigin again; per lane the
// abandonment draw and tests.  Operations bound it.
//
// Design (rule 2's redesign).  The egg roll reads the whole tile's
// candidates of the same generation.  The first version ran a tile in one
// block of 512 threads and sent every generation through device memory
// (its candidates, their fitness and the positions: ~4.5 GB a launch where
// the bound counts 0.26), with two block barriers a generation and at most
// two such blocks an SM.  Two variants now, which the wrapper's geometry
// picks (ops/cuda/cuckoo_fused.py: cuckoo_geometry) and the entry checks:
//
// Variant 0, the tile on chip across a thread-block cluster (the TPU
// kernel's tile resident in VMEM).  A tile's state (positions and a
// generation's candidates with their fitness: 8 D + 4 bytes a lane, 1 MB
// at 4,096 x 30) does not fit one SM, so a cluster of C blocks (1, 2, 4,
// 8; 16 with the non-portable size allowed) runs it, block r owning lanes
// r L .. r L + L - 1 (L = ceil(tile_n / C), one thread a lane; at most 256
// lanes where 16 blocks hold the tile, else at most 512) in its shared
// memory for all k generations.  A generation writes its candidates and
// their fitness, meets the cluster at a barrier (cluster.sync), reads its
// egg through distributed shared memory (map_shared_rank; a warp's
// consecutive lanes read a consecutive, wrapping run of egg lanes, so one
// or two owner blocks serve it) and meets the cluster again before it
// walks, so that no block overwrites a candidate that another still reads.
// Blocks of 256 lanes take 63 KB at D = 30, so three fit an SM (24
// warps, the registers capped at 80); two candidate buffers with one
// barrier a generation took 184 KB blocks of 512 lanes, one an SM (16
// warps), and ran slower.  Only the
// walk's snapshots P1 and P2, the launch's read-only input, come from
// global memory, and only for the abandoned lanes; positions and fitness
// go back once.  The arithmetic: the Box-Muller pair's two streams through
// philox_pair.cuh, the walk's and the abandonment's through philox_one.cuh
// (the lane's products once a launch, the step's once a generation);
// templates on D mod 4 (no mask on an element), on the objective (a sum
// of per-dimension terms folds into the candidate and walk loops in the
// plain version's order) and on the draws' source; the lane rotations in
// 32 bits.  The entry launches with cudaLaunchKernelEx and a cluster
// dimension, after cudaOccupancyMaxActiveClusters has shown that the
// cluster can be resident; a refusal is returned, never bypassed.
//
// Variant 1, the tile through global scratch (the first version, kept for
// a tile whose state does not fit 16 blocks: an explicit tile_n above
// 8,192, or D above ~3,500).  One block of up to 512 threads runs a tile,
// each thread holding lanes t, t + 512, ...; each generation writes its
// candidates and their fitness to a global scratch pair, a __syncthreads()
// orders them, then each lane reads its egg; the generations ping-pong
// between the outputs and a second scratch pair in global memory, the last
// landing in the outputs, with a __syncthreads() after each generation's
// writes.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/cuckoo_fused.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox_one.cuh"
#include "philox_pair.cuh"
#include "swarm_objectives.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kMaxThreads = 512;        // variant 1's block
constexpr int kMaxClusterLanes = 512;   // variant 0's block
constexpr int kMaxCluster = 16;

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS).
__constant__ int kLaneShift[8][3] = {
    {1, 45, 89},  {3, 51, 101}, {7, 57, 113}, {11, 63, 5},
    {17, 71, 19}, {23, 77, 31}, {29, 83, 43}, {37, 95, 59},
};

struct CuckooArgs {
  const int* scalars;   // [6] i32: seed, s1, s2, l_egg, l_p1, l_p2
  const float* best;    // [D] the launch's best
  const float* pos;     // [D, N] the launch's input
  const float* fit;     // [N]
  const float* r_levy1; // [D, N] or null: draw in the kernel
  const float* r_levy2; // [D, N]
  const float* r_ab;    // [N]
  const float* r_walk;  // [D, N]
  float* pos_out;       // [D, N]
  float* fit_out;       // [N]
  float* scratch_pos;   // [D, N] variant 1 (the outputs when k_steps == 1)
  float* scratch_fit;   // [N]
  float* cand;          // [D, N] variant 1: a generation's candidates
  float* cand_fit;      // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;       // global index of the launch's first step
  int objective;
  float half_width, pa, step_scale, sigma, neg_inv_beta;
  int lanes;            // variant 0: lanes a block
};

struct Column {
  const float* p;
  size_t stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::fast::levy_power;
using dsa::fast::normal_pair;
using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ float clip(float v, float hw) {
  return dsa::fast::clip(v, -hw, hw);
}

__device__ __forceinline__ int floor_mod(long long v, int m) {
  const long long r = v % m;
  return static_cast<int>(r < 0 ? r + m : r);
}

// --------------------------------------------------------------------------
// Variant 0: the tile on chip across a cluster.
// --------------------------------------------------------------------------

// Shared memory of a block of `lanes` lanes: positions [D][L], a
// generation's candidates [D][L] and their fitness [L], best.
size_t cluster_bytes(int dim, int lanes) {
  return (2ull * dim * lanes + 1ull * lanes + ((dim + 3) & ~3)) *
         sizeof(float);
}

// The Box-Muller normals of chunk q (dimensions 4 q ..): the operands'
// (kHost, one step) or the kernel's pair of streams 0 and 1.
template <int kN, bool kHost>
__device__ __forceinline__ void levy_normals(
    const CuckooArgs& a, const dsa::PhiloxPairLane& pl,
    const dsa::PhiloxPairStep& ps, int lane, int q, float n1[4],
    float n2[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const size_t at = static_cast<size_t>(4 * q + j) * a.n + lane;
      n1[j] = a.r_levy1[at];
      n2[j] = a.r_levy2[at];
    }
  } else {
    dsa::Philox4 w[2];
    dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(q), w);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      normal_pair(dsa::uniform_from_bits(w[0].v[j]),
                  dsa::uniform_from_bits(w[1].v[j]), n1[j], n2[j]);
    }
  }
}

// The walk's uniforms of chunk q: the operand's or stream 2's.
template <int kN, bool kHost>
__device__ __forceinline__ void walk_uniforms(const CuckooArgs& a,
                                              const dsa::PhiloxOneLane& pl,
                                              const dsa::PhiloxOneStep& ps,
                                              int lane, int q, float u[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      u[j] = a.r_walk[static_cast<size_t>(4 * q + j) * a.n + lane];
    }
  } else {
    const dsa::Philox4 w =
        dsa::philox_one_group(pl, ps, static_cast<uint32_t>(q));
#pragma unroll
    for (int j = 0; j < kN; ++j) u[j] = dsa::uniform_from_bits(w.v[j]);
  }
}

// Chunk q of one lane's candidate: x and cand its columns (stride lanes),
// the objective's terms into s.
template <int kN, class Obj>
__device__ __forceinline__ void candidate_chunk(
    const CuckooArgs& a, const float* x, float* cand, const float* best,
    int lanes, int q, const float n1[4], const float n2[4], float& s) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float xv = x[d * lanes];
    const float levy =
        mul(mul(a.sigma, n1[j]), levy_power(n2[j], a.neg_inv_beta));
    const float c = clip(
        add(xv, mul(mul(a.step_scale, levy), sub(xv, best[d]))),
        a.half_width);
    cand[d * lanes] = c;
    if constexpr (Obj::kFold) s = add(s, Obj::term(c));
  }
}

// Chunk q of one abandoned lane's walk over the snapshots' columns.
template <int kN, class Obj>
__device__ __forceinline__ void walk_chunk(const CuckooArgs& a, float* x,
                                           int lanes, const float* x1,
                                           const float* x2, int q,
                                           const float u[4], float& s) {
  const size_t n = static_cast<size_t>(a.n);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float v = clip(
        add(x[d * lanes], mul(u[j], sub(__ldg(x1 + d * n),
                                        __ldg(x2 + d * n)))),
        a.half_width);
    x[d * lanes] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

// At most 80 registers a thread, so that three blocks of 256 lanes fit an
// SM's registers (registers go to a warp 256 at a time: 85 would round to
// 88 and leave room for two).
template <int kR, int kObj, bool kHost>
__global__ void __maxnreg__(80) cuckoo_cluster_kernel(const CuckooArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lanes = a.lanes;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int tile_n = a.tile_n;
  const int n_tiles = a.n / tile_n;
  const int tile = blockIdx.x / csize;
  const int jl = rank * lanes + t;      // this thread's lane in the tile
  const bool live = t < lanes && jl < tile_n;
  const int lane = tile * tile_n + jl;
  const size_t n = static_cast<size_t>(a.n);

  float* s_x = smem;                                        // [D][L]
  float* cand = s_x + static_cast<size_t>(dim) * lanes;     // [D][L]
  float* cfit = cand + static_cast<size_t>(dim) * lanes;    // [L]
  float* s_best = cfit + lanes;                             // [D]
  for (int d = t; d < dim; d += blockDim.x) s_best[d] = a.best[d];
  float* x = s_x + t;
  float f = 0.0f;
  if (live) {
    for (int d = 0; d < dim; ++d) x[d * lanes] = a.pos[d * n + lane];
    f = a.fit[lane];
  }
  __syncthreads();

  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const float* snap1 =
      a.pos + static_cast<size_t>(floor_mod(
                  static_cast<long long>(tile) + a.scalars[1], n_tiles)) *
                  tile_n;
  const float* snap2 =
      a.pos + static_cast<size_t>(floor_mod(
                  static_cast<long long>(tile) + a.scalars[2], n_tiles)) *
                  tile_n;
  const int l_egg = floor_mod(a.scalars[3], tile_n);
  const int l_p1 = floor_mod(a.scalars[4], tile_n);
  const int l_p2 = floor_mod(a.scalars[5], tile_n);
  const dsa::PhiloxPairLane pl =
      dsa::philox_pair_lane(static_cast<uint32_t>(lane));
  const dsa::PhiloxOneLane pw =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), 2u);
  const dsa::PhiloxOneLane pab =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), 3u);
  const int full = dim >> 2;   // chunks of four; kR dimensions after them

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const int row = step & 7;

    // 1. This lane's Levy candidate of the generation.
    if (live) {
      const dsa::PhiloxPairStep ps = dsa::philox_pair_step(pl, ctr, seed);
      float s = -0.0f;
      for (int q = 0; q < full; ++q) {
        float n1[4], n2[4];
        levy_normals<4, kHost>(a, pl, ps, lane, q, n1, n2);
        candidate_chunk<4, Obj>(a, x, cand + t, s_best, lanes, q, n1, n2, s);
      }
      if constexpr (kR != 0) {
        float n1[4], n2[4];
        levy_normals<kR, kHost>(a, pl, ps, lane, full, n1, n2);
        candidate_chunk<kR, Obj>(a, x, cand + t, s_best, lanes, full, n1,
                                 n2, s);
      }
      if constexpr (Obj::kFold) {
        cfit[t] = Obj::close(s, dim);
      } else {
        cfit[t] = Obj::whole(Column{cand + t, static_cast<size_t>(lanes)},
                             dim);
      }
    }
    cluster.sync();   // the tile's candidates of this generation are out

    // 2. The egg drop: lane e of the tile, in the block that owns it.
    if (live) {
      int e = jl - (l_egg + kLaneShift[row][0]) % tile_n;
      if (e < 0) e += tile_n;
      const int owner = e / lanes;
      const int at = e - owner * lanes;
      const float egg_fit = cluster.map_shared_rank(cfit, owner)[at];
      if (egg_fit < f) {
        f = egg_fit;
        const float* egg = cluster.map_shared_rank(cand, owner) + at;
        for (int d = 0; d < dim; ++d) x[d * lanes] = egg[d * lanes];
      }
    }
    cluster.sync();   // every egg is read: the candidates may be rewritten

    // 3. Abandonment: a walk over the rolled snapshots.
    if (live) {
      const float u_ab =
          kHost ? a.r_ab[lane]
                : dsa::uniform_from_bits(
                      dsa::philox_one_group(
                          pab, dsa::philox_one_step(pab, ctr, seed), 0u)
                          .v[0]);
      if (u_ab < a.pa) {
        int j1 = jl - (l_p1 + kLaneShift[row][1]) % tile_n;
        if (j1 < 0) j1 += tile_n;
        int j2 = jl - (l_p2 + kLaneShift[row][2]) % tile_n;
        if (j2 < 0) j2 += tile_n;
        const dsa::PhiloxOneStep ps = dsa::philox_one_step(pw, ctr, seed);
        float s = -0.0f;
        for (int q = 0; q < full; ++q) {
          float u[4];
          walk_uniforms<4, kHost>(a, pw, ps, lane, q, u);
          walk_chunk<4, Obj>(a, x, lanes, snap1 + j1, snap2 + j2, q, u, s);
        }
        if constexpr (kR != 0) {
          float u[4];
          walk_uniforms<kR, kHost>(a, pw, ps, lane, full, u);
          walk_chunk<kR, Obj>(a, x, lanes, snap1 + j1, snap2 + j2, full, u,
                              s);
        }
        if constexpr (Obj::kFold) {
          f = Obj::close(s, dim);
        } else {
          f = Obj::whole(Column{x, static_cast<size_t>(lanes)}, dim);
        }
      }
    }
  }

  if (live) {
    for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = x[d * lanes];
    a.fit_out[lane] = f;
  }
}

// --------------------------------------------------------------------------
// Variant 1: the tile through global scratch (the first version).
// --------------------------------------------------------------------------

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

__global__ void __launch_bounds__(kMaxThreads)
    cuckoo_global_kernel(const CuckooArgs a) {
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  const long long tile_n = a.tile_n;
  const long long n_tiles = a.n / tile_n;
  const long long tile = blockIdx.x;
  const size_t base = static_cast<size_t>(tile * tile_n);

  const bool host_rng = a.r_levy1 != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const float* snap1 = a.pos + wrap(tile + a.scalars[1], n_tiles) * tile_n;
  const float* snap2 = a.pos + wrap(tile + a.scalars[2], n_tiles) * tile_n;
  const long long l_egg = a.scalars[3], l_p1 = a.scalars[4],
                  l_p2 = a.scalars[5];

  const float* src_pos = a.pos;
  const float* src_fit = a.fit;
  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    // The last generation lands in the outputs, the ones before alternate.
    const bool to_out = ((a.k_steps - 1 - step) & 1) == 0;
    float* dst_pos = to_out ? a.pos_out : a.scratch_pos;
    float* dst_fit = to_out ? a.fit_out : a.scratch_fit;

    // 1. Every lane's Levy candidate of this generation.
    for (int jl = t; jl < tile_n; jl += threads) {
      const size_t lane = base + jl;
      for (int d0 = 0; d0 < dim; d0 += 4) {
        float n1[4], n2[4];
        if (host_rng) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool in = d0 + q < dim;
            const size_t off = static_cast<size_t>(d0 + q) * n + lane;
            n1[q] = in ? a.r_levy1[off] : 0.0f;
            n2[q] = in ? a.r_levy2[off] : 0.0f;
          }
        } else {
          const uint32_t g = static_cast<uint32_t>(d0 >> 2);
          const uint32_t c0 = static_cast<uint32_t>(lane);
          const dsa::Philox4 p0 = dsa::philox4x32_10(c0, g, ctr, 0u, seed, 0u);
          const dsa::Philox4 p1 = dsa::philox4x32_10(c0, g, ctr, 1u, seed, 0u);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            normal_pair(dsa::uniform_from_bits(p0.v[q]),
                        dsa::uniform_from_bits(p1.v[q]), n1[q], n2[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = d0 + q;
          if (d < dim) {
            const size_t off = static_cast<size_t>(d) * n + lane;
            const float x = src_pos[off];
            const float levy =
                mul(mul(a.sigma, n1[q]), levy_power(n2[q], a.neg_inv_beta));
            a.cand[off] = clip(
                add(x, mul(mul(a.step_scale, levy), sub(x, a.best[d]))),
                a.half_width);
          }
        }
      }
      a.cand_fit[lane] =
          dsa::evaluate_objective(a.objective, Column{a.cand + lane, n}, dim);
    }
    __syncthreads();

    // 2. The egg drop, then abandonment.
    const int sa = kLaneShift[step & 7][0];
    const int sb = kLaneShift[step & 7][1];
    const int sc = kLaneShift[step & 7][2];
    for (int jl = t; jl < tile_n; jl += threads) {
      const size_t lane = base + jl;
      const size_t egg = base + wrap(jl - l_egg - sa, tile_n);
      const float egg_fit = a.cand_fit[egg];
      float f = src_fit[lane];
      const bool accept = egg_fit < f;
      const float* own = accept ? a.cand + egg : src_pos + lane;
      if (accept) f = egg_fit;
      const float u_ab =
          host_rng ? a.r_ab[lane]
                   : dsa::uniform_from_bits(
                         dsa::philox4x32_10(static_cast<uint32_t>(lane), 0u,
                                            ctr, 3u, seed, 0u).v[0]);
      if (u_ab < a.pa) {
        const float* x1 = snap1 + wrap(jl - l_p1 - sb, tile_n);
        const float* x2 = snap2 + wrap(jl - l_p2 - sc, tile_n);
        for (int d0 = 0; d0 < dim; d0 += 4) {
          float u[4];
          if (host_rng) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              u[q] = d0 + q < dim
                         ? a.r_walk[static_cast<size_t>(d0 + q) * n + lane]
                         : 0.0f;
            }
          } else {
            const dsa::Philox4 p = dsa::philox4x32_10(
                static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2),
                ctr, 2u, seed, 0u);
#pragma unroll
            for (int q = 0; q < 4; ++q) u[q] = dsa::uniform_from_bits(p.v[q]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int d = d0 + q;
            if (d < dim) {
              const size_t off = static_cast<size_t>(d) * n;
              dst_pos[off + lane] = clip(
                  add(own[off], mul(u[q], sub(x1[off], x2[off]))),
                  a.half_width);
            }
          }
        }
        f = dsa::evaluate_objective(a.objective, Column{dst_pos + lane, n},
                                    dim);
      } else {
        for (int d = 0; d < dim; ++d) {
          const size_t off = static_cast<size_t>(d) * n;
          dst_pos[off + lane] = own[off];
        }
      }
      dst_fit[lane] = f;
    }
    __syncthreads();
    src_pos = dst_pos;
    src_fit = dst_fit;
  }
}

// Variant 1's threads for a tile of `tile_n` lanes.
int global_threads(int tile_n) {
  const int warps = (tile_n + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

template <int kR, int kObj, bool kHost>
cudaError_t launch_cluster(const CuckooArgs& a, int cluster, int threads,
                           size_t shared, cudaStream_t s) {
  auto* kernel = cuckoo_cluster_kernel<kR, kObj, kHost>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>((a.n / a.tile_n) * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = shared;
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const CuckooArgs& a, int cluster, int threads,
                          size_t shared, cudaStream_t s) {
  return a.r_levy1 != nullptr
             ? launch_cluster<kR, kObj, true>(a, cluster, threads, shared, s)
             : launch_cluster<kR, kObj, false>(a, cluster, threads, shared,
                                               s);
}

template <int kR>
cudaError_t launch_objective(const CuckooArgs& a, int cluster, int threads,
                             size_t shared, cudaStream_t s) {
#define DSA_CUCKOO_CASE(k) \
  case dsa::k:             \
    return launch_source<kR, dsa::k>(a, cluster, threads, shared, s);
  switch (a.objective) {
    DSA_CUCKOO_CASE(kSphere)
    DSA_CUCKOO_CASE(kRastrigin)
    DSA_CUCKOO_CASE(kAckley)
    DSA_CUCKOO_CASE(kRosenbrock)
    DSA_CUCKOO_CASE(kGriewank)
    DSA_CUCKOO_CASE(kSchwefel)
    DSA_CUCKOO_CASE(kLevy)
    DSA_CUCKOO_CASE(kZakharov)
    DSA_CUCKOO_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, cluster, threads,
                                                  shared, s);
  }
#undef DSA_CUCKOO_CASE
}

// Whether the entry runs `variant` with this cluster, lanes, threads and
// shared bytes for a tile of tile_n lanes at this D: variant 0 needs a
// cluster of 1, 2, 4, 8 or 16 blocks of ceil(tile_n / cluster) <= 512
// lanes, a thread a lane in whole warps, and exactly its bytes within a
// block's shared memory; variant 1 one block a tile of the first version's
// threads and no dynamic shared memory.
bool geometry_ok(int variant, int cluster, int lanes, int threads,
                 int shared, int tile_n, int dim) {
  if (variant == 0) {
    return (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
            cluster == kMaxCluster) &&
           lanes == (tile_n + cluster - 1) / cluster &&
           lanes <= kMaxClusterLanes && threads == (lanes + 31) / 32 * 32 &&
           static_cast<size_t>(shared) == cluster_bytes(dim, lanes) &&
           static_cast<size_t>(shared) <= kMaxSharedBytes;
  }
  return variant == 1 && cluster == 1 && lanes == tile_n &&
         threads == global_threads(tile_n) && shared == 0;
}

}  // namespace

// Threads of variant 1's block for a tile of `tile_n` lanes.
extern "C" int dsa_cuckoo_fused_threads(int tile_n) {
  return global_threads(tile_n);
}

// All arrays f32, contiguous, on `device`: best [D], pos [D, N], fit [N],
// the draws r_levy1, r_levy2 [D, N], r_ab [N], r_walk [D, N] (all four or
// none), pos_out [D, N], fit_out [N]; for variant 1 the scratch pair of
// the same shapes (only read as a distinct pair when k_steps > 1) and the
// candidates' pair cand [D, N], cand_fit [N] (null for variant 0);
// scalars [6] i32.  N is a multiple of tile_n.  The geometry (variant,
// cluster, lanes a block, threads a block, shared bytes a block) is the
// wrapper's (cuckoo_geometry); one this entry cannot run is refused, as is
// a cluster the card cannot make resident.  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_cuckoo_fused_f32(
    const int* scalars, const float* best, const float* pos, const float* fit,
    const float* r_levy1, const float* r_levy2, const float* r_ab,
    const float* r_walk, float* pos_out, float* fit_out, float* scratch_pos,
    float* scratch_fit, float* cand, float* cand_fit, int n, int dim,
    int tile_n, int k_steps, unsigned step0, int objective, float half_width,
    float pa, float step_scale, float sigma, float neg_inv_beta, int variant,
    int cluster, int lanes, int threads, int shared, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool some = r_levy1 || r_levy2 || r_ab || r_walk;
  const bool all = r_levy1 && r_levy2 && r_ab && r_walk;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      some != all || (all && k_steps != 1) ||
      !geometry_ok(variant, cluster, lanes, threads, shared, tile_n, dim) ||
      (variant == 1 &&
       (!scratch_pos || !scratch_fit || !cand || !cand_fit ||
        (k_steps > 1 &&
         (scratch_pos == pos_out || scratch_fit == fit_out))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CuckooArgs a{scalars, best, pos, fit, r_levy1, r_levy2, r_ab,
                     r_walk, pos_out, fit_out, scratch_pos, scratch_fit,
                     cand, cand_fit, n, dim, tile_n, k_steps, step0,
                     objective, half_width, pa, step_scale, sigma,
                     neg_inv_beta, lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, cluster, threads, shared, s); break;
      case 1: err = launch_objective<1>(a, cluster, threads, shared, s); break;
      case 2: err = launch_objective<2>(a, cluster, threads, shared, s); break;
      default: err = launch_objective<3>(a, cluster, threads, shared, s);
    }
    return static_cast<int>(err);
  }
  cuckoo_global_kernel<<<static_cast<unsigned>(n / tile_n), threads, 0, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
