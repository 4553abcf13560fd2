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
// Design (rule 2's redesign).  The employed partner rolls the tile's
// current sources and the gate takes a maximum over the tile, so a tile
// moves in step.  The first version (2.70 ms a launch at that shape on an
// NVIDIA H100 80GB HBM3 at 700 W, 15x the bound; PERF.md) ran a tile in one
// block of 512 threads, sent every cycle's whole tile through a global
// ping-pong scratch, read every coordinate of base and partner from global
// memory to evaluate a candidate and again to write it, and drew the row
// words twice a lane-cycle.  Two variants now, which the wrapper's geometry
// picks (ops/cuda/abc_fused.py: abc_geometry) and the entry checks:
//
// Variant 0, the tile on chip across a thread-block cluster (the TPU
// kernel's tile resident in VMEM), as the cuckoo kernel keeps its eggs.  A
// cluster of C blocks (1, 2, 4, 8; 16 with the non-portable size allowed)
// runs a tile, block r owning lanes r L .. r L + L - 1 (L = ceil(tile_n /
// C), one thread a lane; at most 256 lanes where 16 blocks hold the tile,
// else at most 512), their sources [D][L] in its shared memory for the
// whole launch (30 KB a block of 256 at D = 30); each lane's fitness and
// trials stay in registers.  The launch's input is read once and the
// outputs written once; no global scratch.
//   - A candidate differs from its base in coordinate j only, so a lane
//     reads one coordinate of its partner: the employed bee the current
//     partner's through distributed shared memory (map_shared_rank), the
//     onlooker the snapshot partner's from the launch's input, which the
//     launch never writes.  Elsewhere the candidate's coordinate is the
//     base's own: clip(b + 0 (...)) is b for every b inside +-half_width,
//     as every position of a run is (drawn inside, clipped, or a scout's
//     draw), except that a base of -0 may come out +0, which torch.equal
//     and every objective treat as equal.  On acceptance only coordinate j
//     is written.  Positions outside the domain are not the kernel's input:
//     there the plain version clips every coordinate of an accepted
//     candidate and this kernel only coordinate j.
//   - Two cluster barriers a cycle order its reads and writes: (A) at the
//     cycle's start, so that the previous cycle's onlooker and scout writes
//     (or the launch's load) are visible to the employed reads; (B) after
//     the employed evaluation, so that every employed read of a partner is
//     done before any employed write, and every block's largest quality
//     (reduced over its warps behind a __syncthreads) is published.  After
//     (B) each warp reads every block's maximum through distributed shared
//     memory, so the onlooker gate needs no third barrier.  One more
//     barrier after the last cycle keeps every block's shared memory alive
//     until the last maximum is read: 2 k + 1 cluster barriers a launch.
//   - The row words are drawn once a lane-cycle with philox_one.cuh on
//     stream 1 (groups 0 and 1), the lane's products once a launch; the
//     scout plane on stream 0 only where a lane is exhausted.
//   - Templates on D mod 4, the objective (a sum of per-dimension terms is
//     folded over the candidate's coordinates in ascending d from -0, the
//     plain version's order; the others evaluate a column that substitutes
//     coordinate j) and the draws' source.
//   The entry launches with cudaLaunchKernelEx and a cluster dimension,
//   after cudaOccupancyMaxActiveClusters has shown that the cluster can be
//   resident; a refusal is returned, never bypassed.
//
// Variant 1, the tile through global scratch (the first version, kept for a
// tile whose sources do not fit 16 blocks: an explicit tile_n above 8,192,
// or D above 226 at tiles of 4,096).  One block of up to 512 threads runs a
// tile, each thread holding lanes t, t + 512, ...; the cycles ping-pong in
// global memory between the outputs and a scratch triple, the last landing
// in the outputs; a cycle reads the previous one (its source) and writes
// the next (its destination), so the employed partner reads never meet a
// write, and a __syncthreads() after each cycle's writes orders them.  A
// candidate is evaluated from a functor over the base and the partner, and
// written out only where accepted.  The maximum of the quality is a block
// reduction between the employed and the onlooker phases.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/abc_fused.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox_one.cuh"
#include "swarm_objectives.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kMaxThreads = 512;        // variant 1's block
constexpr int kMaxClusterLanes = 512;   // variant 0's block
constexpr int kMaxCluster = 16;
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
  float* scratch_pos;   // [D, N] variant 1 (the outputs when k_steps == 1)
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
  int lanes;            // variant 0: lanes a block
};

using dsa::obj::add;
using dsa::obj::div;
using dsa::obj::mul;
using dsa::obj::sub;

// No NaN reaches a clip here (the moves draw no normals), so the plain
// fminf/fmaxf form is torch.clamp's.
__device__ __forceinline__ float clip(float v, float hw) {
  return fminf(fmaxf(v, -hw), hw);
}

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

__device__ __forceinline__ int floor_mod(long long v, int m) {
  const long long r = v % m;
  return static_cast<int>(r < 0 ? r + m : r);
}

// --------------------------------------------------------------------------
// Variant 0: the tile on chip across a cluster.
// --------------------------------------------------------------------------

// Warps a block may hold, each with a slot for its largest quality.
constexpr int kMaxWarps = kMaxClusterLanes / 32;

// Shared memory of a block of `lanes` lanes: their sources [D][L], then
// each warp's largest quality and the block's (all of it dynamic, so that
// the geometry's bytes are the block's).
size_t cluster_bytes(int dim, int lanes) {
  return (static_cast<size_t>(dim) * lanes + kMaxWarps + 1) * sizeof(float);
}

// A candidate's coordinates: the base's column (stride `lanes`) with
// coordinate j replaced by cj.
struct Mutant {
  const float* x;
  int lanes;
  int j;
  float cj;
  __device__ __forceinline__ float operator()(int d) const {
    const float v = x[d * lanes];
    return d == j ? cj : v;
  }
};

// Chunk q of a candidate's folded objective: its coordinates' terms into s.
template <int kN, class Obj>
__device__ __forceinline__ void mutant_chunk(const Mutant& m, int q,
                                             float& s) {
#pragma unroll
  for (int i = 0; i < kN; ++i) s = add(s, Obj::term(m(4 * q + i)));
}

// The objective at the candidate m.
template <int kR, class Obj>
__device__ __forceinline__ float mutant_fit(const Mutant& m, int dim) {
  if constexpr (Obj::kFold) {
    float s = -0.0f;
    const int full = dim >> 2;
#pragma unroll 1
    for (int q = 0; q < full; ++q) mutant_chunk<4, Obj>(m, q, s);
    if constexpr (kR != 0) mutant_chunk<kR, Obj>(m, full, s);
    return Obj::close(s, dim);
  } else {
    return Obj::whole(m, dim);
  }
}

// The five row uniforms of `lane` at counter `ctr`: the operand's (kHost,
// one step) or stream 1's groups 0 and 1.
template <bool kHost>
__device__ __forceinline__ void row_draws(const AbcArgs& a,
                                          const dsa::PhiloxOneLane& pl,
                                          uint32_t ctr, uint32_t seed,
                                          int lane, float r[5]) {
  if constexpr (kHost) {
    const size_t n = static_cast<size_t>(a.n);
#pragma unroll
    for (int k = 0; k < 5; ++k) r[k] = a.rows[k * n + lane];
  } else {
    const dsa::PhiloxOneStep ps = dsa::philox_one_step(pl, ctr, seed);
    const dsa::Philox4 p0 = dsa::philox_one_group(pl, ps, 0u);
    const dsa::Philox4 p1 = dsa::philox_one_group(pl, ps, 1u);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = dsa::uniform_from_bits(p0.v[k]);
    r[4] = dsa::uniform_from_bits(p1.v[0]);
  }
}

// A scout: a fresh source in the lane's column; returns its objective.
// One loop over the groups of four dimensions, the last one masked: the
// path is rare, and a single loop keeps it apart in the SASS census of the
// cycle (chip_smoke.py: abc_issue_floor).
template <class Obj, bool kHost>
__device__ __forceinline__ float scout(const AbcArgs& a, float* x, int lanes,
                                       int lane, uint32_t ctr,
                                       uint32_t seed) {
  const dsa::PhiloxOneLane pl =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), 0u);
  const dsa::PhiloxOneStep ps = dsa::philox_one_step(pl, ctr, seed);
  const int dim = a.dim;
  float s = -0.0f;
#pragma unroll 1
  for (int q = 0; 4 * q < dim; ++q) {
    float u[4];
    if constexpr (kHost) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u[i] = 4 * q + i < dim
                   ? a.fresh[static_cast<size_t>(4 * q + i) * a.n + lane]
                   : 0.0f;
      }
    } else {
      const dsa::Philox4 w =
          dsa::philox_one_group(pl, ps, static_cast<uint32_t>(q));
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = dsa::uniform_from_bits(w.v[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * q + i < dim) {
        const float v = mul(sub(mul(2.0f, u[i]), 1.0f), a.half_width);
        x[(4 * q + i) * lanes] = v;
        if constexpr (Obj::kFold) s = add(s, Obj::term(v));
      }
    }
  }
  if constexpr (Obj::kFold) {
    return Obj::close(s, dim);
  } else {
    return Obj::whole(Column{x, static_cast<size_t>(lanes)}, dim);
  }
}

// Coordinate j of mutate(b, p, u_dim, u_phi): j = floor(u_dim D) and the
// moved value (j = D moves nothing).
__device__ __forceinline__ float moved(float b, float p, float u_phi,
                                       float hw) {
  return clip(add(b, mul(sub(mul(2.0f, u_phi), 1.0f), sub(b, p))), hw);
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kMaxClusterLanes)
    abc_cluster_kernel(const AbcArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lanes = a.lanes;
  const int t = threadIdx.x;
  const int warps = blockDim.x >> 5;
  const int dim = a.dim;
  const int tile_n = a.tile_n;
  const int n_tiles = a.n / tile_n;
  const int tile = blockIdx.x / csize;
  const int jl = rank * lanes + t;      // this thread's lane in the tile
  const bool live = t < lanes && jl < tile_n;
  const int lane = tile * tile_n + jl;
  const size_t n = static_cast<size_t>(a.n);
  const float hw = a.half_width;
  const float fdim = static_cast<float>(dim);
  const float neg_inf = -__int_as_float(0x7f800000);

  float* x = smem + t;                  // this lane's column, stride L
  float* s_warp_max = smem + static_cast<size_t>(dim) * lanes;
  float* s_block_max = s_warp_max + kMaxWarps;
  float f = 0.0f;
  int tr = 0;
  if (live) {
    for (int d = 0; d < dim; ++d) x[d * lanes] = a.pos[d * n + lane];
    f = a.fit[lane];
    tr = a.trials[lane];
  }

  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const float* snap =
      a.pos + static_cast<size_t>(floor_mod(
                  static_cast<long long>(tile) + a.scalars[1], n_tiles)) *
                  tile_n;
  const int dl1 = floor_mod(a.scalars[2], tile_n);
  const int dl2 = floor_mod(a.scalars[3], tile_n);
  const dsa::PhiloxOneLane pl =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), kRowStream);

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const int row = step & 7;
    cluster.sync();   // (A) the previous cycle's writes are visible

    // 1. Employed bees: one coordinate of the current partner, read
    // through distributed shared memory.
    float r[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int j1 = 0;
    float c1 = 0.0f;
    bool took = false;
    float q = neg_inf;
    if (live) {
      row_draws<kHost>(a, pl, ctr, seed, lane, r);
      j1 = static_cast<int>(floorf(mul(r[0], fdim)));
      const int jr = min(j1, dim - 1);
      int e = jl - (dl1 + kLaneShift[row][0]) % tile_n;
      if (e < 0) e += tile_n;
      const int owner = e / lanes;
      const float p =
          cluster.map_shared_rank(smem, owner)[jr * lanes + e - owner * lanes];
      c1 = moved(x[jr * lanes], p, r[1], hw);
      const float cfit = mutant_fit<kR, Obj>(Mutant{x, lanes, j1, c1}, dim);
      took = cfit < f;
      if (took) {
        f = cfit;
        tr = 0;
      } else {
        tr += 1;
      }
      q = quality(f);
    }
    // The block's largest quality, for the gate.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      q = fmaxf(q, __shfl_xor_sync(0xffffffffu, q, off));
    }
    if ((t & 31) == 0) s_warp_max[t >> 5] = q;
    __syncthreads();
    if (t < 32) {
      float m = t < warps ? s_warp_max[t] : neg_inf;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (t == 0) *s_block_max = m;
    }
    cluster.sync();   // (B) every employed read is done; every maximum out

    if (took && j1 < dim) x[j1 * lanes] = c1;
    // The tile's largest quality: lane i of each warp reads block i's.
    float qmax = (t & 31) < csize
                     ? *cluster.map_shared_rank(s_block_max, t & 31)
                     : neg_inf;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
    const float gate_den = fmaxf(qmax, 1e-12f);

    // 2. Onlooker bees: one coordinate of the snapshot partner, from the
    // launch's input; then scouts.
    if (live) {
      if (r[2] < div(quality(f), gate_den)) {
        const int j2 = static_cast<int>(floorf(mul(r[3], fdim)));
        const int jr = min(j2, dim - 1);
        int e = jl - (dl2 + kLaneShift[row][1]) % tile_n;
        if (e < 0) e += tile_n;
        const float c2 = moved(x[jr * lanes],
                               __ldg(snap + static_cast<size_t>(jr) * n + e),
                               r[4], hw);
        const float cfit = mutant_fit<kR, Obj>(Mutant{x, lanes, j2, c2}, dim);
        if (cfit < f) {
          if (j2 < dim) x[j2 * lanes] = c2;
          f = cfit;
          tr = 0;
        } else {
          tr += 1;
        }
      }
      if (tr > a.limit) {
        f = scout<Obj, kHost>(a, x, lanes, lane, ctr, seed);
        tr = 0;
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its maximum

  if (live) {
    for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = x[d * lanes];
    a.fit_out[lane] = f;
    a.trials_out[lane] = tr;
  }
}

// --------------------------------------------------------------------------
// Variant 1: the tile through global scratch (the first version).
// --------------------------------------------------------------------------

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

// Coordinate d of mutate(base, partner): every dimension computed as the
// one-hot product computes it.
struct GlobalMutant {
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

// The five row uniforms of `lane` at counter `ctr`.
__device__ __forceinline__ void global_row_draws(const AbcArgs& a,
                                                 bool host_rng, uint32_t seed,
                                                 uint32_t ctr, size_t lane,
                                                 float r[5]) {
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
    abc_global_kernel(const AbcArgs a) {
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
      global_row_draws(a, host_rng, seed, ctr, lane, r);
      const GlobalMutant m{src_pos + lane,
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
      global_row_draws(a, host_rng, seed, ctr, lane, r);
      float f = dst_fit[lane];
      int tr = dst_tr[lane];
      if (r[2] < div(quality(f), gate_den)) {
        const GlobalMutant m{dst_pos + lane,
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

// Variant 1's threads for a tile of `tile_n` lanes.
int global_threads(int tile_n) {
  const int warps = (tile_n + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

template <int kR, int kObj, bool kHost>
cudaError_t launch_cluster(const AbcArgs& a, int cluster, int threads,
                           size_t shared, cudaStream_t s) {
  auto* kernel = abc_cluster_kernel<kR, kObj, kHost>;
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
cudaError_t launch_source(const AbcArgs& a, int cluster, int threads,
                          size_t shared, cudaStream_t s) {
  return a.rows != nullptr
             ? launch_cluster<kR, kObj, true>(a, cluster, threads, shared, s)
             : launch_cluster<kR, kObj, false>(a, cluster, threads, shared,
                                               s);
}

template <int kR>
cudaError_t launch_objective(const AbcArgs& a, int cluster, int threads,
                             size_t shared, cudaStream_t s) {
#define DSA_ABC_CASE(k) \
  case dsa::k:          \
    return launch_source<kR, dsa::k>(a, cluster, threads, shared, s);
  switch (a.objective) {
    DSA_ABC_CASE(kSphere)
    DSA_ABC_CASE(kRastrigin)
    DSA_ABC_CASE(kAckley)
    DSA_ABC_CASE(kRosenbrock)
    DSA_ABC_CASE(kGriewank)
    DSA_ABC_CASE(kSchwefel)
    DSA_ABC_CASE(kLevy)
    DSA_ABC_CASE(kZakharov)
    DSA_ABC_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, cluster, threads,
                                                  shared, s);
  }
#undef DSA_ABC_CASE
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
extern "C" int dsa_abc_fused_threads(int tile_n) {
  return global_threads(tile_n);
}

// pos [D, N], fit [N] f32 and trials [N] i32, the draws rows [5, N] and
// fresh [D, N] f32 (both or none), the outputs of the same shapes, all
// contiguous on `device`; for variant 1 the scratch triple of the same
// shapes (only read as a distinct triple when k_steps > 1; null for
// variant 0); scalars [4] i32.  N is a multiple of tile_n.  Positions lie
// inside +-half_width.  The geometry (variant, cluster, lanes a block,
// threads a block, shared bytes a block) is the wrapper's (abc_geometry);
// one this entry cannot run is refused, as is a cluster the card cannot
// make resident.  Launched on `stream` without synchronising.  Returns the
// CUDA error of the launch (0 when accepted).
extern "C" int dsa_abc_fused_f32(
    const int* scalars, const float* pos, const float* fit,
    const int* trials, const float* rows, const float* fresh,
    float* pos_out, float* fit_out, int* trials_out, float* scratch_pos,
    float* scratch_fit, int* scratch_trials, int n, int dim, int tile_n,
    int k_steps, unsigned step0, int objective, int limit, float half_width,
    int variant, int cluster, int lanes, int threads, int shared, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      (rows == nullptr) != (fresh == nullptr) || (rows && k_steps != 1) ||
      !geometry_ok(variant, cluster, lanes, threads, shared, tile_n, dim) ||
      (variant == 1 &&
       (!scratch_pos || !scratch_fit || !scratch_trials ||
        (k_steps > 1 && (scratch_pos == pos_out || scratch_fit == fit_out ||
                         scratch_trials == trials_out))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AbcArgs a{scalars, pos, fit, trials, rows, fresh, pos_out, fit_out,
                  trials_out, scratch_pos, scratch_fit, scratch_trials, n,
                  dim, tile_n, k_steps, step0, objective, limit, half_width,
                  lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, cluster, threads, shared, s); break;
      case 1: err = launch_objective<1>(a, cluster, threads, shared, s); break;
      case 2: err = launch_objective<2>(a, cluster, threads, shared, s); break;
      default: err = launch_objective<3>(a, cluster, threads, shared, s);
    }
    // A refused call leaves its error pending: clear it, so that the next
    // launch does not report it as its own.
    if (err != cudaSuccess) cudaGetLastError();
    return static_cast<int>(err);
  }
  abc_global_kernel<<<static_cast<unsigned>(n / tile_n), threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
