// Fused whale-optimization steps for Hopper (sm_90a): k pod updates in one
// pass.
//
// dsa_woa_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/woa_fused.py:fused_woa_step_t
//   (body _make_kernel).
//
// What one launch computes, for pos in the transposed layout [D, N] (whales
// along the fast axis), N a whole number of tiles of tile_n lanes, and the
// incumbent best held fixed, k_steps times:
//
//   a = 2 (1 - min((t0 + step) / t_max, 1));  A = 2 a u_a - a;  C = 2 u_c
//   peer = lane (j - s) mod tile_n of tile (i + tshift) mod n_tiles of the
//          launch's INPUT, for lane j of tile i, s = lshift + shift[step % 8]
//   p < 1/2:  prey = |A| >= 1 ? peer : best (per element)
//             x = prey - A |C prey - x|
//   else:     l = 2 u_l - 1;  x = |best - x| e^{b l} cos(2 pi l) + best
//   x clipped to +-half_width
//
// and then, once, fit = objective(x).  The peer is the block-start snapshot
// of another tile, a roll of its lanes (jnp.roll's direction); t0, tshift
// and lshift are read from the device.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed.  u_a is
// stream 0 and u_c stream 1 over the dimensions, counter (lane, block of
// four dimensions, global step, stream); p and u_l are words 0 and 1 of the
// call (lane, 0, global step, 2).  No launch geometry enters, so the plain
// PyTorch version draws the same numbers; with the four draws given as
// operands (one step only) the kernel reads them instead.  A lane draws
// only what its branch reads: u_a and u_c only where it contracts.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// e^{b l} calls expf as torch.exp does on the card, cos(2 pi l) is the
// header's polynomial.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin.  Bytes:
// pos read and written once, fit written: 4 (2 D + 1) N bytes, 0.26 GB,
// 0.08 ms at 3.35 TB/s (the peer reads come from the same input).
// Operations a whale's step needs, its branch's alone: every whale the row
// call and its two uniforms and the branch test (107) and the clip (2) an
// element; a contracting whale A's and C's draws (56), A and C (3), the
// explore test and select (3) and the contraction (5) an element, and the
// peer's lane (5); a spiralling whale the spiral (5) an element, and l,
// e^{b l} and cos 2 pi l (30); the schedule once a step; rastrigin once a
// launch (chip_smoke.py: ZOO_OPS, WOA_BRANCH_OPS, the contracting elements
// from the plain version's tally).  Operations bound it.
//
// Design (rule 2's redesign).  The first version (0.770 ms a launch at the
// main path's shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) ran one
// thread a whale in the whales' order, so every warp ran both branches; it
// drew A's and C's uniforms with two full philox4x32_10 calls a group of
// four at every lane, though only a contracting whale (about half) reads
// them, and the row with a third; it masked every element with d < D and
// evaluated through a runtime switch.  Two variants now, which the
// wrapper's geometry picks (ops/cuda/woa_fused.py: woa_geometry) and the
// entry checks:
//
// Variant 0, lanes regrouped by branch (D <= 224; the main path).  A block
// of 256 whales stages their positions [D][256] and the best, and at every
// step:
//   - each thread draws its own lane's row words (stream 2, philox_one.cuh
//     on the lane's products, once a launch) and classifies the lane as
//     contracting (u_p < 1/2) or spiralling;
//   - the block sorts its lanes by class, stably: two warp ballots, their
//     popcounts packed into one word a warp, a prefix over the warps, a
//     barrier; each lane's place is its class's start, its warp's count of
//     the class before it and its rank in the ballot; the lane and its u_l
//     go to that place, and a second barrier publishes them
//     (ops/cuda/woa_fused.py: branch_order is the same order in PyTorch);
//   - thread i advances the lane at place i: its position stays in the
//     lane's own column, so only the warp at the class boundary diverges
//     and each lane's arithmetic is unchanged, bit for bit;
//   - a contracting lane draws u_a and u_c with one philox_pair_group call
//     a group of four and loads the chunk's four peer coordinates together,
//     each behind its |A| >= 1 test (loading them always would add 4 D N
//     bytes a step); a spiralling lane draws nothing beyond its row;
//   - templates on D mod 4 (the chunks of four run unmasked), on the
//     objective (a sum of per-dimension terms folds into the last pass,
//     which writes the positions out; the others evaluate after it) and on
//     the draws' source.
//
// Variant 1, the first version, kept as it was (woa_lane_kernel) for the
// widths variant 0 does not hold: one thread per whale, as B5, the whales'
// pos staged as [D][block], the peer read straight from the input; 128
// threads where D 128 floats fit the 227 KB a block may take, else 64,
// else 32 (D <= 1816).
//
// Above 48 KB of shared memory a block the entry opts in with
// cudaFuncSetAttribute.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/woa_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "philox_one.cuh"
#include "philox_pair.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr uint32_t kRowStream = 2;
constexpr int kLanes = 256;              // variant 0's block
constexpr int kWarps = kLanes / 32;
// Variant 0's blocks an SM that its registers must allow (51 a thread;
// its shared memory holds 6 at D = 30): five ran faster than four at the
// main path's shape, with no spills.
constexpr int kMinBlocks = 5;
constexpr unsigned kFull = 0xffffffffu;

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS, first
// column): the peer's roll is lshift + kLaneShift[step % 8].
__constant__ int kLaneShift[8] = {1, 3, 7, 11, 17, 23, 29, 37};

struct WoaArgs {
  const int* scalars;     // [4] i32 on the device: seed, tshift, t0, lshift
  const float* best;      // [D]
  const float* pos;       // [D, N]
  const float* r_a;       // [D, N] or null: draw in the kernel
  const float* r_c;       // [D, N]
  const float* r_p;       // [N]
  const float* r_l;       // [N]
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float t_max, spiral_b, half_width;
};

struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::obj::add;
using dsa::obj::div;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ float clip(float v, float hw) {
  return fminf(fmaxf(v, -hw), hw);
}

__device__ __forceinline__ int wrap32(int v, int m) {
  return (v % m + m) % m;
}

// --------------------------------------------------------------------------
// Variant 0: lanes regrouped by branch.
// --------------------------------------------------------------------------

// Dynamic shared memory of a variant-0 block: the whales' positions
// [D][256], the best (padded to four), the sorted lanes and their u_l
// [256] each, and the warps' class counts [8].
size_t sorted_bytes(int dim) {
  return (1ull * dim * kLanes + ((dim + 3) & ~3) + 2ull * kLanes + kWarps) *
         sizeof(float);
}

// What a thread knows of the lane it advances at one step.
struct Whale {
  float* x;             // the lane's column, stride kLanes
  const float* best;    // the staged best
  size_t n;
  int lane;
  float hw;
};

// Chunk q of a contracting lane: A's and C's uniforms (the pair call, or
// the host planes), the four peer coordinates loaded together where |A| >=
// 1, then the moves.
template <int kN, bool kHost>
__device__ __forceinline__ void contract_chunk(
    const WoaArgs& a, const Whale& w, const dsa::PhiloxPairLane& pl,
    const dsa::PhiloxPairStep& ps, const float* peer, float aa, float two_a,
    int q) {
  const int d0 = 4 * q;
  float ua[4], uc[4];
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      ua[j] = a.r_a[static_cast<size_t>(d0 + j) * w.n + w.lane];
      uc[j] = a.r_c[static_cast<size_t>(d0 + j) * w.n + w.lane];
    }
  } else {
    dsa::Philox4 u[2];
    dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(q), u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ua[j] = dsa::uniform_from_bits(u[0].v[j]);
      uc[j] = dsa::uniform_from_bits(u[1].v[j]);
    }
  }
  float big_a[4], prey[4];
#pragma unroll
  for (int j = 0; j < kN; ++j) big_a[j] = sub(mul(two_a, ua[j]), aa);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    prey[j] = fabsf(big_a[j]) >= 1.0f
                  ? peer[static_cast<size_t>(d0 + j) * w.n]
                  : w.best[d0 + j];
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = d0 + j;
    const float x = w.x[d * kLanes];
    const float big_c = mul(2.0f, uc[j]);
    const float v =
        sub(prey[j], mul(big_a[j], fabsf(sub(mul(big_c, prey[j]), x))));
    w.x[d * kLanes] = clip(v, w.hw);
  }
}

// Chunk q of a spiralling lane.
template <int kN>
__device__ __forceinline__ void spiral_chunk(const Whale& w, float scale,
                                             float cosv, int q) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float x = w.x[d * kLanes];
    const float b = w.best[d];
    w.x[d * kLanes] =
        clip(add(mul(mul(fabsf(sub(b, x)), scale), cosv), b), w.hw);
  }
}

// Chunk q of the last pass: the lane's coordinates written out, their
// objective terms folded into s.
template <int kN, class Obj>
__device__ __forceinline__ void out_chunk(const WoaArgs& a, const float* x,
                                          size_t lane, int q, float& s) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float v = x[d * kLanes];
    a.pos_out[static_cast<size_t>(d) * a.n + lane] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
    woa_sorted_kernel(const WoaArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const unsigned below_me = (1u << (t & 31)) - 1u;
  const int dim = a.dim;
  const int d4 = (dim + 3) & ~3;
  const size_t n = static_cast<size_t>(a.n);
  float* s_x = smem;                                    // [D][256]
  float* s_best = s_x + dim * kLanes;                   // [D4]
  int* s_lane = reinterpret_cast<int*>(s_best + d4);    // [256] by place
  float* s_ul = reinterpret_cast<float*>(s_lane + kLanes);
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_ul + kLanes);  // [8]

  // 32-bit lanes: N < 2^31.
  const int base = blockIdx.x * kLanes;
  const bool t_active = base + t < a.n;
  for (int e = t; e < dim; e += kLanes) s_best[e] = a.best[e];
  if (t_active) {
    for (int d = 0; d < dim; ++d) s_x[d * kLanes + t] = a.pos[d * n + base + t];
  }

  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const int tile_n = a.tile_n;
  const int n_tiles = a.n / tile_n;
  const float t0 = static_cast<float>(a.scalars[2]);
  // The block's first tile and lane in it, and that tile's peer tile; the
  // lane shift brought into [0, tile_n): the divisions once a launch.  A
  // block of 256 lanes meets at most three tiles (tile_n >= 128).
  const int tile0 = base / tile_n;
  const int j0 = base - tile0 * tile_n;
  const int peer0 = wrap32(tile0 + a.scalars[1], n_tiles);
  const int l_peer = wrap32(a.scalars[3], tile_n);
  const dsa::PhiloxOneLane rl =
      dsa::philox_one_lane(static_cast<uint32_t>(base + t), kRowStream);
  const int full = dim >> 2;   // chunks of four; kR dimensions after them

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);

    // This thread's own lane: its row and its class.
    bool contract = false;
    float u_l = 0.0f;
    if (t_active) {
      float u_p;
      if constexpr (kHost) {
        u_p = a.r_p[base + t];
        u_l = a.r_l[base + t];
      } else {
        const dsa::Philox4 p = dsa::philox_one_group(
            rl, dsa::philox_one_step(rl, ctr, seed), 0u);
        u_p = dsa::uniform_from_bits(p.v[0]);
        u_l = dsa::uniform_from_bits(p.v[1]);
      }
      contract = u_p < 0.5f;
    }

    // The block's stable counting sort by class.
    const unsigned m0 = __ballot_sync(kFull, t_active && contract);
    const unsigned m1 = __ballot_sync(kFull, t_active && !contract);
    if ((t & 31) == 0) s_cnt[warp] = __popc(m0) | (__popc(m1) << 16);
    __syncthreads();
    uint32_t all = 0, lt = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c = s_cnt[v];
      all += c;
      if (v < warp) lt += c;
    }
    const int n0 = static_cast<int>(all & 0xffffu);
    const int total = n0 + static_cast<int>(all >> 16);
    if (t_active) {
      const int place =
          contract ? static_cast<int>(lt & 0xffffu) + __popc(m0 & below_me)
                   : n0 + static_cast<int>(lt >> 16) + __popc(m1 & below_me);
      s_lane[place] = t;
      s_ul[place] = u_l;
    }
    __syncthreads();
    if (t >= total) continue;

    // The lane at place t, in its class.
    const int u = s_lane[t];
    Whale w;
    w.x = s_x + u;
    w.best = s_best;
    w.n = n;
    w.lane = base + u;
    w.hw = a.half_width;
    if (t < n0) {
      const float frac =
          fminf(div(add(t0, static_cast<float>(step)), a.t_max), 1.0f);
      const float aa = mul(2.0f, sub(1.0f, frac));
      const float two_a = mul(2.0f, aa);
      dsa::PhiloxPairLane pl{};
      dsa::PhiloxPairStep ps{};
      if constexpr (!kHost) {
        pl = dsa::philox_pair_lane(static_cast<uint32_t>(w.lane), 0u, 1u);
        ps = dsa::philox_pair_step(pl, ctr, seed);
      }
      // The lane's tile lane and its peer's, without a division.
      int j = j0 + u, peer_tile = peer0;
      while (j >= tile_n) {
        j -= tile_n;
        peer_tile = peer_tile + 1 == n_tiles ? 0 : peer_tile + 1;
      }
      int pj = j - l_peer - kLaneShift[step & 7];
      while (pj < 0) pj += tile_n;
      const float* peer =
          a.pos + static_cast<size_t>(peer_tile) * tile_n + pj;
#pragma unroll 1
      for (int q = 0; q < full; ++q) {
        contract_chunk<4, kHost>(a, w, pl, ps, peer, aa, two_a, q);
      }
      if constexpr (kR != 0) {
        contract_chunk<kR, kHost>(a, w, pl, ps, peer, aa, two_a, full);
      }
    } else {
      const float l = sub(mul(2.0f, s_ul[t]), 1.0f);
      const float scale = expf(mul(a.spiral_b, l));
      const float cosv = dsa::obj::cos2pi(l);
#pragma unroll 1
      for (int q = 0; q < full; ++q) spiral_chunk<4>(w, scale, cosv, q);
      if constexpr (kR != 0) spiral_chunk<kR>(w, scale, cosv, full);
    }
  }

  __syncthreads();
  if (!t_active) return;
  const float* x = s_x + t;
  const size_t lane = static_cast<size_t>(base) + t;
  float s = -0.0f;
#pragma unroll 1
  for (int q = 0; q < full; ++q) out_chunk<4, Obj>(a, x, lane, q, s);
  if constexpr (kR != 0) out_chunk<kR, Obj>(a, x, lane, full, s);
  if constexpr (Obj::kFold) {
    a.fit_out[lane] = Obj::close(s, dim);
  } else {
    a.fit_out[lane] = Obj::whole(Column{x, kLanes}, dim);
  }
}

// --------------------------------------------------------------------------
// Variant 1: the first version, one thread per whale in the whales' order.
// --------------------------------------------------------------------------

__global__ void woa_lane_kernel(const WoaArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  for (int d = 0; d < dim; ++d) s_pos[d * block] = a.pos[d * n + lane];

  const bool host_rng = a.r_a != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const long long n_tiles = a.n / a.tile_n;
  const long long tile = lane / a.tile_n;
  const long long j = lane - tile * a.tile_n;
  const long long tshift = a.scalars[1];
  const float t0 = static_cast<float>(a.scalars[2]);
  const long long lshift = a.scalars[3];
  const long long peer_tile = ((tile + tshift) % n_tiles + n_tiles) % n_tiles;

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float frac =
        fminf(div(add(t0, static_cast<float>(step)), a.t_max), 1.0f);
    const float aa = mul(2.0f, sub(1.0f, frac));
    const float two_a = mul(2.0f, aa);
    float u_p, u_l;
    if (host_rng) {
      u_p = a.r_p[lane];
      u_l = a.r_l[lane];
    } else {
      const dsa::Philox4 rows = dsa::philox4x32_10(
          static_cast<uint32_t>(lane), 0u, ctr, 2u, seed, 0u);
      u_p = dsa::uniform_from_bits(rows.v[0]);
      u_l = dsa::uniform_from_bits(rows.v[1]);
    }
    const bool contract = u_p < 0.5f;
    const float l = sub(mul(2.0f, u_l), 1.0f);
    const float spiral_scale = expf(mul(a.spiral_b, l));
    const float spiral_cos = dsa::obj::cos2pi(l);
    const long long s = lshift + kLaneShift[step & 7];
    const long long pj = ((j - s) % a.tile_n + a.tile_n) % a.tile_n;
    const float* peer = a.pos + peer_tile * a.tile_n + pj;

    for (int d0 = 0; d0 < dim; d0 += 4) {
      float ua[4], uc[4];
      if (host_rng) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = d0 + q < dim;
          ua[q] = in ? a.r_a[(d0 + q) * n + lane] : 0.0f;
          uc[q] = in ? a.r_c[(d0 + q) * n + lane] : 0.0f;
        }
      } else {
        const uint32_t g = static_cast<uint32_t>(d0 >> 2);
        const dsa::Philox4 pa =
            dsa::philox4x32_10(static_cast<uint32_t>(lane), g, ctr, 0u, seed, 0u);
        const dsa::Philox4 pc =
            dsa::philox4x32_10(static_cast<uint32_t>(lane), g, ctr, 1u, seed, 0u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ua[q] = dsa::uniform_from_bits(pa.v[q]);
          uc[q] = dsa::uniform_from_bits(pc.v[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + q;
        if (d < dim) {
          const float x = s_pos[d * block];
          const float b = a.best[d];
          float v;
          if (contract) {
            const float big_a = sub(mul(two_a, ua[q]), aa);
            const float big_c = mul(2.0f, uc[q]);
            const float prey = fabsf(big_a) >= 1.0f ? peer[d * n] : b;
            v = sub(prey, mul(big_a, fabsf(sub(mul(big_c, prey), x))));
          } else {
            v = add(mul(mul(fabsf(sub(b, x)), spiral_scale), spiral_cos), b);
          }
          s_pos[d * block] = fminf(fmaxf(v, -a.half_width), a.half_width);
        }
      }
    }
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = s_pos[d * block];
  a.fit_out[lane] =
      dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
}

// Variant 1's threads per block: the largest of 128, 64, 32 whose tile
// fits, or 0 (D > 1816): the kernel's envelope.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (1ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
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
cudaError_t launch_sorted(const WoaArgs& a, size_t shared, cudaStream_t s) {
  auto* kernel = woa_sorted_kernel<kR, kObj, kHost>;
  const cudaError_t err =
      allow_shared(reinterpret_cast<const void*>(kernel), shared);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (static_cast<unsigned>(a.n) + kLanes - 1) / kLanes;
  kernel<<<blocks, kLanes, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const WoaArgs& a, size_t shared, cudaStream_t s) {
  return a.r_a != nullptr ? launch_sorted<kR, kObj, true>(a, shared, s)
                          : launch_sorted<kR, kObj, false>(a, shared, s);
}

template <int kR>
cudaError_t launch_objective(const WoaArgs& a, size_t shared,
                             cudaStream_t s) {
#define DSA_WOA_CASE(k) \
  case dsa::k:          \
    return launch_source<kR, dsa::k>(a, shared, s);
  switch (a.objective) {
    DSA_WOA_CASE(kSphere)
    DSA_WOA_CASE(kRastrigin)
    DSA_WOA_CASE(kAckley)
    DSA_WOA_CASE(kRosenbrock)
    DSA_WOA_CASE(kGriewank)
    DSA_WOA_CASE(kSchwefel)
    DSA_WOA_CASE(kLevy)
    DSA_WOA_CASE(kZakharov)
    DSA_WOA_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, shared, s);
  }
#undef DSA_WOA_CASE
}

// Whether the entry runs `variant` with blocks of `lanes` whales and
// `shared` bytes at this D: variant 0 needs blocks of 256 and exactly its
// layout's bytes within a block's shared memory; variant 1 the first
// version's block and tile.
bool geometry_ok(int variant, int lanes, int shared, int dim) {
  if (variant == 0) {
    return lanes == kLanes && static_cast<size_t>(shared) == sorted_bytes(dim)
           && static_cast<size_t>(shared) <= kMaxSharedBytes;
  }
  return variant == 1 && lanes != 0 && lanes == pick_block(dim) &&
         static_cast<size_t>(shared) == 1ull * dim * lanes * sizeof(float);
}

}  // namespace

// Variant 1's threads per block for `dim` (0: outside the envelope).
extern "C" int dsa_woa_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: best [D], pos [D, N], the draws
// r_a/r_c [D, N] and r_p/r_l [N] (all four or none), pos_out [D, N],
// fit_out [N]; scalars [4] i32 (seed, tile shift, block-start iteration,
// lane shift).  N is a multiple of tile_n.  The geometry (variant, whales a
// block, shared bytes a block) is the wrapper's (woa_geometry); one this
// entry cannot run is refused.  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_woa_fused_f32(
    const int* scalars, const float* best, const float* pos, const float* r_a,
    const float* r_c, const float* r_p, const float* r_l, float* pos_out,
    float* fit_out, int n, int dim, int tile_n, int k_steps, unsigned step0,
    int objective, float t_max, float spiral_b, float half_width, int variant,
    int lanes, int shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool some = r_a || r_c || r_p || r_l;
  const bool all = r_a && r_c && r_p && r_l;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      some != all || (all && k_steps != 1) ||
      !geometry_ok(variant, lanes, shared, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WoaArgs a{scalars, best, pos, r_a, r_c, r_p, r_l, pos_out, fit_out,
                  n, dim, tile_n, k_steps, step0, objective, t_max,
                  spiral_b, half_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, shared, s); break;
      case 1: err = launch_objective<1>(a, shared, s); break;
      case 2: err = launch_objective<2>(a, shared, s); break;
      default: err = launch_objective<3>(a, shared, s);
    }
  } else {
    err = allow_shared(reinterpret_cast<const void*>(woa_lane_kernel),
                       shared);
    if (err == cudaSuccess) {
      const unsigned blocks = (static_cast<unsigned>(n) + lanes - 1) / lanes;
      woa_lane_kernel<<<blocks, lanes, shared, s>>>(a);
      err = cudaGetLastError();
    }
  }
  // A refused call leaves its error pending: clear it, so that the next
  // launch does not report it as its own.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
