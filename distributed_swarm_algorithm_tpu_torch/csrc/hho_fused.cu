// Fused Harris-hawks generations for Hopper (sm_90a): k generations in one
// pass.
//
// dsa_hho_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/hho_fused.py:fused_hho_step_t
//   (body _make_kernel).
//
// What one launch computes, for the hawks in the transposed layout [D, N],
// k_steps times, for the hawk in lane j of tile i, with the rabbit R and the
// mean M [D] and the peer tile P = tile i + s of the launch's input fixed
// over the launch (roll(X, l)[j] = X[(j - l) mod tile_n]):
//
//   frac = clip((t0 + step + 1) * f32(1 / t_max), 0, 1)
//   E    = (2 (2 u_e0 - 1))(1 - frac);  J = 2 (1 - u_j)
//   |E| >= 1 (explore):  u_q >= 1/2:  Xr - r1 |Xr - (2 r2) x|,
//                                     Xr = roll(P, l + shift[step % 8][0])
//                        else:        (R - M) - r3 (lb + r4 (ub - lb))
//   else u_r >= 1/2 (besiege): |E| >= 1/2: (R - x) - E |J R - x|
//                              else:       R - E |R - x|
//   else (dive): y = R - E |J R - (|E| >= 1/2 ? x : M)|,
//                z = y + s (sigma n1) 2^(-log2(|n2| + 1e-12) / beta),
//                y, z clipped; x = f(y) < f(x) ? y : f(z) < f(x) ? z : x
//   x = clip(x, lb, ub);  f = f(x)
//
// The division by the constant t_max is a product with its f32 reciprocal,
// as XLA compiles the TPU kernel's and the portable step's; |E| >= 1 and
// |E| >= 1/2 are decided on it.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; r1, r2, r3,
// r4 and s are streams 0 to 4, the Box-Muller pair's uniforms streams 5 and
// 6 (n1 its cosine half, n2 its sine half), over the dimensions, counter
// (lane, block of four dimensions, global step, stream); u_e0, u_j, u_q,
// u_r are the four words of the call (lane, 0, global step, 7).  A lane
// draws, and evaluates, only what its branch uses: the result is the TPU
// kernel's, which computes every branch for every lane.  With the draws
// given as operands (one step only) the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// log2, 2^x and cos 2 pi x through fast_math.cuh and the objectives header,
// so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin
// (chip_smoke.py: FAM_OPS counts the operations from this source, the
// branches' lanes from the launch's row draws).  Bytes: the hawks and
// their fitness read once and written once, the rabbit and the mean read
// once: 4 (2 D + 2) N + 8 D bytes, 0.26 GB, 0.08 ms at 3.35 TB/s.
// Operations: per lane and step the row call and the energy; per element
// the branch's draws and update, and on a dive the pair, the Levy power and
// the two evaluations of y and z; the final clip and rastrigin on every
// lane but a diving one, whose new position is y or z or its x kept (the
// fitness the step before computed), save one that keeps x at the launch's
// first step.  Operations bound it.
//
// Design (rule 2's redesign).  The first version (2.933 ms a launch at the
// main path's shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) runs one
// thread per hawk in the hawks' order, so a warp's lanes take different
// branches and nearly every warp pays for the besiege (~6 operations an
// element) and the dive (~248) both, and early on for the exploration
// (~63) too; it draws every stream's group with a plain philox4x32_10
// call, reads the rabbit and the mean from global memory at every element,
// stages three [D][block] tiles (45 KB at D = 30), masks every element with
// d < D, and evaluates every lane's new position in a last pass.  Two
// variants now, which the wrapper's geometry picks (ops/cuda/hho_fused.py:
// hho_geometry) and the entry checks:
//
// Variant 0, lanes regrouped by branch (D <= 111; the main path).  A block
// of 256 hawks stages their positions [D][256], the dive's z column for
// each thread [D][256], the rabbit and the mean (65 KB at D = 30), and at
// every step:
//   - each thread draws its own lane's row words (stream 7, philox_one.cuh
//     on the lane's products, once a launch) and classifies the lane:
//     explore at a perch, explore below the mean, besiege, or dive (the
//     soft and the hard case differ by a select and stay together);
//   - the block sorts its lanes by class, stably: four warp ballots and
//     their popcounts, the warps' counts packed two to a word, a prefix
//     over the warps, a barrier; each lane's place is its class's start,
//     its warp's count of the class before it and its rank in the ballot;
//     the lane, its energy and its jump go to that place, and a second
//     barrier publishes them (ops/cuda/hho_fused.py: branch_order is the
//     same order in PyTorch);
//   - thread i advances the lane at place i: its position stays in the
//     lane's own column, its fitness in the lane's slot, so only the warps
//     at the few class boundaries diverge; each lane's arithmetic is
//     unchanged, so the result is bit for bit the same;
//   - an exploring lane draws its two streams (0 and 1 at a perch, 2 and 3
//     below the mean) with one philox_pair_group call a group of four, a
//     diving lane its normal pair (5 and 6) likewise and its step s
//     (stream 4) with philox_one.cuh;
//   - templates on D mod 4 (the chunks of four run unmasked), on the
//     objective and on the draws' source; the new position's objective
//     term folds into the explore and besiege loops, and y's and z's into
//     the dive's (sphere, rastrigin, schwefel, styblinski_tang; the others
//     evaluate after the loop).  A diving lane keeps z (it took draws) and
//     rebuilds y (it took none) if y wins; f(y) or f(z) is its fitness then,
//     since neither moves under the final clip.  A lane that keeps x keeps
//     its fitness, which this launch computed for that x at the step
//     before; only at the launch's first step, whose fitness comes from the
//     caller and whose x may lie outside the domain, does it clip and
//     evaluate x.
//
// Variant 1, the first version, kept as it was (hho_trial_tile_kernel)
// for the widths variant 0 does not hold (D <= 605).
//
// Above 48 KB of shared memory a block the entry opts in with
// cudaFuncSetAttribute.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/hho_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "philox_one.cuh"
#include "philox_pair.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr uint32_t kRowStream = 7;
constexpr int kLanes = 256;              // variant 0's block
constexpr int kWarps = kLanes / 32;
// Variant 0's blocks an SM that its registers must allow (85 a thread):
// its shared memory holds 3 at D = 30, and without the bound ptxas kept 64
// registers and spilled in one instantiation.
constexpr int kMinBlocks = 3;
constexpr unsigned kFull = 0xffffffffu;
// A lane's class at a step, the order of the sort.
constexpr int kPerch = 0, kBelow = 1, kBesiege = 2, kDive = 3, kIdle = 4;

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS); the random
// hawk reads the first column.
__constant__ int kLaneShift[8] = {1, 3, 7, 11, 17, 23, 29, 37};

struct HhoArgs {
  const int* scalars;    // [4] i32: seed, peer tile shift, t0, lane shift
  const float* best;     // [D] the rabbit
  const float* mean;     // [D]
  const float* pos;      // [D, N]
  const float* fit;      // [N]
  const float* rows;     // [4, N] or null: draw in the kernel
  const float* planes;   // [5, D, N]: r1, r2, r3, r4, s
  const float* normals;  // [2, D, N]: n1, n2
  float* pos_out;        // [D, N]
  float* fit_out;        // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;        // global index of the launch's first step
  int objective;
  float half_width, inv_t_max, sigma, neg_inv_beta;
};

struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::fast::levy_power;
using dsa::fast::normal_pair;
using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

__device__ __forceinline__ int wrap32(int v, int m) {
  return (v % m + m) % m;
}

__device__ __forceinline__ float clip(float v, float hw) {
  return dsa::fast::clip(v, -hw, hw);
}

// --------------------------------------------------------------------------
// Variant 0: lanes regrouped by branch.
// --------------------------------------------------------------------------

// Dynamic shared memory of a variant-0 block: the positions and the z
// columns [D][256] each, the rabbit and the mean (padded to four), the
// lanes' fitness, the sorted lanes with their energy and jump [256], and
// the warps' class counts [2][8].
size_t main_bytes(int dim) {
  return (2ull * dim * kLanes + 2ull * ((dim + 3) & ~3) + 4ull * kLanes +
          2ull * kWarps) * sizeof(float);
}

// What a thread knows of the lane it advances at one step.
struct Hawk {
  float* x;             // the lane's column, stride kLanes
  const float* best;    // the staged rabbit
  const float* mean;    // the staged mean
  size_t n;
  long long lane;
  float energy, jump, hw;
  bool soft;            // |E| >= 1/2
};

// Four uniforms of a group from plane k of the host draws.
template <int kN>
__device__ __forceinline__ void plane4(const HhoArgs& a, int k,
                                       const Hawk& h, int q, float u[4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    u[j] = a.planes[(static_cast<size_t>(k) * a.dim + 4 * q + j) * h.n +
                    h.lane];
  }
}

// Two streams' uniforms of group q: the pair call (device) or planes k0 and
// k0 + 1 (host).
template <int kN, bool kHost>
__device__ __forceinline__ void pair4(const HhoArgs& a, const Hawk& h,
                                      const dsa::PhiloxPairLane& pl,
                                      const dsa::PhiloxPairStep& ps, int k0,
                                      int q, float u0[4], float u1[4]) {
  if constexpr (kHost) {
    plane4<kN>(a, k0, h, q, u0);
    plane4<kN>(a, k0 + 1, h, q, u1);
  } else {
    dsa::Philox4 w[2];
    dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(q), w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u0[j] = dsa::uniform_from_bits(w[0].v[j]);
      u1[j] = dsa::uniform_from_bits(w[1].v[j]);
    }
  }
}

// Chunk q of an exploring lane: at a perch (kPerchChunk, the random hawk's
// column xr of the launch's input) or below the mean.
template <int kN, bool kPerchChunk, class Obj, bool kHost>
__device__ __forceinline__ void explore_chunk(
    const HhoArgs& a, const Hawk& h, const dsa::PhiloxPairLane& pl,
    const dsa::PhiloxPairStep& ps, const float* xr, float width, int q,
    float& s) {
  float ua[4], ub[4];
  pair4<kN, kHost>(a, h, pl, ps, kPerchChunk ? 0 : 2, q, ua, ub);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    float v;
    if constexpr (kPerchChunk) {
      const float x = h.x[d * kLanes];
      const float r = xr[static_cast<size_t>(d) * h.n];
      v = sub(r, mul(ua[j], fabsf(sub(r, mul(mul(2.0f, ub[j]), x)))));
    } else {
      v = sub(sub(h.best[d], h.mean[d]),
              mul(ua[j], add(-h.hw, mul(ub[j], width))));
    }
    v = clip(v, h.hw);
    h.x[d * kLanes] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

// Chunk q of a besieging lane.
template <int kN, class Obj>
__device__ __forceinline__ void besiege_chunk(const Hawk& h, int q,
                                              float& s) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float x = h.x[d * kLanes];
    const float rb = h.best[d];
    const float v = clip(
        h.soft ? sub(sub(rb, x), mul(h.energy, fabsf(sub(mul(h.jump, rb), x))))
               : sub(rb, mul(h.energy, fabsf(sub(rb, x)))),
        h.hw);
    h.x[d * kLanes] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

// A diving lane's y at element d, clipped: no draws.
__device__ __forceinline__ float dive_y(const Hawk& h, int d) {
  const float rb = h.best[d];
  const float ref = h.soft ? h.x[d * kLanes] : h.mean[d];
  return clip(sub(rb, mul(h.energy, fabsf(sub(mul(h.jump, rb), ref)))),
              h.hw);
}

// y as a column, for the objectives evaluated after the loop.
struct DiveY {
  Hawk h;
  __device__ __forceinline__ float operator()(int d) const {
    return dive_y(h, d);
  }
};

// Chunk q of a diving lane: y and z clipped, z into the thread's z column,
// their objective terms into sy and sz.
template <int kN, class Obj, bool kHost>
__device__ __forceinline__ void dive_chunk(
    const HhoArgs& a, const Hawk& h, const dsa::PhiloxPairLane& pl,
    const dsa::PhiloxPairStep& ps, const dsa::PhiloxOneLane& sl,
    const dsa::PhiloxOneStep& ss, float* z_col, int q, float& sy,
    float& sz) {
  float us[4], n1[4], n2[4];
  if constexpr (kHost) {
    plane4<kN>(a, 4, h, q, us);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const size_t off = static_cast<size_t>(4 * q + j) * h.n + h.lane;
      n1[j] = a.normals[off];
      n2[j] = a.normals[static_cast<size_t>(a.dim) * h.n + off];
    }
  } else {
    const dsa::Philox4 w = dsa::philox_one_group(sl, ss,
                                                 static_cast<uint32_t>(q));
    float u1[4], u2[4];
    pair4<4, false>(a, h, pl, ps, 0, q, u1, u2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      us[j] = dsa::uniform_from_bits(w.v[j]);
      normal_pair(u1[j], u2[j], n1[j], n2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float rb = h.best[d];
    const float ref = h.soft ? h.x[d * kLanes] : h.mean[d];
    const float y = sub(rb, mul(h.energy, fabsf(sub(mul(h.jump, rb), ref))));
    const float levy =
        mul(mul(a.sigma, n1[j]), levy_power(n2[j], a.neg_inv_beta));
    const float yc = clip(y, h.hw);
    const float zc = clip(add(y, mul(us[j], levy)), h.hw);
    z_col[d * kLanes] = zc;
    if constexpr (Obj::kFold) {
      sy = add(sy, Obj::term(yc));
      sz = add(sz, Obj::term(zc));
    }
  }
}

// The fitness of a lane's new position: its folded terms closed, or the
// objective over its column.
template <class Obj>
__device__ __forceinline__ float fitness(const Hawk& h, float s, int dim) {
  if constexpr (Obj::kFold) {
    return Obj::close(s, dim);
  } else {
    return Obj::whole(Column{h.x, kLanes}, dim);
  }
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kLanes, kMinBlocks)
    hho_sorted_kernel(const HhoArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const unsigned below_me = (1u << (t & 31)) - 1u;
  const int dim = a.dim;
  const int d4 = (dim + 3) & ~3;
  const size_t n = static_cast<size_t>(a.n);
  float* s_x = smem;                                   // [D][256]
  float* s_z = s_x + dim * kLanes;                     // [D][256]
  float* s_best = s_z + dim * kLanes;                  // [D4]
  float* s_mean = s_best + d4;                         // [D4]
  float* s_fit = s_mean + d4;                          // [256] by lane
  int* s_lane = reinterpret_cast<int*>(s_fit + kLanes);  // [256] by place
  float* s_e = reinterpret_cast<float*>(s_lane + kLanes);
  float* s_j = s_e + kLanes;
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_j + kLanes);  // [2][8]

  const long long base = static_cast<long long>(blockIdx.x) * kLanes;
  const bool t_active = base + t < a.n;
  for (int e = t; e < dim; e += kLanes) {
    s_best[e] = a.best[e];
    s_mean[e] = a.mean[e];
  }
  if (t_active) {
    for (int d = 0; d < dim; ++d) {
      s_x[d * kLanes + t] = a.pos[d * n + base + t];
    }
    s_fit[t] = a.fit[base + t];
  }

  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const int tile_n = a.tile_n;
  const int n_tiles = a.n / tile_n;
  const int tile_shift = a.scalars[1];
  const float t0 = static_cast<float>(a.scalars[2]);
  const int l_peer = a.scalars[3];
  const float hw = a.half_width;
  const float width = static_cast<float>(static_cast<double>(hw) -
                                         static_cast<double>(-hw));
  const dsa::PhiloxOneLane rl = dsa::philox_one_lane(
      static_cast<uint32_t>(base + t), kRowStream);
  const int full = dim >> 2;   // chunks of four; kR dimensions after them
  float* z_col = s_z + t;

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float tt = add(add(t0, static_cast<float>(step)), 1.0f);
    const float frac = dsa::fast::clip(mul(tt, a.inv_t_max), 0.0f, 1.0f);

    // This thread's own lane: its row and its class.
    int cls = kIdle;
    float energy = 0.0f, jump = 0.0f;
    if (t_active) {
      float row[4];
      if constexpr (kHost) {
#pragma unroll
        for (int k = 0; k < 4; ++k) row[k] = a.rows[k * n + base + t];
      } else {
        const dsa::Philox4 p = dsa::philox_one_group(
            rl, dsa::philox_one_step(rl, ctr, seed), 0u);
#pragma unroll
        for (int k = 0; k < 4; ++k) row[k] = dsa::uniform_from_bits(p.v[k]);
      }
      const float e0 = sub(mul(2.0f, row[0]), 1.0f);
      energy = mul(mul(2.0f, e0), sub(1.0f, frac));
      jump = mul(2.0f, sub(1.0f, row[1]));
      cls = fabsf(energy) >= 1.0f ? (row[2] >= 0.5f ? kPerch : kBelow)
                                  : (row[3] >= 0.5f ? kBesiege : kDive);
    }

    // The block's stable counting sort by class.
    const unsigned m0 = __ballot_sync(kFull, cls == kPerch);
    const unsigned m1 = __ballot_sync(kFull, cls == kBelow);
    const unsigned m2 = __ballot_sync(kFull, cls == kBesiege);
    const unsigned m3 = __ballot_sync(kFull, cls == kDive);
    if ((t & 31) == 0) {
      s_cnt[warp] = __popc(m0) | (__popc(m1) << 16);
      s_cnt[kWarps + warp] = __popc(m2) | (__popc(m3) << 16);
    }
    __syncthreads();
    uint32_t all01 = 0, all23 = 0, lt01 = 0, lt23 = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c01 = s_cnt[v], c23 = s_cnt[kWarps + v];
      all01 += c01;
      all23 += c23;
      if (v < warp) {
        lt01 += c01;
        lt23 += c23;
      }
    }
    const int n0 = static_cast<int>(all01 & 0xffffu);
    const int n01 = n0 + static_cast<int>(all01 >> 16);
    const int n012 = n01 + static_cast<int>(all23 & 0xffffu);
    const int total = n012 + static_cast<int>(all23 >> 16);
    if (cls != kIdle) {
      const unsigned m = cls == kPerch ? m0 : cls == kBelow ? m1
                       : cls == kBesiege ? m2 : m3;
      const int start = cls == kPerch ? static_cast<int>(lt01 & 0xffffu)
                      : cls == kBelow ? n0 + static_cast<int>(lt01 >> 16)
                      : cls == kBesiege ? n01 + static_cast<int>(lt23 & 0xffffu)
                      : n012 + static_cast<int>(lt23 >> 16);
      const int place = start + __popc(m & below_me);
      s_lane[place] = t;
      s_e[place] = energy;
      s_j[place] = jump;
    }
    __syncthreads();
    if (t >= total) continue;

    // The lane at place t, in its class.
    const int u = s_lane[t];
    Hawk h;
    h.x = s_x + u;
    h.best = s_best;
    h.mean = s_mean;
    h.n = n;
    h.lane = base + u;
    h.energy = s_e[t];
    h.jump = s_j[t];
    h.hw = hw;
    h.soft = fabsf(h.energy) >= 0.5f;
    const int klass = t < n0 ? kPerch : t < n01 ? kBelow
                    : t < n012 ? kBesiege : kDive;
    const uint32_t lane32 = static_cast<uint32_t>(h.lane);
    float fit = s_fit[u];
    float s = -0.0f;
    if (klass == kPerch || klass == kBelow) {
      const bool perch = klass == kPerch;
      dsa::PhiloxPairLane pl{};
      dsa::PhiloxPairStep ps{};
      if constexpr (!kHost) {
        pl = dsa::philox_pair_lane(lane32, perch ? 0u : 2u, perch ? 1u : 3u);
        ps = dsa::philox_pair_step(pl, ctr, seed);
      }
      if (perch) {
        // The random hawk: 32-bit lanes (N < 2^31), so no 64-bit division.
        const int lane = static_cast<int>(h.lane);
        const int tile = lane / tile_n;
        const int j = lane - tile * tile_n;
        const float* xr =
            a.pos + static_cast<size_t>(wrap32(tile + tile_shift, n_tiles)) *
                        tile_n +
            wrap32(j - l_peer - kLaneShift[step & 7], tile_n);
#pragma unroll 1
        for (int q = 0; q < full; ++q) {
          explore_chunk<4, true, Obj, kHost>(a, h, pl, ps, xr, width, q, s);
        }
        if constexpr (kR != 0) {
          explore_chunk<kR, true, Obj, kHost>(a, h, pl, ps, xr, width, full,
                                              s);
        }
      } else {
#pragma unroll 1
        for (int q = 0; q < full; ++q) {
          explore_chunk<4, false, Obj, kHost>(a, h, pl, ps, nullptr, width, q,
                                              s);
        }
        if constexpr (kR != 0) {
          explore_chunk<kR, false, Obj, kHost>(a, h, pl, ps, nullptr, width,
                                               full, s);
        }
      }
      fit = fitness<Obj>(h, s, dim);
    } else if (klass == kBesiege) {
#pragma unroll 1
      for (int q = 0; q < full; ++q) besiege_chunk<4, Obj>(h, q, s);
      if constexpr (kR != 0) besiege_chunk<kR, Obj>(h, full, s);
      fit = fitness<Obj>(h, s, dim);
    } else {
      // A Levy rapid dive: trial points y and z, accepted greedily.
      dsa::PhiloxPairLane pl{};
      dsa::PhiloxPairStep ps{};
      dsa::PhiloxOneLane sl{};
      dsa::PhiloxOneStep ss{};
      if constexpr (!kHost) {
        pl = dsa::philox_pair_lane(lane32, 5u, 6u);
        ps = dsa::philox_pair_step(pl, ctr, seed);
        sl = dsa::philox_one_lane(lane32, 4u);
        ss = dsa::philox_one_step(sl, ctr, seed);
      }
      float sz = -0.0f;
#pragma unroll 1
      for (int q = 0; q < full; ++q) {
        dive_chunk<4, Obj, kHost>(a, h, pl, ps, sl, ss, z_col, q, s, sz);
      }
      if constexpr (kR != 0) {
        dive_chunk<kR, Obj, kHost>(a, h, pl, ps, sl, ss, z_col, full, s, sz);
      }
      float fy, fz;
      if constexpr (Obj::kFold) {
        fy = Obj::close(s, dim);
        fz = Obj::close(sz, dim);
      } else {
        fy = Obj::whole(DiveY{h}, dim);
        fz = Obj::whole(Column{z_col, kLanes}, dim);
      }
      if (fy < fit) {
        // y again, in place: element d reads only x's element d.
        for (int d = 0; d < dim; ++d) h.x[d * kLanes] = dive_y(h, d);
        fit = fy;
      } else if (fz < fit) {
        for (int d = 0; d < dim; ++d) h.x[d * kLanes] = z_col[d * kLanes];
        fit = fz;
      } else if (step == 0) {
        // x kept: the caller's fitness and an x the clip may move.
        for (int d = 0; d < dim; ++d) {
          h.x[d * kLanes] = clip(h.x[d * kLanes], hw);
        }
        fit = Obj::whole(Column{h.x, kLanes}, dim);
      }
    }
    s_fit[u] = fit;
  }

  __syncthreads();
  if (t_active) {
    for (int d = 0; d < dim; ++d) {
      a.pos_out[d * n + base + t] = s_x[d * kLanes + t];
    }
    a.fit_out[base + t] = s_fit[t];
  }
}

// --------------------------------------------------------------------------
// Variant 1: the first version, one thread per hawk in the hawks' order.
// --------------------------------------------------------------------------

// Plane `k` (of the host draws) or stream `k` of Philox: four uniforms for
// dimensions d0 .. d0 + 3 of `lane`.
__device__ __forceinline__ void draw4(const HhoArgs& a, bool host_rng,
                                      uint32_t seed, uint32_t ctr, int lane,
                                      int d0, uint32_t k, float u[4]) {
  if (host_rng) {
    const size_t n = static_cast<size_t>(a.n);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u[q] = d0 + q < a.dim
                 ? a.planes[(k * a.dim + d0 + q) * n + lane]
                 : 0.0f;
    }
  } else {
    const dsa::Philox4 p = dsa::philox4x32_10(
        static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2), ctr, k,
        seed, 0u);
#pragma unroll
    for (int q = 0; q < 4; ++q) u[q] = dsa::uniform_from_bits(p.v[q]);
  }
}

__global__ void hho_trial_tile_kernel(const HhoArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  float* s_y = smem + static_cast<size_t>(dim) * block + t;
  float* s_z = smem + 2 * static_cast<size_t>(dim) * block + t;
  for (int d = 0; d < dim; ++d) s_pos[d * block] = a.pos[d * n + lane];
  float fit = a.fit[lane];

  const bool host_rng = a.rows != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const long long tile_n = a.tile_n;
  const long long n_tiles = a.n / tile_n;
  const long long tile = lane / tile_n;
  const long long j = lane - tile * tile_n;
  const float* peer = a.pos + wrap(tile + a.scalars[1], n_tiles) * tile_n;
  const float t0 = static_cast<float>(a.scalars[2]);
  const long long l_peer = a.scalars[3];
  const float hw = a.half_width;
  const float lb = -hw;
  const float width = static_cast<float>(static_cast<double>(hw) -
                                         static_cast<double>(lb));

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float tt = add(add(t0, static_cast<float>(step)), 1.0f);
    const float frac = dsa::fast::clip(mul(tt, a.inv_t_max), 0.0f, 1.0f);
    float row[4];
    if (host_rng) {
#pragma unroll
      for (int k = 0; k < 4; ++k) row[k] = a.rows[k * n + lane];
    } else {
      const dsa::Philox4 p = dsa::philox4x32_10(
          static_cast<uint32_t>(lane), 0u, ctr, kRowStream, seed, 0u);
#pragma unroll
      for (int k = 0; k < 4; ++k) row[k] = dsa::uniform_from_bits(p.v[k]);
    }
    const float e0 = sub(mul(2.0f, row[0]), 1.0f);
    const float energy = mul(mul(2.0f, e0), sub(1.0f, frac));
    const float abs_e = fabsf(energy);
    const float jump = mul(2.0f, sub(1.0f, row[1]));
    const bool soft = abs_e >= 0.5f;

    if (abs_e >= 1.0f) {
      // Explore: a random hawk's perch, or below the mean.
      const bool perch = row[2] >= 0.5f;
      const float* xr =
          peer + wrap(j - l_peer - kLaneShift[step & 7], tile_n);
      for (int d0 = 0; d0 < dim; d0 += 4) {
        float ua[4], ub[4];
        draw4(a, host_rng, seed, ctr, lane, d0, perch ? 0u : 2u, ua);
        draw4(a, host_rng, seed, ctr, lane, d0, perch ? 1u : 3u, ub);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = d0 + q;
          if (d < dim) {
            float v;
            if (perch) {
              const float x = s_pos[d * block];
              const float r = xr[static_cast<size_t>(d) * n];
              v = sub(r, mul(ua[q], fabsf(sub(r, mul(mul(2.0f, ub[q]), x)))));
            } else {
              v = sub(sub(a.best[d], a.mean[d]),
                      mul(ua[q], add(lb, mul(ub[q], width))));
            }
            s_pos[d * block] = clip(v, hw);
          }
        }
      }
    } else if (row[3] >= 0.5f) {
      // Besiege without a dive.
      for (int d = 0; d < dim; ++d) {
        const float x = s_pos[d * block];
        const float rb = a.best[d];
        const float v =
            soft ? sub(sub(rb, x), mul(energy, fabsf(sub(mul(jump, rb), x))))
                 : sub(rb, mul(energy, fabsf(sub(rb, x))));
        s_pos[d * block] = clip(v, hw);
      }
    } else {
      // A Levy rapid dive: trial points y and z, accepted greedily.
      for (int d0 = 0; d0 < dim; d0 += 4) {
        float us[4], n1[4], n2[4];
        draw4(a, host_rng, seed, ctr, lane, d0, 4u, us);
        if (host_rng) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool in = d0 + q < dim;
            const size_t off = static_cast<size_t>(d0 + q) * n + lane;
            n1[q] = in ? a.normals[off] : 0.0f;
            n2[q] = in ? a.normals[static_cast<size_t>(dim) * n + off] : 0.0f;
          }
        } else {
          float u1[4], u2[4];
          draw4(a, false, seed, ctr, lane, d0, 5u, u1);
          draw4(a, false, seed, ctr, lane, d0, 6u, u2);
#pragma unroll
          for (int q = 0; q < 4; ++q) normal_pair(u1[q], u2[q], n1[q], n2[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = d0 + q;
          if (d < dim) {
            const float rb = a.best[d];
            const float ref = soft ? s_pos[d * block] : a.mean[d];
            const float y = sub(rb, mul(energy, fabsf(sub(mul(jump, rb), ref))));
            const float levy =
                mul(mul(a.sigma, n1[q]), levy_power(n2[q], a.neg_inv_beta));
            const float z = add(y, mul(us[q], levy));
            s_y[d * block] = clip(y, hw);
            s_z[d * block] = clip(z, hw);
          }
        }
      }
      const float fy =
          dsa::evaluate_objective(a.objective, Column{s_y, block}, dim);
      const float fz =
          dsa::evaluate_objective(a.objective, Column{s_z, block}, dim);
      const float* pick = fy < fit ? s_y : fz < fit ? s_z : nullptr;
      for (int d = 0; d < dim; ++d) {
        s_pos[d * block] = clip(pick ? pick[d * block] : s_pos[d * block], hw);
      }
    }
    fit = dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = s_pos[d * block];
  a.fit_out[lane] = fit;
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
cudaError_t launch_sorted(const HhoArgs& a, size_t shared, cudaStream_t s) {
  auto* kernel = hho_sorted_kernel<kR, kObj, kHost>;
  const cudaError_t err =
      allow_shared(reinterpret_cast<const void*>(kernel), shared);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (static_cast<unsigned>(a.n) + kLanes - 1) / kLanes;
  kernel<<<blocks, kLanes, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const HhoArgs& a, size_t shared, cudaStream_t s) {
  return a.rows != nullptr ? launch_sorted<kR, kObj, true>(a, shared, s)
                           : launch_sorted<kR, kObj, false>(a, shared, s);
}

template <int kR>
cudaError_t launch_objective(const HhoArgs& a, size_t shared,
                             cudaStream_t s) {
#define DSA_HHO_CASE(k) \
  case dsa::k:          \
    return launch_source<kR, dsa::k>(a, shared, s);
  switch (a.objective) {
    DSA_HHO_CASE(kSphere)
    DSA_HHO_CASE(kRastrigin)
    DSA_HHO_CASE(kAckley)
    DSA_HHO_CASE(kRosenbrock)
    DSA_HHO_CASE(kGriewank)
    DSA_HHO_CASE(kSchwefel)
    DSA_HHO_CASE(kLevy)
    DSA_HHO_CASE(kZakharov)
    DSA_HHO_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, shared, s);
  }
#undef DSA_HHO_CASE
}

// Whether the entry runs `variant` with blocks of `lanes` hawks and
// `shared` bytes at this D: variant 0 needs blocks of 256 and exactly its
// layout's bytes within a block's shared memory; variant 1 the first
// version's block and tiles.
bool geometry_ok(int variant, int lanes, int shared, int dim) {
  if (variant == 0) {
    return lanes == kLanes && static_cast<size_t>(shared) == main_bytes(dim)
           && static_cast<size_t>(shared) <= kMaxSharedBytes;
  }
  return variant == 1 && lanes != 0 && lanes == pick_block(dim) &&
         static_cast<size_t>(shared) == 3ull * dim * lanes * sizeof(float);
}

// The words the main kernel draws for (lane, group g, step, seed): the
// pairs of streams 0 and 1, 2 and 3, 5 and 6 at group g, stream 4 at g and
// the row (stream 7, group 0), hoisted as the kernel hoists them, beside
// philox4x32_10's for streams 0, 1, 2, 3, 5, 6, 4 at g and 7 at 0.
__global__ void philox_check_kernel(const uint32_t* lanes,
                                    const uint32_t* gs, const uint32_t* ctrs,
                                    const uint32_t* seeds, int n,
                                    uint32_t* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t* o = out + static_cast<size_t>(e) * 64;
  const uint32_t pairs[3][2] = {{0u, 1u}, {2u, 3u}, {5u, 6u}};
  for (int k = 0; k < 3; ++k) {
    const dsa::PhiloxPairLane pl =
        dsa::philox_pair_lane(lanes[e], pairs[k][0], pairs[k][1]);
    dsa::Philox4 w[2];
    dsa::philox_pair_group(pl, dsa::philox_pair_step(pl, ctrs[e], seeds[e]),
                           gs[e], w);
    for (int s = 0; s < 2; ++s) {
      const dsa::Philox4 r = dsa::philox4x32_10(lanes[e], gs[e], ctrs[e],
                                                pairs[k][s], seeds[e], 0u);
      for (int j = 0; j < 4; ++j) {
        o[8 * k + 4 * s + j] = w[s].v[j];
        o[32 + 8 * k + 4 * s + j] = r.v[j];
      }
    }
  }
  const uint32_t ones[2] = {4u, kRowStream};
  for (int k = 0; k < 2; ++k) {
    const uint32_t g = k == 0 ? gs[e] : 0u;
    const dsa::PhiloxOneLane sl = dsa::philox_one_lane(lanes[e], ones[k]);
    const dsa::Philox4 w = dsa::philox_one_group(
        sl, dsa::philox_one_step(sl, ctrs[e], seeds[e]), g);
    const dsa::Philox4 r =
        dsa::philox4x32_10(lanes[e], g, ctrs[e], ones[k], seeds[e], 0u);
    for (int j = 0; j < 4; ++j) {
      o[24 + 4 * k + j] = w.v[j];
      o[56 + 4 * k + j] = r.v[j];
    }
  }
}

}  // namespace

// Variant 1's threads per block for `dim` (0: outside the envelope).
extern "C" int dsa_hho_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: best and mean [D], pos [D, N],
// fit [N], the draws rows [4, N], planes [5, D, N], normals [2, D, N] (all
// three or none), pos_out [D, N], fit_out [N]; scalars [4] i32 (seed, peer
// tile shift, the iteration before the launch, peer lane shift).  N is a
// multiple of tile_n.  The geometry (variant, hawks a block, shared bytes a
// block) is the wrapper's (hho_geometry); one this entry cannot run is
// refused.  Launched on `stream` without synchronising.  Returns the CUDA
// error of the launch (0 when accepted).
extern "C" int dsa_hho_fused_f32(
    const int* scalars, const float* best, const float* mean,
    const float* pos, const float* fit, const float* rows,
    const float* planes, const float* normals, float* pos_out,
    float* fit_out, int n, int dim, int tile_n, int k_steps, unsigned step0,
    int objective, float half_width, float inv_t_max, float sigma,
    float neg_inv_beta, int variant, int lanes, int shared, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool some = rows || planes || normals;
  const bool all = rows && planes && normals;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      some != all || (all && k_steps != 1) ||
      !geometry_ok(variant, lanes, shared, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HhoArgs a{scalars, best, mean, pos, fit, rows, planes, normals,
                  pos_out, fit_out, n, dim, tile_n, k_steps, step0,
                  objective, half_width, inv_t_max, sigma, neg_inv_beta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, shared, s); break;
      case 1: err = launch_objective<1>(a, shared, s); break;
      case 2: err = launch_objective<2>(a, shared, s); break;
      default: err = launch_objective<3>(a, shared, s);
    }
  } else {
    err = allow_shared(reinterpret_cast<const void*>(hho_trial_tile_kernel),
                       shared);
    if (err == cudaSuccess) {
      const unsigned blocks = (static_cast<unsigned>(n) + lanes - 1) / lanes;
      hho_trial_tile_kernel<<<blocks, lanes, shared, s>>>(a);
      err = cudaGetLastError();
    }
  }
  // A refused call leaves its error pending: clear it, so that the next
  // launch does not report it as its own.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The words of the main kernel's hoisted draws beside philox4x32_10's, for
// n counters (lane, group, step) and seeds: out [n, 64], the three pairs'
// words (streams 0, 1, 2, 3, 5, 6), stream 4's and the row's as drawn, then
// as philox4x32_10 draws them.
extern "C" int dsa_hho_philox_check(const unsigned* lanes, const unsigned* gs,
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
