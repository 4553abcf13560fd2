// Fused moth-flame iterations for Hopper (sm_90a): k spiral flights in one
// pass, each flame updated in place by its own moth at every step.
//
// dsa_mfo_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/mfo_fused.py:fused_mfo_step_t
//   (body _make_kernel).
//
// What one launch computes, for the moths and the flames in the transposed
// layout [D, N], k_steps times, for the moth in global column j:
//
//   l     = u (1 - r_lo) + r_lo,   r_lo = scalars[2] / 65536  (per element)
//   flame = j < n_flames ? flames[:, j] : last       (last fixed per launch)
//   x     = clip(|flame - x| 2^(b l log2 e) cos(2 pi l) + flame, +-hw)
//   mfit  = f(x);  if mfit < flame_fit[j]: flames[:, j], flame_fit[j] = x,
//   mfit
//
// and the outputs are the moths, their last fitness, the flames and their
// fitness.  n_flames and r_lo are read from the device.  The pairing is
// positional, so lanes are independent.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; u is
// stream 0 over the dimensions, counter (lane, block of four dimensions,
// global step, 0).  With r_l given as an operand (one step only) the kernel
// reads it instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no
// contraction; 2^x is fast_math.cuh's exp2_fast and cos 2 pi l the
// objectives header's polynomial, so kernel and plain version agree bit for
// bit.
//
// The fixed point.  Take an own moth (j < n_flames) equal to its flame in
// every dimension, the flame inside +-hw.  Then |flame - x| is +0;
// exp2_fast is finite for every finite argument (its exponent is clamped to
// +-126) and so is the cosine, so the spiral gives +-0 + flame, which is
// flame but for the sign of a zero; the clip keeps it; f gives the same
// fitness, so mfit < flame_fit holds at most at the first such step, and
// then only sets the flame to its own value.  Every later step changes
// nothing torch.equal can see (-0 == +0).  An own moth that improves its
// flame is such a moth at the next step, since the flame becomes x.  So an
// own moth's launch is "spiral until the first improvement, or k steps",
// and a moth at the fixed point when the launch starts needs one
// evaluation and one comparison.  The argument needs 2^(b l log2 e) finite
// for every l of the launch (|l| <= 65,537: r_lo is an int32 over 65,536,
// u in [0, 1)) and hw finite: the entry checks both (can_stop), and
// otherwise every moth takes every step.  A NaN or a flame outside the
// domain fails the test, so such a moth takes every step too.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin.
// Bytes: moths, flames and flame fitness read once, the four outputs
// written once: 4 (4 D + 3) N + 4 D bytes, 0.52 GB, 0.154 ms at 3.35 TB/s.
// Operations per element and step: the draw (28), l (3), the flame select
// (1), |flame - x| (2), 2^(b l log2 e) (20), cos 2 pi l (17), the spiral
// and the clip (5), rastrigin (23), the flame update (2): 101; per moth and
// step 3 (the own test, the flame fitness test and select).  Charged at
// every element-step: 2.5e10 a launch, 0.38 ms at 67 TFLOP/s.  The
// function needs them only at the moving moth-steps (above), and there
// without the flame select (a moth's flame is fixed over a launch), plus at
// each moth stopped at the start one evaluation (23 an element) and the
// test (2 an element, 3 a moth): chip_smoke.py's rot_bound_ms, from the
// plain version's tallies (ops/cuda/mfo_fused.py: counts).
//
// Design (rule 2's redesign).  The first version (1.003 ms a launch at the
// main path's shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) ran every
// step of every moth, drew every group of four dimensions with a plain
// philox4x32_10 call, masked every element with d < D, tested the draws'
// source inside the group loop, selected each element's flame from the
// lane's column or from `last` read from global memory, and evaluated the
// objective behind a runtime switch in a second pass.  Two variants now,
// which the wrapper's geometry picks (ops/cuda/mfo_fused.py: mfo_geometry)
// and the entry checks:
//
// Variant 0, moths stopped at the fixed point and regrouped (D <= 225; the
// main path).  A block of 128 moths stages their positions and flames as
// two [D][128] tiles (thread fastest) and `last`, once, and writes them
// out once at the end:
//   - staging tests each moth for the fixed point (own, x == flame and
//     |flame| <= hw in every d, can_stop, the kernel's own draws); such a
//     moth is evaluated once, compared, and its fitness written;
//   - before every step the block sorts the moving moths to the front,
//     stably: a warp ballot, the popcounts, a prefix over the four warps
//     and a barrier; each moth's place is its warp's offset and its rank
//     in the ballot (family.py's branch_order of the moving class gives
//     the same order), and a second barrier publishes the places.  Thread
//     i advances the moth at place i, in that moth's own columns, so the
//     arithmetic is unchanged bit for bit, an own moth that stops leaves
//     its warp, and warps whose moths all stopped do no work;
//   - an own moth leaves the step loop after the step that improves its
//     flame (its flame then is its position); the others take all k steps;
//   - each moth's flame is a pointer: its own column, or the staged
//     `last`; own moths and the others run separate instances of the chunk
//     loop, each with its stride fixed, and sort apart (own first), so only
//     the warp at n_flames runs both;
//   - draws from philox_one.cuh: the moth's products once a step of its
//     thread, the step's once a step, 16 products a group of four;
//   - templates on D mod 4 (the chunks of four run unmasked), on the
//     objective (a sum of per-dimension terms folds into the chunk loop in
//     ascending d from -0, the plain version's order; the others evaluate
//     the column) and on the draws' source;
//   - the blocks run from the top of the lane range down, so the blocks
//     past n_flames, where every moth takes every step, start first and
//     the light ones fill the end;
//   - the staging and the write-out take four chunks of four dimensions a
//     trip, so each thread has 32 loads in flight.
// Tried on the card and left out (PERF.md): sorting once, before the first
// step only (no barrier in the step loop, but warps half emptied by the
// own moths that stop: the MFO run 4.6% slower, mfo_clock.py); blocks of
// 64 or 256 moths; a second kernel advancing the moving moths of sparse
// blocks from a queue, 128 a block; a persistent grid whose blocks gather
// the moving moths of several tiles into full batches; the tiles in a
// strided order that mixes heavy and light blocks.  Each was slower (the
// queue's kernel waits for the whole first one; the gathered designs read
// the moving moths twice).
//
// Variant 1, the first version (225 < D <= 908), kept as it was: two
// [D][block] tiles, the block 128 threads where they fit, else 64, else 32.
//
// Above 48 KB of shared memory a block the entry opts in with
// cudaFuncSetAttribute.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/mfo_fused.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "philox_one.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kLanes = 128;             // variant 0's block
constexpr int kWarps = kLanes / 32;
constexpr unsigned kFull = 0xffffffffu;
// The largest |b| for which b l log2 e stays finite for every l a launch
// can draw (|l| <= 65,537).
constexpr float kMaxSpiralB = 1e30f;

struct MfoArgs {
  const int* scalars;     // [3] i32: seed, n_flames, r_lo in 16.16
  const float* last;      // [D] the clamp flame
  const float* pos;       // [D, N]
  const float* flames;    // [D, N]
  const float* flame_fit; // [N]
  const float* r_l;       // [D, N] or null: draw in the kernel
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  float* flames_out;      // [D, N]
  float* flame_fit_out;   // [N]
  int n;
  int dim;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float b, half_width;
  int can_stop;           // the fixed point holds (see the header)
};

struct Column {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int d) const {
    return p[d * stride];
  }
};

using dsa::fast::exp2_fast;
using dsa::obj::add;
using dsa::obj::div;
using dsa::obj::mul;
using dsa::obj::sub;

__device__ __forceinline__ float clip(float v, float hw) {
  return fminf(fmaxf(v, -hw), hw);
}

// The spiral of one element around its flame.
__device__ __forceinline__ float spiral(float x, float flame, float l,
                                        float b, float hw) {
  const float log2e = static_cast<float>(1.4426950408889634);
  const float dist = fabsf(sub(flame, x));
  const float v = add(
      mul(mul(dist, exp2_fast(mul(mul(b, l), log2e))), dsa::obj::cos2pi(l)),
      flame);
  return clip(v, hw);
}

// --------------------------------------------------------------------------
// Variant 0: moths stopped at the fixed point and regrouped.
// --------------------------------------------------------------------------

// Shared memory of a block: the moths' positions and flames [D][128] each,
// `last` (padded to four), the flame fitness by moth and the moths by
// place [128] each, and the warps' counts [4].
size_t sorted_bytes(int dim) {
  return (2ull * dim * kLanes + ((dim + 3) & ~3) + 2ull * kLanes + kWarps) *
         sizeof(float);
}

// What a thread knows of the moth it advances.
struct Moth {
  float* x;             // the moth's column, stride kLanes
  const float* flame;   // its flame: its own column or the staged `last`
  float span, r_lo, b, hw;
};

// The uniforms of chunk q: the operand's (kHost, one step) or stream 0.
template <int kN, bool kHost>
__device__ __forceinline__ void draws(const MfoArgs& a,
                                      const dsa::PhiloxOneLane& pl,
                                      const dsa::PhiloxOneStep& ps,
                                      size_t lane, int q, float u[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      u[j] = a.r_l[static_cast<size_t>(4 * q + j) * a.n + lane];
    }
  } else {
    const dsa::Philox4 w =
        dsa::philox_one_group(pl, ps, static_cast<uint32_t>(q));
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = dsa::uniform_from_bits(w.v[j]);
  }
}

// Chunk q: kN elements spiralled, each objective term folded into s.  An
// own moth's flame is its column (stride kLanes), another's `last`.  The
// chunk's positions and flames are loaded before its draws, so the loads'
// latency hides behind the Philox rounds.
template <int kN, bool kOwn, class Obj, bool kHost>
__device__ __forceinline__ void spiral_chunk(const MfoArgs& a, const Moth& m,
                                             const dsa::PhiloxOneLane& pl,
                                             const dsa::PhiloxOneStep& ps,
                                             size_t lane, int q, float& s) {
  constexpr int kStride = kOwn ? kLanes : 1;
  float x[4], f[4], u[4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    x[j] = m.x[(4 * q + j) * kLanes];
    f[j] = m.flame[(4 * q + j) * kStride];
  }
  draws<kN, kHost>(a, pl, ps, lane, q, u);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float l = add(mul(u[j], m.span), m.r_lo);
    const float v = spiral(x[j], f[j], l, m.b, m.hw);
    m.x[(4 * q + j) * kLanes] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

// One step of a moth: every chunk drawn and spiralled; returns the folded
// objective terms' sum (from -0).
template <int kR, bool kOwn, class Obj, bool kHost>
__device__ __forceinline__ float spiral_all(const MfoArgs& a, const Moth& m,
                                            const dsa::PhiloxOneLane& pl,
                                            const dsa::PhiloxOneStep& ps,
                                            size_t lane, int full) {
  float sum = -0.0f;
#pragma unroll 1
  for (int q = 0; q < full; ++q) {
    spiral_chunk<4, kOwn, Obj, kHost>(a, m, pl, ps, lane, q, sum);
  }
  if constexpr (kR != 0) {
    spiral_chunk<kR, kOwn, Obj, kHost>(a, m, pl, ps, lane, full, sum);
  }
  return sum;
}

// Chunk q of the staging: four dimensions of this thread's moth into the
// tiles, and whether they keep it at the fixed point.
template <int kN>
__device__ __forceinline__ bool stage_chunk(const MfoArgs& a, float* x,
                                            float* fl, size_t lane, int q) {
  bool same = true;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const size_t at = static_cast<size_t>(d) * a.n + lane;
    const float p = a.pos[at];
    const float f = a.flames[at];
    x[d * kLanes] = p;
    fl[d * kLanes] = f;
    same &= (p == f) & (fabsf(f) <= a.half_width);
  }
  return same;
}

// Chunk q of the write-out: four dimensions of this thread's moth.
template <int kN>
__device__ __forceinline__ void out_chunk(const MfoArgs& a, const float* x,
                                          const float* fl, size_t lane,
                                          int q) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const size_t at = static_cast<size_t>(d) * a.n + lane;
    a.pos_out[at] = x[d * kLanes];
    a.flames_out[at] = fl[d * kLanes];
  }
}

// Chunk q of a fixed moth's evaluation: its terms folded into s.
template <int kN, class Obj>
__device__ __forceinline__ void term_chunk(const float* x, int q, float& s) {
#pragma unroll
  for (int j = 0; j < kN; ++j) s = add(s, Obj::term(x[(4 * q + j) * kLanes]));
}

// The objective at a column of the tiles.
template <int kR, class Obj>
__device__ __forceinline__ float column_fitness(const float* x, int dim) {
  if constexpr (Obj::kFold) {
    float s = -0.0f;
    const int full = dim >> 2;
#pragma unroll 1
    for (int q = 0; q < full; ++q) term_chunk<4, Obj>(x, q, s);
    if constexpr (kR != 0) term_chunk<kR, Obj>(x, full, s);
    return Obj::close(s, dim);
  } else {
    return Obj::whole(Column{x, kLanes}, dim);
  }
}

// The block's shared memory (sorted_bytes).
struct Tiles {
  float* pos;       // [D][128] the moths' positions, a column a moth
  float* flame;     // [D][128] their flames
  float* last;      // [D4] the clamp flame
  float* ffit;      // [128] the flame fitness by moth
  int* place;       // [128] the moth at each place
  uint32_t* cnt;    // [4] the warps' counts
};

__device__ __forceinline__ Tiles tiles_of(float* smem, int dim) {
  Tiles s;
  s.pos = smem;
  s.flame = s.pos + dim * kLanes;
  s.last = s.flame + dim * kLanes;
  s.ffit = s.last + ((dim + 3) & ~3);
  s.place = reinterpret_cast<int*>(s.ffit + kLanes);
  s.cnt = reinterpret_cast<uint32_t*>(s.place + kLanes);
  return s;
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kLanes) mfo_sorted_kernel(const MfoArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const unsigned below_me = (1u << (t & 31)) - 1u;
  const int dim = a.dim;
  const int full = dim >> 2;   // chunks of four; kR dimensions after them
  const Tiles s = tiles_of(smem, dim);

  // 32-bit lanes: N < 2^31.  The blocks run from the top of the lane
  // range, where the moths past n_flames take every step, so the lightest
  // blocks come last.
  const int base = (gridDim.x - 1 - blockIdx.x) * kLanes;
  const bool t_active = base + t < a.n;
  const int n_flames = a.scalars[1];
  for (int e = t; e < dim; e += kLanes) s.last[e] = a.last[e];

  // Staging: this thread's own moth, tested for the fixed point.
  bool live = false;   // the moth this thread holds still moves
  if (t_active) {
    const size_t lane = static_cast<size_t>(base) + t;
    float* x = s.pos + t;
    float* fl = s.flame + t;
    bool fixed = true;
#pragma unroll 4
    for (int q = 0; q < full; ++q) fixed &= stage_chunk<4>(a, x, fl, lane, q);
    if constexpr (kR != 0) fixed &= stage_chunk<kR>(a, x, fl, lane, full);
    fixed &= !kHost && a.can_stop && base + t < n_flames;
    const float ffit = a.flame_fit[lane];
    if (fixed) {
      // One evaluation and the comparison: no later step changes the moth.
      const float mfit = column_fitness<kR, Obj>(fl, dim);
      a.fit_out[lane] = mfit;
      a.flame_fit_out[lane] = mfit < ffit ? mfit : ffit;
    } else {
      s.ffit[t] = ffit;
      live = true;
    }
  }

  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  // r_lo = scalars[2] / 65536: a product by 2^-16 rounds as the plain
  // version's division does (exactly).
  const float r_lo = mul(static_cast<float>(a.scalars[2]), 1.0f / 65536.0f);
  Moth m;
  m.span = sub(1.0f, r_lo);
  m.r_lo = r_lo;
  m.b = a.b;
  m.hw = a.half_width;
  int u = t;           // the moth this thread holds (by its column)
  float ffit = 0.0f, mfit = 0.0f;
  dsa::PhiloxOneLane pl{};

  for (int step = 0; step < a.k_steps; ++step) {
    // The block's stable sort of the moving moths to places [0, total).
    if (live && step > 0) s.ffit[u] = ffit;   // staging wrote step 0's
    const unsigned mask = __ballot_sync(kFull, live);
    if ((t & 31) == 0) s.cnt[warp] = __popc(mask);
    __syncthreads();
    int total = 0, before = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = static_cast<int>(s.cnt[v]);
      total += c;
      if (v < warp) before += c;
    }
    if (live) s.place[before + __popc(mask & below_me)] = u;
    __syncthreads();
    if (total == 0) break;   // uniform: every moth of the block stopped
    live = t < total;
    if (!live) continue;     // to the barriers of the next sort
    u = s.place[t];
    ffit = s.ffit[u];
    if constexpr (!kHost) {
      pl = dsa::philox_one_lane(static_cast<uint32_t>(base + u), 0u);
    }

    const size_t lane = static_cast<size_t>(base) + u;
    const bool own = base + u < n_flames;
    m.x = s.pos + u;
    m.flame = own ? s.flame + u : s.last;
    dsa::PhiloxOneStep ps{};
    if constexpr (!kHost) {
      ps = dsa::philox_one_step(pl, a.step0 + static_cast<uint32_t>(step),
                                seed);
    }
    // Own moths and the others are sorted apart (own first), so only the
    // warp at their boundary runs both loops.
    const float sum = own ? spiral_all<kR, true, Obj, kHost>(a, m, pl, ps,
                                                            lane, full)
                          : spiral_all<kR, false, Obj, kHost>(a, m, pl, ps,
                                                             lane, full);
    if constexpr (Obj::kFold) {
      mfit = Obj::close(sum, dim);
    } else {
      mfit = Obj::whole(Column{m.x, kLanes}, dim);
    }
    if (mfit < ffit) {
      ffit = mfit;
      float* fl = s.flame + u;
#pragma unroll 1
      for (int d = 0; d < dim; ++d) fl[d * kLanes] = m.x[d * kLanes];
      if (own && a.can_stop) {
        // Its flame is its position now: every later step keeps both.
        a.fit_out[lane] = mfit;
        a.flame_fit_out[lane] = ffit;
        live = false;
      }
    }
  }
  if (live) {
    const size_t lane = static_cast<size_t>(base) + u;
    a.fit_out[lane] = mfit;
    a.flame_fit_out[lane] = ffit;
  }

  __syncthreads();
  if (!t_active) return;
  const size_t lane = static_cast<size_t>(base) + t;
#pragma unroll 4
  for (int q = 0; q < full; ++q) {
    out_chunk<4>(a, s.pos + t, s.flame + t, lane, q);
  }
  if constexpr (kR != 0) out_chunk<kR>(a, s.pos + t, s.flame + t, lane, full);
}

// --------------------------------------------------------------------------
// Variant 1: the first version, every step of every moth.
// --------------------------------------------------------------------------

__global__ void mfo_lane_kernel(const MfoArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  float* s_flame = smem + static_cast<size_t>(dim) * block + t;
  for (int d = 0; d < dim; ++d) {
    s_pos[d * block] = a.pos[d * n + lane];
    s_flame[d * block] = a.flames[d * n + lane];
  }
  float ffit = a.flame_fit[lane];
  float mfit = 0.0f;

  const bool host_rng = a.r_l != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const bool own = lane < a.scalars[1];
  const float r_lo = div(static_cast<float>(a.scalars[2]), 65536.0f);
  const float span = sub(1.0f, r_lo);

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    for (int d0 = 0; d0 < dim; d0 += 4) {
      float u[4];
      if (host_rng) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = d0 + q < dim ? a.r_l[(d0 + q) * n + lane] : 0.0f;
        }
      } else {
        const dsa::Philox4 p = dsa::philox4x32_10(
            static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2), ctr,
            0u, seed, 0u);
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = dsa::uniform_from_bits(p.v[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + q;
        if (d < dim) {
          const float l = add(mul(u[q], span), r_lo);
          const float flame = own ? s_flame[d * block] : a.last[d];
          s_pos[d * block] =
              spiral(s_pos[d * block], flame, l, a.b, a.half_width);
        }
      }
    }
    mfit = dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
    if (mfit < ffit) {
      ffit = mfit;
      for (int d = 0; d < dim; ++d) s_flame[d * block] = s_pos[d * block];
    }
  }

  for (int d = 0; d < dim; ++d) {
    a.pos_out[d * n + lane] = s_pos[d * block];
    a.flames_out[d * n + lane] = s_flame[d * block];
  }
  a.fit_out[lane] = mfit;
  a.flame_fit_out[lane] = ffit;
}

// Variant 1's threads per block: the largest of 128, 64, 32 whose two
// tiles fit, or 0 (D > 908): the kernel's envelope.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (2ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
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
cudaError_t launch_sorted(const MfoArgs& a, size_t shared, cudaStream_t s) {
  auto* kernel = mfo_sorted_kernel<kR, kObj, kHost>;
  const cudaError_t err =
      allow_shared(reinterpret_cast<const void*>(kernel), shared);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (static_cast<unsigned>(a.n) + kLanes - 1) / kLanes;
  kernel<<<blocks, kLanes, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const MfoArgs& a, size_t shared, cudaStream_t s) {
  return a.r_l != nullptr ? launch_sorted<kR, kObj, true>(a, shared, s)
                          : launch_sorted<kR, kObj, false>(a, shared, s);
}

template <int kR>
cudaError_t launch_objective(const MfoArgs& a, size_t shared,
                             cudaStream_t s) {
#define DSA_MFO_CASE(k) \
  case dsa::k:          \
    return launch_source<kR, dsa::k>(a, shared, s);
  switch (a.objective) {
    DSA_MFO_CASE(kSphere)
    DSA_MFO_CASE(kRastrigin)
    DSA_MFO_CASE(kAckley)
    DSA_MFO_CASE(kRosenbrock)
    DSA_MFO_CASE(kGriewank)
    DSA_MFO_CASE(kSchwefel)
    DSA_MFO_CASE(kLevy)
    DSA_MFO_CASE(kZakharov)
    DSA_MFO_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, shared, s);
  }
#undef DSA_MFO_CASE
}

// Whether the entry runs `variant` with blocks of `lanes` moths and
// `shared` bytes at this D: variant 0 needs blocks of 128 and exactly its
// bytes within a block's shared memory; variant 1 the first version's block
// and tiles.
bool geometry_ok(int variant, int lanes, int shared, int dim) {
  if (variant == 0) {
    return lanes == kLanes &&
           static_cast<size_t>(shared) == sorted_bytes(dim) &&
           static_cast<size_t>(shared) <= kMaxSharedBytes;
  }
  return variant == 1 && lanes != 0 && lanes == pick_block(dim) &&
         static_cast<size_t>(shared) == 2ull * dim * lanes * sizeof(float);
}

// The words the main kernel draws for (lane, group g, step, seed), from
// philox_one.cuh on the lane's and the step's hoisted products, beside
// philox4x32_10's.
__global__ void philox_check_kernel(const uint32_t* lanes,
                                    const uint32_t* gs, const uint32_t* ctrs,
                                    const uint32_t* seeds, int n,
                                    uint32_t* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const dsa::PhiloxOneLane pl = dsa::philox_one_lane(lanes[e], 0u);
  const dsa::Philox4 w = dsa::philox_one_group(
      pl, dsa::philox_one_step(pl, ctrs[e], seeds[e]), gs[e]);
  const dsa::Philox4 r =
      dsa::philox4x32_10(lanes[e], gs[e], ctrs[e], 0u, seeds[e], 0u);
  uint32_t* o = out + static_cast<size_t>(e) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = w.v[j];
    o[4 + j] = r.v[j];
  }
}

}  // namespace

// Variant 1's threads per block for `dim` (0: outside the envelope).
extern "C" int dsa_mfo_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: last [D], pos and flames [D, N],
// flame_fit [N], the draw r_l [D, N] (or null), pos_out and flames_out
// [D, N], fit_out and flame_fit_out [N]; scalars [3] i32 (seed, n_flames,
// r_lo in 16.16 fixed point).  N is a multiple of tile_n (the kernel does
// not depend on the tile).  The geometry (variant, moths a block, shared
// bytes a block) is the wrapper's (mfo_geometry); one this entry
// cannot run is refused.  Launched on `stream` without synchronising.
// Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_mfo_fused_f32(
    const int* scalars, const float* last, const float* pos,
    const float* flames, const float* flame_fit, const float* r_l,
    float* pos_out, float* fit_out, float* flames_out, float* flame_fit_out,
    int n, int dim, int tile_n, int k_steps, unsigned step0, int objective,
    float b, float half_width, int variant, int lanes, int shared,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      (r_l && k_steps != 1) ||
      !geometry_ok(variant, lanes, shared, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int can_stop =
      std::isfinite(half_width) && std::fabs(b) <= kMaxSpiralB;
  const MfoArgs a{scalars, last, pos, flames, flame_fit, r_l, pos_out,
                  fit_out, flames_out, flame_fit_out, n, dim, k_steps, step0,
                  objective, b, half_width, can_stop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, shared, s); break;
      case 1: err = launch_objective<1>(a, shared, s); break;
      case 2: err = launch_objective<2>(a, shared, s); break;
      default: err = launch_objective<3>(a, shared, s);
    }
  } else {
    err = allow_shared(reinterpret_cast<const void*>(mfo_lane_kernel),
                       shared);
    if (err == cudaSuccess) {
      const unsigned blocks = (static_cast<unsigned>(n) + lanes - 1) / lanes;
      mfo_lane_kernel<<<blocks, lanes, shared, s>>>(a);
      err = cudaGetLastError();
    }
  }
  // A refused call leaves its error pending: clear it, so that the next
  // launch does not report it as its own.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The words of the main kernel's hoisted draws beside philox4x32_10's, for
// n counters (lane, group, step) and seeds: out [n, 8], stream 0's group as
// drawn, then as philox4x32_10 draws it.
extern "C" int dsa_mfo_philox_check(const unsigned* lanes, const unsigned* gs,
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
