// Fused differential-evolution generations for Hopper (sm_90a): k DE
// generations in one pass, with rotational donors.
//
// dsa_de_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/de_fused.py:fused_de_step_t
//   (body _make_kernel).
//
// What one launch computes, for pos in the transposed layout [D, N]
// (individuals along the fast axis), N a whole number of tiles of tile_n
// lanes, k_steps times:
//
//   donor k of lane j of tile i = lane (j - s_k) mod tile_n of tile
//       (i + tshift_k) mod n_tiles of the launch's INPUT (jnp.roll's
//       direction), s_k = lshift_k + shift[step % 8][k], k = a, b, c
//   mutant = clip(a + F (b - c), +-half_width)
//   trial  = r < CR ? mutant : x          (per gene, no j_rand)
//   x, fit = f(trial) <= fit ? (trial, f(trial)) : (x, fit)
//
// The donors are block-start snapshots, so lanes are independent within a
// launch; the tile and lane shifts are read from the device.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; r is
// stream 0 over the dimensions, counter (lane, block of four dimensions,
// global step, 0).  No launch geometry enters, so the plain PyTorch
// version draws the same numbers; with r given as an operand (one step
// only) the kernel reads it instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no
// contraction, so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 32 steps, rastrigin.
// Bytes: pos and fit read once, written once: 4 (2 D + 2) N bytes, 0.26
// GB, 0.08 ms at 3.35 TB/s.  Operations per element and step: the draw (a
// quarter Philox call and its uniform: 28), the crossover test (1), the
// mutant with its clip (5), the select (1), rastrigin (23): 58; per
// individual and step 12 (the three donor lanes, the acceptance and its
// select); 5.9e10 a launch, 0.88 ms at 67 TFLOP/s: operations bound it.
//
// Design (rule 2's redesign).  Two variants, which the wrapper's geometry
// picks (ops/cuda/de_fused.py: de_geometry) and the entry checks:
//
// Variant 0, staged windows (D <= 179; the main path).  One thread a lane,
// a block of L lanes of one tile (L a multiple of 32, at most 512; the
// tile's last block may hold fewer).  The first version read three donors
// from global memory at every crossing gene and step (2.7 loads an
// element-step, ~11 GB a launch through an L2 smaller than the donor
// tiles), kept a trial tile beside the population, drew with a plain
// Philox call, masked every element with d < D and evaluated the objective
// in a second pass behind a runtime switch.  Now:
//   - the donors are block-start snapshots, so a block stages, once a
//     launch, each donor's window: the lanes its L lanes read over the 8
//     schedule rows, L + 36, L + 50 and L + 108 lanes for a, b and c (the
//     spans of LANE_SHIFTS' columns), from (j0 - lshift_k - max_k) mod
//     tile_n on, wrapping at the tile's edge, with cp.async; at step s
//     lane t reads window element t + max_k - shift[s % 8][k].  This is
//     the TPU kernel's three donor BlockSpecs in VMEM;
//   - no trial tile: a gene's crossing is a bit of a mask (a register
//     for the last 32 genes, shared memory before them), the trial's
//     objective is folded into the gene loop (a sum of per-dimension
//     terms) or evaluated over a column that rebuilds each trial gene
//     from the staged operands, and on acceptance the crossed genes'
//     mutants are recomputed: the same operations on the same operands,
//     so the same bits;
//   - the crossover stream's lane-only and step-only Philox products are
//     hoisted once a launch and once a step (philox_one.cuh: 16 products
//     a group where the plain call takes 20), and the next chunk's group
//     is drawn while the current chunk's genes are computed (one group a
//     step in vain where D is a multiple of 4);
//   - every gene loads its mutant's three operands and its own value and
//     selects, and so does the acceptance's rewrite: loads behind a branch
//     go out one at a time (a build that loaded the operands only where
//     the gene crossed was slower);
//   - templates on D mod 4 (no mask on an element), on the objective and
//     on the draws' source, so the step loop holds only what it runs.
//   Shared memory: 4 (D L + D (3 L + 194) + (ceil(D / 32) - 1) L) bytes.
//
// Variant 1, donors from global memory (179 < D <= 908; the first version,
// kept).  One thread per individual: a block stages its individuals' pos
// and trial in dynamic shared memory as two [D][block] tiles and reads the
// donors from the input in global memory at every step, only where the
// gene crosses.  The block is 128 threads where the two tiles fit the
// 227 KB a block may take, else 64, else 32.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/de_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox_one.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kMaxLanes = 512;   // variant 0's largest block

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS): donor k
// at step s rolls by lshift_k + kLaneShift[s % 8][k].
__constant__ int kLaneShift[8][3] = {
    {1, 45, 89},  {3, 51, 101}, {7, 57, 113}, {11, 63, 5},
    {17, 71, 19}, {23, 77, 31}, {29, 83, 43}, {37, 95, 59},
};

// Donor k's largest schedule shift, and its window's lanes beyond the
// block's (the largest shift less the smallest).
__host__ __device__ constexpr int shift_max(int k) {
  return k == 0 ? 37 : k == 1 ? 95 : 113;
}
__host__ __device__ constexpr int window_span(int k) {
  return k == 0 ? 36 : k == 1 ? 50 : 108;
}

struct DeArgs {
  const int* scalars;   // [7] i32: seed, 3 tile shifts, 3 lane shifts
  const float* pos;     // [D, N]
  const float* fit;     // [N]
  const float* r;       // [D, N] or null: draw in the kernel
  float* pos_out;       // [D, N]
  float* fit_out;       // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;       // global index of the launch's first step
  int objective;
  float f, cr, half_width;
};

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

__device__ __forceinline__ int floor_mod(long long v, int m) {
  const long long r = v % m;
  return static_cast<int>(r < 0 ? r + m : r);
}

// --------------------------------------------------------------------------
// Variant 0: the donor windows staged once a launch.
// --------------------------------------------------------------------------

// Mask words a lane keeps in shared memory: all but the last 32 genes'.
__host__ __device__ constexpr int mask_words(int dim) { return (dim - 1) >> 5; }

size_t staged_bytes(int dim, int lanes) {
  size_t floats = static_cast<size_t>(dim) * lanes;
  for (int k = 0; k < 3; ++k) {
    floats += static_cast<size_t>(dim) * (lanes + window_span(k));
  }
  return (floats + static_cast<size_t>(mask_words(dim)) * lanes) *
         sizeof(float);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// One step's view of the three windows: donor k of gene d of this lane at
// p[k][d * stride[k]].
struct Donors {
  const float* p[3];
  int stride[3];
};

__device__ __forceinline__ float mutant(const Donors& dn, int d, float f,
                                        float hw) {
  const float m = add(dn.p[0][d * dn.stride[0]],
                      mul(f, sub(dn.p[1][d * dn.stride[1]],
                                 dn.p[2][d * dn.stride[2]])));
  return fminf(fmaxf(m, -hw), hw);
}

// The step's crossing mask of one lane: bit d & 31 of word d >> 5, the
// last word in a register, the ones before it in shared memory.
struct Mask {
  const uint32_t* words;   // [mask_words][lanes], this lane's column
  int lanes;
  int last_word;
  uint32_t last;
  __device__ __forceinline__ bool crossed(int d) const {
    const int w = d >> 5;
    const uint32_t bits = w == last_word ? last : words[w * lanes];
    return (bits >> (d & 31)) & 1u;
  }
};

// Trial gene d, rebuilt from the staged operands (for the objectives that
// are not a sum of per-dimension terms).
struct Trial {
  const float* x;
  int lanes;
  Donors dn;
  Mask mask;
  float f, hw;
  __device__ __forceinline__ float operator()(int d) const {
    return mask.crossed(d) ? mutant(dn, d, f, hw) : x[d * lanes];
  }
};

// The uniforms of chunk q: the operand's (kHost, one step) or the
// kernel's Philox stream 0.
template <int kN, bool kHost>
__device__ __forceinline__ void chunk_uniforms(
    const DeArgs& a, const dsa::PhiloxOneLane& pl,
    const dsa::PhiloxOneStep& ps, int lane, int q, float u[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      u[j] = a.r[static_cast<size_t>(4 * q + j) * a.n + lane];
    }
  } else {
    const dsa::Philox4 w =
        dsa::philox_one_group(pl, ps, static_cast<uint32_t>(q));
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = dsa::uniform_from_bits(w.v[j]);
  }
}

// Genes 4 q .. 4 q + kN - 1 of the trial: their crossing bits into `bits`,
// their objective terms into `s`.
template <int kN, class Obj>
__device__ __forceinline__ void trial_chunk(const DeArgs& a,
                                            const Donors& dn,
                                            const float* x, int lanes,
                                            int q, const float u[4],
                                            float& s, uint32_t& bits) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const bool cross = u[j] < a.cr;
    // Both operands are loaded and the select takes one: loads behind a
    // branch go out one at a time.
    const float m = mutant(dn, d, a.f, a.half_width);
    const float keep = x[d * lanes];
    const float v = cross ? m : keep;
    bits |= static_cast<uint32_t>(cross) << (d & 31);
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kMaxLanes)
    de_staged_kernel(const DeArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int lanes = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int tile_n = a.tile_n;
  const int per_tile = (tile_n + lanes - 1) / lanes;
  const int tile = blockIdx.x / per_tile;
  const int j0 = (blockIdx.x - tile * per_tile) * lanes;
  const int n_tiles = a.n / tile_n;
  const size_t n = static_cast<size_t>(a.n);

  // Stage the three windows and the block's own lanes, [D][width] each
  // with the lane fastest.
  float* s_x = smem;
  float* s_win[3];
  int width[3];
  float* at = smem + static_cast<size_t>(dim) * lanes;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int len = lanes + window_span(k);
    const int tshift =
        floor_mod(static_cast<long long>(tile) + a.scalars[1 + k], n_tiles);
    const int start = floor_mod(static_cast<long long>(j0) -
                                    a.scalars[4 + k] - shift_max(k),
                                tile_n);
    const float* src = a.pos + static_cast<size_t>(tshift) * tile_n;
    for (int e = t; e < len; e += lanes) {
      const int from = (start + e) % tile_n;
      for (int d = 0; d < dim; ++d) {
        cp_async4(at + d * len + e, src + d * n + from);
      }
    }
    s_win[k] = at;
    width[k] = len;
    at += static_cast<size_t>(dim) * len;
  }
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(at) + t;
  const int jl = j0 + t;
  const bool live = jl < tile_n;
  const int lane = tile * tile_n + jl;
  if (live) {
    for (int d = 0; d < dim; ++d) {
      cp_async4(s_x + d * lanes + t, a.pos + d * n + lane);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();   // the only barrier: the tile's ragged end may leave
  if (!live) return;

  const float* x = s_x + t;
  float fit = a.fit[lane];
  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const dsa::PhiloxOneLane pl =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), 0u);
  const int full = dim >> 2;   // chunks of four; kR genes after them
  for (int step = 0; step < a.k_steps; ++step) {
    const int row = step & 7;
    Donors dn;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dn.p[k] = s_win[k] + t + shift_max(k) - kLaneShift[row][k];
      dn.stride[k] = width[k];
    }
    const dsa::PhiloxOneStep ps =
        dsa::philox_one_step(pl, a.step0 + static_cast<uint32_t>(step), seed);
    float s = -0.0f;
    uint32_t bits = 0;
    float u[4];
    if constexpr (!kHost) chunk_uniforms<4, false>(a, pl, ps, lane, 0, u);
    for (int q = 0; q < full; ++q) {
      float next[4];
      if constexpr (kHost) {
        chunk_uniforms<4, true>(a, pl, ps, lane, q, u);
      } else {
        // The next chunk's draws (the last chunk's after the last whole
        // one), drawn while this chunk's genes are computed.
        chunk_uniforms<4, false>(a, pl, ps, lane, q + 1, next);
      }
      trial_chunk<4, Obj>(a, dn, x, lanes, q, u, s, bits);
      if constexpr (!kHost) {
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] = next[j];
      }
      if ((q & 7) == 7 && 4 * q + 4 < dim) {
        s_mask[(q >> 3) * lanes] = bits;
        bits = 0;
      }
    }
    if constexpr (kR != 0) {
      if constexpr (kHost) chunk_uniforms<kR, true>(a, pl, ps, lane, full, u);
      trial_chunk<kR, Obj>(a, dn, x, lanes, full, u, s, bits);
    }
    const Mask mask{s_mask, lanes, mask_words(dim), bits};
    float tfit;
    if constexpr (Obj::kFold) {
      tfit = Obj::close(s, dim);
    } else {
      tfit = Obj::whole(Trial{x, lanes, dn, mask, a.f, a.half_width}, dim);
    }
    if (tfit <= fit) {
      fit = tfit;
      // The trial's genes again, branch-free: the crossed ones' mutants
      // recomputed, the others kept.
#pragma unroll 4
      for (int d = 0; d < dim; ++d) {
        const float m = mutant(dn, d, a.f, a.half_width);
        const float keep = x[d * lanes];
        s_x[d * lanes + t] = mask.crossed(d) ? m : keep;
      }
    }
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = x[d * lanes];
  a.fit_out[lane] = fit;
}

// --------------------------------------------------------------------------
// Variant 1: the donors read from global memory (the first version).
// --------------------------------------------------------------------------

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

__global__ void de_global_kernel(const DeArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  float* s_trial = smem + static_cast<size_t>(dim) * block + t;
  for (int d = 0; d < dim; ++d) s_pos[d * block] = a.pos[d * n + lane];
  float fit = a.fit[lane];

  const bool host_rng = a.r != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const long long tile_n = a.tile_n;
  const long long n_tiles = a.n / tile_n;
  const long long tile = lane / tile_n;
  const long long j = lane - tile * tile_n;
  const float* donor_tile[3];
  long long lshift[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    donor_tile[k] = a.pos + wrap(tile + a.scalars[1 + k], n_tiles) * tile_n;
    lshift[k] = a.scalars[4 + k];
  }

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float* da = donor_tile[0] + wrap(j - lshift[0] - kLaneShift[step & 7][0], tile_n);
    const float* db = donor_tile[1] + wrap(j - lshift[1] - kLaneShift[step & 7][1], tile_n);
    const float* dc = donor_tile[2] + wrap(j - lshift[2] - kLaneShift[step & 7][2], tile_n);
    for (int d0 = 0; d0 < dim; d0 += 4) {
      float u[4];
      if (host_rng) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = d0 + q < dim ? a.r[(d0 + q) * n + lane] : 0.0f;
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
          float v = s_pos[d * block];
          if (u[q] < a.cr) {
            const size_t off = static_cast<size_t>(d) * n;
            const float m =
                add(da[off], mul(a.f, sub(db[off], dc[off])));
            v = fminf(fmaxf(m, -a.half_width), a.half_width);
          }
          s_trial[d * block] = v;
        }
      }
    }
    const float tfit =
        dsa::evaluate_objective(a.objective, Column{s_trial, block}, dim);
    if (tfit <= fit) {
      fit = tfit;
      for (int d = 0; d < dim; ++d) s_pos[d * block] = s_trial[d * block];
    }
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = s_pos[d * block];
  a.fit_out[lane] = fit;
}

// Variant 1's threads per block: the largest of 128, 64, 32 whose two
// tiles fit, or 0 (D > 908).
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (2ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

template <int kR, int kObj, bool kHost>
cudaError_t launch_staged(const DeArgs& a, int lanes, size_t shared,
                          cudaStream_t s) {
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        de_staged_kernel<kR, kObj, kHost>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(
      (a.n / a.tile_n) * ((a.tile_n + lanes - 1) / lanes));
  de_staged_kernel<kR, kObj, kHost><<<blocks, lanes, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const DeArgs& a, int lanes, size_t shared,
                          cudaStream_t s) {
  return a.r != nullptr ? launch_staged<kR, kObj, true>(a, lanes, shared, s)
                        : launch_staged<kR, kObj, false>(a, lanes, shared, s);
}

template <int kR>
cudaError_t launch_objective(const DeArgs& a, int lanes, size_t shared,
                             cudaStream_t s) {
#define DSA_DE_CASE(k) \
  case dsa::k:         \
    return launch_source<kR, dsa::k>(a, lanes, shared, s);
  switch (a.objective) {
    DSA_DE_CASE(kSphere)
    DSA_DE_CASE(kRastrigin)
    DSA_DE_CASE(kAckley)
    DSA_DE_CASE(kRosenbrock)
    DSA_DE_CASE(kGriewank)
    DSA_DE_CASE(kSchwefel)
    DSA_DE_CASE(kLevy)
    DSA_DE_CASE(kZakharov)
    DSA_DE_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, lanes, shared, s);
  }
#undef DSA_DE_CASE
}

// Whether the entry runs `variant` with blocks of `lanes` lanes and
// `shared` bytes at this D: variant 0 needs a multiple of 32 lanes up to
// 512 and exactly its staged bytes, within a block's shared memory;
// variant 1 the first version's block and tiles.
bool geometry_ok(int variant, int lanes, int shared, int dim) {
  if (variant == 0) {
    return lanes >= 32 && lanes <= kMaxLanes && lanes % 32 == 0 &&
           static_cast<size_t>(shared) == staged_bytes(dim, lanes) &&
           static_cast<size_t>(shared) <= kMaxSharedBytes;
  }
  return variant == 1 && lanes != 0 && lanes == pick_block(dim) &&
         static_cast<size_t>(shared) == 2ull * dim * lanes * sizeof(float);
}

__global__ void philox_check_kernel(const uint32_t* lanes,
                                    const uint32_t* gs, const uint32_t* ctrs,
                                    const uint32_t* streams,
                                    const uint32_t* seeds, int n,
                                    uint32_t* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const dsa::PhiloxOneLane pl = dsa::philox_one_lane(lanes[e], streams[e]);
  const dsa::Philox4 w = dsa::philox_one_group(
      pl, dsa::philox_one_step(pl, ctrs[e], seeds[e]), gs[e]);
  const dsa::Philox4 r = dsa::philox4x32_10(lanes[e], gs[e], ctrs[e],
                                            streams[e], seeds[e], 0u);
  uint32_t* o = out + static_cast<size_t>(e) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = w.v[j];
    o[4 + j] = r.v[j];
  }
}

}  // namespace

// Variant 1's threads per block for `dim` (0: outside the envelope).
extern "C" int dsa_de_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: pos [D, N], fit [N], the draw r
// [D, N] (or null), pos_out [D, N], fit_out [N]; scalars [7] i32 (seed,
// three tile shifts, three lane shifts).  N is a multiple of tile_n.  The
// geometry (variant, lanes a block, shared bytes a block) is the wrapper's
// (de_geometry); one this entry cannot run is refused.  Launched on
// `stream` without synchronising.  Returns the CUDA error of the launch (0
// when accepted).
extern "C" int dsa_de_fused_f32(
    const int* scalars, const float* pos, const float* fit, const float* r,
    float* pos_out, float* fit_out, int n, int dim, int tile_n, int k_steps,
    unsigned step0, int objective, float f, float cr, float half_width,
    int variant, int lanes, int shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      (r && k_steps != 1) || !geometry_ok(variant, lanes, shared, dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeArgs a{scalars, pos, fit, r, pos_out, fit_out, n, dim, tile_n,
                 k_steps, step0, objective, f, cr, half_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    switch (dim & 3) {
      case 0: err = launch_objective<0>(a, lanes, shared, s); break;
      case 1: err = launch_objective<1>(a, lanes, shared, s); break;
      case 2: err = launch_objective<2>(a, lanes, shared, s); break;
      default: err = launch_objective<3>(a, lanes, shared, s);
    }
    return static_cast<int>(err);
  }
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(de_global_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + lanes - 1) / lanes;
  de_global_kernel<<<blocks, lanes, shared, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The words of philox_one.cuh's hoisted stream beside philox4x32_10's, for
// n counters (lane, group, step, stream) and seeds: out [n, 8], the hoisted
// four words then the plain call's.
extern "C" int dsa_de_philox_check(const unsigned* lanes, const unsigned* gs,
                                   const unsigned* ctrs,
                                   const unsigned* streams,
                                   const unsigned* seeds, int n,
                                   unsigned* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  philox_check_kernel<<<(n + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lanes, gs, ctrs, streams, seeds, n, out);
  return static_cast<int>(cudaGetLastError());
}
