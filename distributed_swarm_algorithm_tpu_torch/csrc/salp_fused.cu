// Fused salp-swarm steps for Hopper (sm_90a): k generations of the chain in
// one pass, with the best position visited recorded at every step.
//
// dsa_salp_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/salp_fused.py:
//   fused_salp_step_t (body _make_kernel).
//
// What one launch computes, for pos in the transposed layout [D, N] (salps
// along the fast axis), N a whole number of tiles of tile_n lanes, k_steps
// (<= 16) times, with t = it0 + step + 1:
//
//   c1 = 2 exp_fast(-(4 t / T)^2)          (2^x by bit field and polynomial)
//   global lane 0 (the leader):
//     x = F + sign(c3 - 1/2) c1 ((ub - lb) c2 + lb), c2, c3 [D] its draws
//   every other lane i:  x_i = (x_i + x_{i-1}) / 2, where the predecessor
//     of a tile's lane 0 is the previous tile's last lane as it was at the
//     launch's start (the chain link, fixed over the launch)
//   x clipped to +-half_width;  fit = objective(x)
//   per lane, the best (fit, x) seen since the launch's start, starting from
//   the input fit and position
//
// and the launch's best: the least of those running bests, the first of
// equal minima in lane order, with its position.  The food F is held fixed
// over the launch; it0 is read from the device.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; only global
// lane 0 draws: c2 with the counter (0, block of four dimensions, global
// step, 0), c3 the same on stream 1 (philox_pair.cuh draws both).  With
// c2/c3 given as operands ([D], one step only) the kernel reads them
// instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// exp_fast is the JAX package's bit-field 2^n times a degree-5 Horner
// polynomial (ops/cuda/salp_fused.py: exp2_fast), so kernel and plain
// version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 16 steps, rastrigin.
// Bytes: pos read and written once, fit read and written: 4 (2 D + 2) N
// bytes, 0.26 GB, 0.08 ms at 3.35 TB/s.  Operations per element and step:
// the follower (an add, a product, the clip: 4) and rastrigin (23): 27,
// and 3 per salp and step (the running best's test and select, the
// offset); 1.4e10 a launch, 0.20 ms at 67 TFLOP/s: operations bound it.
// The best position is needed for the launch's winner alone, so the bound
// charges no select of it; the winner's replay (below) is work the bound
// does not charge.
//
// Design (rule 2's redesign).  The first version (1.56 ms a launch at the
// main path's shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) staged
// two chain buffers and a best tile (3 D floats a lane, 16 warps an SM),
// evaluated the objective through a runtime switch with an unfolded serial
// sum, had warp 0 compute the 16 halo columns in a second pass that every
// warp waited for at the step's barrier, read the link from global memory
// at every step and stored D floats at every improvement.  Now:
//
//   - after k <= 16 steps lane i depends only on lanes i-k .. i of its tile
//     at the launch's start, the leader and the link.  A block owns `lanes`
//     consecutive lanes of one tile (512 at the main path; lanes divides
//     tile_n) and runs lanes + 16 threads, thread c holding column c of the
//     window, tile lane j0 - 16 + c: the 16 halo columns have threads of
//     their own.  A halo column's value goes stale one column a step from
//     the left, which never reaches an owned column within 16 steps;
//   - one staged buffer: each thread keeps its own column in shared memory
//     ([D][lanes + 16], thread-private, so no bank conflicts and no
//     barrier for it) and computes a chunk of four dimensions in registers
//     from its column and its left neighbour's, which __shfl_up_sync brings
//     from the lane before it.  Lane 0 of a warp reads the previous warp's
//     last column as it was before the step from a published slot, which
//     that warp's lane 31 writes with its new value for the next step
//     (double-buffered by the step's parity), so a step needs one barrier;
//   - the link is read once a launch into the halo column of tile lane -1,
//     which holds it (its thread never stores); the leader warp (warp 0 of
//     the first block) runs the chunk loop's other instantiation, which
//     draws c2 and c3 with one philox_pair_group call a group of four;
//   - no best tile: each lane keeps only (best fit, best step).  The block's
//     winner (the first least) is rebuilt at its best step b: the block's
//     full warps, each over some of the dimensions, replay b steps from the
//     launch's input over the 16 lanes to its left (the same operations,
//     leader draws and link), so the result is the plain version's bit for
//     bit;
//   - templates on D mod 4 (the chunks of four run unmasked), on the
//     objective (a sum of per-dimension terms folds into the chunk loop, in
//     ascending d from -0, as the plain version sums; the others evaluate
//     the column after it) and on the draws' source.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/salp_fused.py).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "philox_pair.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kHalo = 16;      // the most steps one launch may take
constexpr int kMaxDim = 452;   // the envelope the first version took
constexpr unsigned kFull = 0xffffffffu;
// Lanes a block may own (ops/cuda/salp_fused.py: SALP_LANES).
constexpr int kMaxLanes = 512;
constexpr int kMinLanes = 32;
// Registers a thread, so that two blocks of 528 threads (34 warps) or four
// of 272 (36) stay resident on an SM.
constexpr int kMaxRegisters = 56;

struct SalpArgs {
  const int* scalars;     // [2] i32 on the device: seed, block-start iteration
  const float* food;      // [D]
  const float* pos;       // [D, N]
  const float* fit;       // [N]
  const float* r2;        // [D] or null: the leader draws in the kernel
  const float* r3;        // [D]
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  float* block_fit;       // [blocks]
  float* block_pos;       // [D, blocks]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float t_max, span, lb, half_width;
  int lanes;              // lanes a block owns
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

__device__ __forceinline__ float clip(float v, float hw) {
  return fminf(fmaxf(v, -hw), hw);
}

__device__ __forceinline__ bool better(float fit, int lane, float other_fit,
                                      int other) {
  return fit < other_fit || (fit == other_fit && lane < other);
}

// Dynamic shared memory of a block owning `lanes` lanes: the window's
// columns [D][lanes + 16], the published columns [2][warps][D4] (rows of
// whole float4s, so a chunk reads and writes its four in one access) and
// the winner's reduction [3][32].
size_t chain_bytes(int dim, int lanes) {
  const size_t width = static_cast<size_t>(lanes) + kHalo;
  const size_t warps = (width + 31) / 32;
  const size_t d4 = (dim + 3) & ~3;
  return (dim * width + 2 * warps * d4 + 3 * 32) * sizeof(float);
}

// The envelope c1 at step `step` of the launch.
__device__ __forceinline__ float leader_c1(int it0, int step, float t_max) {
  const float tt = static_cast<float>(it0 + step + 1);
  const float z = div(mul(4.0f, tt), t_max);
  return mul(2.0f, dsa::fast::exp_fast(mul(-1.0f, mul(z, z))));
}

// The leader's coordinate d from its two uniforms.
__device__ __forceinline__ float leader_at(const SalpArgs& a, int d,
                                           float c1, float u2, float u3) {
  const float sign = u3 >= 0.5f ? 1.0f : -1.0f;
  return clip(add(a.food[d], mul(mul(sign, c1), add(mul(a.span, u2), a.lb))),
              a.half_width);
}

// What a thread knows of its column at one step.
struct Chain {
  float* col;           // the thread's column, stride width
  const float* in;      // the published column it reads (lane 0), [D4]
  float* out;           // the slot it publishes to (lane 31), [D4]
  int width;
  unsigned mask;        // the warp's threads
  bool lane0, publish, frozen, leader;
};

// Chunk q (kN dimensions from 4 q) of one step: every column moves to the
// mean of itself and its left neighbour, clipped; the leader (kLead, the
// leader warp's instantiation) takes its own move instead.
template <int kN, class Obj, bool kLead, bool kHost>
__device__ __forceinline__ void chain_chunk(
    const SalpArgs& a, const Chain& c, const dsa::PhiloxPairLane& pl,
    const dsa::PhiloxPairStep& ps, float c1, int q, float& s) {
  const int d0 = 4 * q;
  float x[4], nb[4];
#pragma unroll
  for (int j = 0; j < kN; ++j) x[j] = c.col[(d0 + j) * c.width];
#pragma unroll
  for (int j = 0; j < kN; ++j) nb[j] = __shfl_up_sync(c.mask, x[j], 1);
  if (c.lane0) {
    // The previous warp's last column, four at once.
    const float4 p = *reinterpret_cast<const float4*>(c.in + d0);
    nb[0] = p.x;
    nb[1] = p.y;
    nb[2] = p.z;
    nb[3] = p.w;
  }
  float u2[4], u3[4];
  if constexpr (kLead) {
    if constexpr (kHost) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        u2[j] = a.r2[d0 + j];
        u3[j] = a.r3[d0 + j];
      }
    } else {
      dsa::Philox4 w[2];
      dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(q), w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        u2[j] = dsa::uniform_from_bits(w[0].v[j]);
        u3[j] = dsa::uniform_from_bits(w[1].v[j]);
      }
    }
  }
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    v[j] = clip(mul(0.5f, add(x[j], nb[j])), a.half_width);
    if constexpr (kLead) {
      if (c.leader) v[j] = leader_at(a, d0 + j, c1, u2[j], u3[j]);
    }
    if (!c.frozen) c.col[(d0 + j) * c.width] = v[j];
    if constexpr (Obj::kFold) s = add(s, Obj::term(v[j]));
  }
  if (c.publish) {
    *reinterpret_cast<float4*>(c.out + d0) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int kR, class Obj, bool kLead, bool kHost>
__device__ __forceinline__ float chain_step(const SalpArgs& a, const Chain& c,
                                            int it0, int step, uint32_t seed) {
  dsa::PhiloxPairLane pl{};
  dsa::PhiloxPairStep ps{};
  float c1 = 0.0f;
  if constexpr (kLead) {
    c1 = leader_c1(it0, step, a.t_max);
    if constexpr (!kHost) {
      pl = dsa::philox_pair_lane(0u, 0u, 1u);
      ps = dsa::philox_pair_step(pl, a.step0 + static_cast<uint32_t>(step),
                                 seed);
    }
  }
  float s = -0.0f;
  const int full = a.dim >> 2;
#pragma unroll 1
  for (int q = 0; q < full; ++q) {
    chain_chunk<4, Obj, kLead, kHost>(a, c, pl, ps, c1, q, s);
  }
  if constexpr (kR != 0) {
    chain_chunk<kR, Obj, kLead, kHost>(a, c, pl, ps, c1, full, s);
  }
  if constexpr (Obj::kFold) {
    return Obj::close(s, a.dim);
  } else {
    return Obj::whole(Column{c.col, c.width}, a.dim);
  }
}

// The leader's coordinate d at step `step` of the launch, drawn alone: what
// the chunk loop computes, for the winner's replay.
template <bool kHost>
__device__ float leader_replayed(const SalpArgs& a, int d, int it0, int step,
                                 uint32_t seed) {
  float u2, u3;
  if constexpr (kHost) {
    u2 = a.r2[d];
    u3 = a.r3[d];
  } else {
    const uint32_t g = static_cast<uint32_t>(d >> 2);
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    u2 = dsa::uniform_from_bits(
        dsa::philox4x32_10(0u, g, ctr, 0u, seed, 0u).v[d & 3]);
    u3 = dsa::uniform_from_bits(
        dsa::philox4x32_10(0u, g, ctr, 1u, seed, 0u).v[d & 3]);
  }
  return leader_at(a, d, leader_c1(it0, step, a.t_max), u2, u3);
}

template <int kR, int kObj, bool kHost>
__global__ void __maxnreg__(kMaxRegisters) salp_chain_kernel(const SalpArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int lanes = a.lanes;
  const int width = lanes + kHalo;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int warps = (width + 31) >> 5;
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  const int d4 = (dim + 3) & ~3;
  float* pub = smem + dim * width;                    // [2][warps][D4]
  float* red_fit = pub + 2 * warps * d4;              // [32]
  int* red_lane = reinterpret_cast<int*>(red_fit + 32);
  int* red_step = red_lane + 32;

  // 32-bit lanes: N < 2^31.
  const int first = blockIdx.x * lanes;
  const int tile = first / a.tile_n;
  const int j0 = first - tile * a.tile_n;
  const int n_tiles = a.n / a.tile_n;
  const size_t tile_base = static_cast<size_t>(tile) * a.tile_n;
  const int j = j0 - kHalo + t;             // the column's tile lane
  const bool owned = t >= kHalo;

  Chain c;
  c.col = smem + t;
  c.width = width;
  c.mask = width - 32 * warp >= 32 ? kFull
                                   : (1u << (width - 32 * warp)) - 1u;
  c.lane0 = lane == 0;
  c.publish = lane == 31 && warp + 1 < warps;
  c.frozen = j == -1;
  c.leader = first == 0 && t == kHalo;
  const bool leader_warp = first == 0 && warp == 0;

  // The window at the launch's start, eight loads in flight; the link in
  // the column of lane -1; zeros before it (never read by an owned lane).
  const size_t link = static_cast<size_t>((tile + n_tiles - 1) % n_tiles) *
                          a.tile_n + a.tile_n - 1;
  const float* src = j >= 0 ? a.pos + tile_base + j : a.pos + link;
  const bool loads = j >= -1;
  float* slot = pub + (warp + 1) * d4;   // the first step's, by lane 31
  for (int d0 = 0; d0 < dim; d0 += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      v[q] = loads && d0 + q < dim ? __ldg(src + (d0 + q) * n) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (d0 + q < dim) {
        c.col[(d0 + q) * width] = v[q];
        if (c.publish) slot[d0 + q] = v[q];
      }
    }
  }
  if (warp == 0) {
    // Warp 0's lane 0 (the window's first column) has no warp before it;
    // and the slots' padding past D.
    for (int d = lane; d < d4; d += 32) {
      pub[d] = 0.0f;
      pub[warps * d4 + d] = 0.0f;
    }
  }
  float best_fit = owned ? a.fit[first + t - kHalo] : 0.0f;
  float fit = best_fit;
  int best_step = 0;
  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const int it0 = a.scalars[1];
  __syncthreads();

  for (int step = 0; step < a.k_steps; ++step) {
    const int parity = step & 1;
    c.in = pub + (parity * warps + warp) * d4;
    c.out = pub + ((parity ^ 1) * warps + warp + 1) * d4;
    fit = leader_warp ? chain_step<kR, Obj, true, kHost>(a, c, it0, step, seed)
                      : chain_step<kR, Obj, false, kHost>(a, c, it0, step,
                                                          seed);
    if (fit < best_fit) {
      best_fit = fit;
      best_step = step + 1;
    }
    __syncthreads();
  }

  if (owned) {
    const size_t lane_g = static_cast<size_t>(first) + t - kHalo;
    for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane_g] = c.col[d * width];
    a.fit_out[lane_g] = fit;
  }

  // The block's winner: the least running best, the lowest lane among
  // equals, with its best step.  The halo takes no part.
  float bf = owned ? best_fit : __int_as_float(0x7f800000);  // +inf
  int bl = owned ? t - kHalo : INT_MAX;
  int bs = best_step;
  const int active = __popc(c.mask);
  for (int off = 16; off > 0; off >>= 1) {
    const float of = __shfl_down_sync(c.mask, bf, off);
    const int ol = __shfl_down_sync(c.mask, bl, off);
    const int os = __shfl_down_sync(c.mask, bs, off);
    if (lane + off < active && better(of, ol, bf, bl)) {
      bf = of;
      bl = ol;
      bs = os;
    }
  }
  if (lane == 0) {
    red_fit[warp] = bf;
    red_lane[warp] = bl;
    red_step[warp] = bs;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < warps; ++w) {
      if (better(red_fit[w], red_lane[w], bf, bl)) {
        bf = red_fit[w];
        bl = red_lane[w];
        bs = red_step[w];
      }
    }
    a.block_fit[blockIdx.x] = bf;
    red_lane[0] = bl;
    red_step[0] = bs;
  }
  __syncthreads();

  // The winner's position at its best step, replayed from the launch's
  // input: lane r of a full warp holds tile lane jw - 16 + r (r <= 16), the
  // link held at lane -1, the leader moved by its draws; each full warp
  // takes every warps_full-th dimension.
  const int jw = j0 + red_lane[0];
  const int b = red_step[0];
  const int warps_full = width >> 5;
  if (warp >= warps_full) return;
  const int jr = jw - kHalo + lane;
  const bool in_window = lane <= kHalo;
  const bool moves = jr >= 0 && in_window;
  const bool lead = tile == 0 && jr == 0;
  for (int d = warp; d < dim; d += warps_full) {
    float v = moves ? a.pos[d * n + tile_base + jr]
                    : jr == -1 ? a.pos[d * n + link] : 0.0f;
    for (int s = 0; s < b; ++s) {
      const float nb = __shfl_up_sync(kFull, v, 1);
      if (lead) {
        v = leader_replayed<kHost>(a, d, it0, s, seed);
      } else if (moves) {
        v = clip(mul(0.5f, add(v, nb)), a.half_width);
      }
    }
    if (lane == kHalo) {
      a.block_pos[static_cast<size_t>(d) * gridDim.x + blockIdx.x] = v;
    }
  }
}

// --------------------------------------------------------------------------
// Launch.
// --------------------------------------------------------------------------

// The most lanes a block may own at this D in a tile that any block
// divides: the largest of 512, 256, ..., 32 whose bytes fit, or 0 past the
// envelope (D > 452).
int pick_lanes(int dim) {
  if (dim <= 0 || dim > kMaxDim) return 0;
  for (int lanes = kMaxLanes; lanes >= kMinLanes; lanes >>= 1) {
    if (chain_bytes(dim, lanes) <= kMaxSharedBytes) return lanes;
  }
  return 0;
}

// Whether the entry runs blocks owning `lanes` lanes with `shared` bytes:
// a power of two from 32 to 512 that divides the tile, within the envelope
// and with exactly its layout's bytes within a block's shared memory.
bool geometry_ok(int lanes, int shared, int dim, int tile_n) {
  if (lanes < kMinLanes || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0 ||
      tile_n % lanes != 0 || dim > kMaxDim) {
    return false;
  }
  const size_t bytes = chain_bytes(dim, lanes);
  return static_cast<size_t>(shared) == bytes && bytes <= kMaxSharedBytes;
}

template <int kR, int kObj, bool kHost>
cudaError_t launch_chain(const SalpArgs& a, size_t shared, cudaStream_t s) {
  auto* kernel = salp_chain_kernel<kR, kObj, kHost>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>(a.n / a.lanes);
  kernel<<<blocks, a.lanes + kHalo, shared, s>>>(a);
  return cudaGetLastError();
}

template <int kR, int kObj>
cudaError_t launch_source(const SalpArgs& a, size_t shared, cudaStream_t s) {
  return a.r2 != nullptr ? launch_chain<kR, kObj, true>(a, shared, s)
                         : launch_chain<kR, kObj, false>(a, shared, s);
}

template <int kR>
cudaError_t launch_objective(const SalpArgs& a, size_t shared,
                             cudaStream_t s) {
#define DSA_SALP_CASE(k) \
  case dsa::k:           \
    return launch_source<kR, dsa::k>(a, shared, s);
  switch (a.objective) {
    DSA_SALP_CASE(kSphere)
    DSA_SALP_CASE(kRastrigin)
    DSA_SALP_CASE(kAckley)
    DSA_SALP_CASE(kRosenbrock)
    DSA_SALP_CASE(kGriewank)
    DSA_SALP_CASE(kSchwefel)
    DSA_SALP_CASE(kLevy)
    DSA_SALP_CASE(kZakharov)
    DSA_SALP_CASE(kStyblinskiTang)
    default:
      return launch_source<kR, dsa::kMichalewicz>(a, shared, s);
  }
#undef DSA_SALP_CASE
}

}  // namespace

// Lanes a block owns for `dim` in a tile any block divides (0: outside the
// envelope), as ops/cuda/salp_fused.py: kernel_block picks them.
extern "C" int dsa_salp_fused_block(int dim) { return pick_lanes(dim); }

// All arrays f32, contiguous, on `device`: food [D], pos [D, N], fit [N],
// r2/r3 [D] (both or neither), pos_out [D, N], fit_out [N], block_fit
// [N / lanes], block_pos [D, N / lanes]; scalars [2] i32 (seed,
// block-start iteration).  N is a multiple of tile_n, and tile_n of 128.
// The geometry (lanes a block, shared bytes a block) is the wrapper's
// (salp_geometry); one this entry cannot run is refused.  Launched on
// `stream` without synchronising.  Returns the CUDA error of the launch (0
// when accepted).
extern "C" int dsa_salp_fused_f32(
    const int* scalars, const float* food, const float* pos, const float* fit,
    const float* r2, const float* r3, float* pos_out, float* fit_out,
    float* block_fit, float* block_pos, int n, int dim, int tile_n,
    int k_steps, unsigned step0, int objective, float t_max, float span,
    float lb, float half_width, int lanes, int shared, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || k_steps > kHalo ||
      tile_n <= 0 || tile_n % 128 != 0 || n % tile_n != 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || (r2 == nullptr) != (r3 == nullptr) ||
      (r2 != nullptr && k_steps != 1) ||
      !geometry_ok(lanes, shared, dim, tile_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SalpArgs a{scalars, food, pos, fit, r2, r3, pos_out, fit_out,
                   block_fit, block_pos, n, dim, tile_n, k_steps, step0,
                   objective, t_max, span, lb, half_width, lanes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim & 3) {
    case 0: err = launch_objective<0>(a, shared, s); break;
    case 1: err = launch_objective<1>(a, shared, s); break;
    case 2: err = launch_objective<2>(a, shared, s); break;
    default: err = launch_objective<3>(a, shared, s);
  }
  // A refused call leaves its error pending: clear it, so that the next
  // launch does not report it as its own.
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
