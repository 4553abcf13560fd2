// Fused SHADE-R generation for Hopper (sm_90a): one current-to-pbest/1
// generation with rotational donors.
//
// dsa_shade_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/shade_fused.py:
//   fused_shade_step_t (body _make_kernel).
//
// What one launch computes, for pos and archive in the transposed layout
// [D, N], N a whole number of tiles of tile_n lanes (a multiple of 128),
// for lane j of tile i:
//
//   roll(X, t, l)[j] = lane (j - l) mod tile_n of tile (i + t) mod n_tiles
//   r1 = roll(pos, s1, l1);  r2 = u_src < frac / 65536 ? roll(archive, s3,
//   l3) : roll(pos, s2, l2);  pb = elite column (j - le) mod 128
//   mutant = clip((x + F (pb - x)) + F (r1 - r2), +-half_width)
//   trial  = u_cross < CR ? mutant : x      (per gene, no j_rand)
//   x, fit = f(trial) <= fit ? (trial, f(trial)) : (x, fit)
//
// with F and CR per individual ([N] rows), the elite pool [D, 128], and
// the shifts and frac read from the device.  Every read comes from an
// input, so lanes are independent.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; u_cross is
// stream 0 over the dimensions, counter (lane, block of four dimensions,
// generation, 0); u_src is word 0 of the call (lane, 0, generation, 1).
// The generation comes by value or, for a run replayed from a CUDA graph,
// from a counter on the device that the graph advances.  With both draws
// given as operands the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no
// contraction, so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, rastrigin.  Bytes: pos
// and archive read once, fit, F and CR read once, the elite pool, pos and
// fit written: 4 (3 D + 4) N + 512 D bytes, 0.39 GB, 0.117 ms at 3.35
// TB/s.  Operations per element: the draw (28), the crossover test (1),
// the source select (1), the mutant with its clip (9), the select (1),
// rastrigin (23): 63; per individual 128 (the source draw's call and
// uniform, the donor lanes); 2.1e9, 0.031 ms at 67 TFLOP/s: bytes bound it.
// A design that keeps to its own lane reads x, r1 and r2 and writes the
// trial or x: 4 x 4 D N bytes, 0.50 GB, 0.150 ms.  pos (126 MB) is more
// than L2 holds and the donors lie a random tile shift away, so r1 and r2
// come from device memory; a warp's r2 lanes split between pos and the
// archive, so both sources' sectors are read.
//
// Design (rule 2's redesign).  The first version read x from device memory
// twice (once for the trial, once more for the output where the trial
// lost), loaded the donors behind the crossover branch one gene at a time
// (a few loads in flight a thread at 28 warps an SM), drew with a plain
// Philox call a group and evaluated the objective behind a runtime switch
// over a staged trial.  Now one thread a lane, a block of 128 lanes (64 or
// 32 where D is wide):
//   - x and the trial are kept on chip: each gene's x and trial go into two
//     [D][block] tiles in shared memory, so the accept select and the write
//     read shared memory, not pos;
//   - a chunk of four genes issues its x, r1, r2 and elite loads together,
//     none behind a branch (a warp's sectors are read whatever the
//     crossover picks, since a sector holds eight lanes), so 12 loads from
//     device memory are in flight a thread before the first use; the
//     elite pool (15 KB) comes through L1;
//   - the crossover stream's lane-only and generation-only Philox products
//     are hoisted (philox_one.cuh: 16 products a group of four genes where
//     the plain call takes 20; u_src's call likewise);
//   - templates on D mod 4, the objective (folded into the gene loop where
//     it is a sum of per-dimension terms) and the draws' source.
//   Shared memory: 2 x 4 D x block bytes, 30 KB at D = 30; 80 registers
//   (__launch_bounds__(128, 6)) keep six blocks (24 warps) an SM.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/shade_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox_one.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kElite = 128;
constexpr int kMaxLanes = 128;
// The envelope: the widest D the first version took, kept so that the
// fused path covers the same configurations.
constexpr int kMaxDim = 363;

struct ShadeArgs {
  const int* scalars;     // [9] i32: seed, s1, s2, s3, l1, l2, l3, le, frac
  const int* step_dev;    // [1] i32 or null: the generation on the device
  const float* pos;       // [D, N]
  const float* fit;       // [N]
  const float* f_row;     // [N]
  const float* cr_row;    // [N]
  const float* archive;   // [D, N]
  const float* elite;     // [D, 128]
  const float* r_cross;   // [D, N] or null: draw in the kernel
  const float* r_src;     // [N]
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  int n;
  int dim;
  int tile_n;
  uint32_t step;          // the generation (Philox counter word 2) where
                          // step_dev is null
  int objective;
  float half_width;
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

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

// One lane's view of a launch: where its genes, donors and pbest column
// start (gene d at d * n), its F and CR, and its two tiles.
struct Lane {
  const float* x;
  const float* r1;
  const float* r2;
  const float* pb;      // elite column, gene d at d * kElite
  float* s_x;           // [D][lanes] tile, this lane's column
  float* s_t;
  size_t n;
  int lanes;
  float f, cr, hw;
};

// The uniforms of genes 4 q .. 4 q + kN - 1: the operand's or stream 0's.
template <int kN, bool kHost>
__device__ __forceinline__ void chunk_uniforms(
    const ShadeArgs& a, const dsa::PhiloxOneLane& pl,
    const dsa::PhiloxOneStep& ps, int lane, int q, float u[4]) {
  if constexpr (kHost) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      u[j] = a.r_cross[static_cast<size_t>(4 * q + j) * a.n + lane];
    }
  } else {
    const dsa::Philox4 w =
        dsa::philox_one_group(pl, ps, static_cast<uint32_t>(q));
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = dsa::uniform_from_bits(w.v[j]);
  }
}

// Genes 4 q .. 4 q + kN - 1: their operands loaded together, then the
// trial gene by gene into the tiles and its objective terms into `s`.
template <int kN, class Obj>
__device__ __forceinline__ void gene_chunk(const Lane& l, int q,
                                           const float u[4], float& s) {
  float x[kN], v1[kN], v2[kN], pb[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const size_t off = static_cast<size_t>(4 * q + j) * l.n;
    x[j] = l.x[off];
    v1[j] = l.r1[off];
    v2[j] = l.r2[off];
    pb[j] = __ldg(l.pb + (4 * q + j) * kElite);
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int d = 4 * q + j;
    const float m = add(add(x[j], mul(l.f, sub(pb[j], x[j]))),
                        mul(l.f, sub(v1[j], v2[j])));
    const float v = u[j] < l.cr ? fminf(fmaxf(m, -l.hw), l.hw) : x[j];
    l.s_x[d * l.lanes] = x[j];
    l.s_t[d * l.lanes] = v;
    if constexpr (Obj::kFold) s = add(s, Obj::term(v));
  }
}

template <int kR, int kObj, bool kHost>
__global__ void __launch_bounds__(kMaxLanes, 6)
    shade_staged_kernel(const ShadeArgs a) {
  using Obj = dsa::ObjectiveOf<kObj>;
  extern __shared__ __align__(16) float smem[];
  const int lanes = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * lanes + t;
  if (lane_ll >= a.n) return;  // no barrier: a thread reads its own columns
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);

  const uint32_t step =
      a.step_dev != nullptr ? static_cast<uint32_t>(*a.step_dev) : a.step;
  const uint32_t seed = kHost ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const long long tile_n = a.tile_n;
  const long long n_tiles = a.n / tile_n;
  const long long tile = lane / tile_n;
  const long long j = lane - tile * tile_n;
  float u_src;
  if constexpr (kHost) {
    u_src = a.r_src[lane];
  } else {
    const dsa::PhiloxOneLane pl1 =
        dsa::philox_one_lane(static_cast<uint32_t>(lane), 1u);
    u_src = dsa::uniform_from_bits(
        dsa::philox_one_group(pl1, dsa::philox_one_step(pl1, step, seed), 0u)
            .v[0]);
  }
  const float frac = div(static_cast<float>(a.scalars[8]), 65536.0f);
  const float* r2 =
      u_src < frac
          ? a.archive + wrap(tile + a.scalars[3], n_tiles) * tile_n +
                wrap(j - a.scalars[6], tile_n)
          : a.pos + wrap(tile + a.scalars[2], n_tiles) * tile_n +
                wrap(j - a.scalars[5], tile_n);
  const Lane l{a.pos + lane,
               a.pos + wrap(tile + a.scalars[1], n_tiles) * tile_n +
                   wrap(j - a.scalars[4], tile_n),
               r2,
               a.elite + wrap(j - a.scalars[7], kElite),
               smem + t,
               smem + static_cast<size_t>(dim) * lanes + t,
               n,
               lanes,
               a.f_row[lane],
               a.cr_row[lane],
               a.half_width};

  const dsa::PhiloxOneLane pl =
      dsa::philox_one_lane(static_cast<uint32_t>(lane), 0u);
  const dsa::PhiloxOneStep ps = dsa::philox_one_step(pl, step, seed);
  float s = -0.0f;
  float u[4];
  const int full = dim >> 2;   // chunks of four; kR genes after them
#pragma unroll 1
  for (int q = 0; q < full; ++q) {
    chunk_uniforms<4, kHost>(a, pl, ps, lane, q, u);
    gene_chunk<4, Obj>(l, q, u, s);
  }
  if constexpr (kR != 0) {
    chunk_uniforms<kR, kHost>(a, pl, ps, lane, full, u);
    gene_chunk<kR, Obj>(l, full, u, s);
  }
  float tfit;
  if constexpr (Obj::kFold) {
    tfit = Obj::close(s, dim);
  } else {
    tfit = Obj::whole(Column{l.s_t, lanes}, dim);
  }
  const float fit = a.fit[lane];
  const bool accept = tfit <= fit;
  const float* src = accept ? l.s_t : l.s_x;
  float* out = a.pos_out + lane;
#pragma unroll 1
  for (int q = 0; q < full; ++q) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[static_cast<size_t>(4 * q + k) * n] = src[(4 * q + k) * lanes];
    }
  }
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    out[static_cast<size_t>(4 * full + k) * n] = src[(4 * full + k) * lanes];
  }
  a.fit_out[lane] = accept ? tfit : fit;
}

size_t shared_bytes(int dim, int block) {
  return 2ull * dim * block * sizeof(float);
}

// Threads per block: the largest of 128, 64, 32 whose two tiles fit, or 0
// (D outside the envelope).
int pick_block(int dim) {
  if (dim <= 0 || dim > kMaxDim) return 0;
  for (int block = kMaxLanes; block >= 32; block >>= 1) {
    if (shared_bytes(dim, block) <= kMaxSharedBytes) return block;
  }
  return 0;
}

using KernelFn = void (*)(const ShadeArgs);

template <int kR, int kObj>
KernelFn kernel_of_source(bool host) {
  return host ? shade_staged_kernel<kR, kObj, true>
              : shade_staged_kernel<kR, kObj, false>;
}

template <int kR>
KernelFn kernel_of_objective(int objective, bool host) {
#define DSA_SHADE_CASE(k) \
  case dsa::k:            \
    return kernel_of_source<kR, dsa::k>(host);
  switch (objective) {
    DSA_SHADE_CASE(kSphere)
    DSA_SHADE_CASE(kRastrigin)
    DSA_SHADE_CASE(kAckley)
    DSA_SHADE_CASE(kRosenbrock)
    DSA_SHADE_CASE(kGriewank)
    DSA_SHADE_CASE(kSchwefel)
    DSA_SHADE_CASE(kLevy)
    DSA_SHADE_CASE(kZakharov)
    DSA_SHADE_CASE(kStyblinskiTang)
    default:
      return kernel_of_source<kR, dsa::kMichalewicz>(host);
  }
#undef DSA_SHADE_CASE
}

// The instantiation a launch at this D, objective and draws' source runs.
KernelFn kernel_of(int dim, int objective, bool host) {
  switch (dim & 3) {
    case 0: return kernel_of_objective<0>(objective, host);
    case 1: return kernel_of_objective<1>(objective, host);
    case 2: return kernel_of_objective<2>(objective, host);
    default: return kernel_of_objective<3>(objective, host);
  }
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_shade_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: pos [D, N], fit, f_row, cr_row
// [N], archive [D, N], elite [D, 128], the draws r_cross [D, N] and r_src
// [N] (both or neither), pos_out [D, N], fit_out [N]; scalars [9] i32;
// step_dev [1] i32 (the generation, read by the kernel) or null (`step`).
// N is a multiple of tile_n, tile_n of 128.  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_shade_fused_f32(
    const int* scalars, const int* step_dev, const float* pos,
    const float* fit, const float* f_row, const float* cr_row,
    const float* archive, const float* elite, const float* r_cross,
    const float* r_src, float* pos_out, float* fit_out, int n, int dim,
    int tile_n, unsigned step, int objective, float half_width, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  if (n <= 0 || block == 0 || tile_n <= 0 || n % tile_n != 0 ||
      tile_n % kElite != 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || (!r_cross != !r_src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ShadeArgs a{scalars, step_dev, pos, fit, f_row, cr_row, archive,
                    elite, r_cross, r_src, pos_out, fit_out, n, dim, tile_n,
                    step, objective, half_width};
  const KernelFn kernel = kernel_of(dim, objective, r_cross != nullptr);
  const size_t shared = shared_bytes(dim, block);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  kernel<<<blocks, block, shared, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
