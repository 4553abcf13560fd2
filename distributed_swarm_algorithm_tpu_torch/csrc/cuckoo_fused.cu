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
// Design (first, simple version).  The egg roll reads the whole tile's
// candidates of the same generation, so one block of up to 512 threads runs
// one tile, each thread holding lanes t, t + 512, ... (neighbouring threads
// on neighbouring addresses).  A tile (480 KB at 4,096 x 30) does not fit
// shared memory: each generation writes its candidates and their fitness
// to a global scratch pair, a __syncthreads() orders them, then each lane
// reads its egg; the generations ping-pong between the outputs and a second
// scratch pair in global memory, the last landing in the outputs, with a
// __syncthreads() after each generation's writes.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/cuckoo_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr int kMaxThreads = 512;

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
  float* scratch_pos;   // [D, N] (the outputs when k_steps == 1)
  float* scratch_fit;   // [N]
  float* cand;          // [D, N] a generation's candidates
  float* cand_fit;      // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;       // global index of the launch's first step
  int objective;
  float half_width, pa, step_scale, sigma, neg_inv_beta;
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

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

__device__ __forceinline__ float clip(float v, float hw) {
  return dsa::fast::clip(v, -hw, hw);
}

__global__ void __launch_bounds__(kMaxThreads)
    cuckoo_fused_kernel(const CuckooArgs a) {
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

}  // namespace

// Threads of the block that runs one tile of `tile_n` lanes.
extern "C" int dsa_cuckoo_fused_threads(int tile_n) {
  const int warps = (tile_n + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

// All arrays f32, contiguous, on `device`: best [D], pos [D, N], fit [N],
// the draws r_levy1, r_levy2 [D, N], r_ab [N], r_walk [D, N] (all four or
// none), pos_out [D, N], fit_out [N], the scratch pair of the same shapes
// (only read as a distinct pair when k_steps > 1) and the candidates' pair
// cand [D, N], cand_fit [N]; scalars [6] i32.  N is a multiple of tile_n.
// Launched on `stream` without synchronising, one block per tile.  Returns
// the CUDA error of the launch (0 when accepted).
extern "C" int dsa_cuckoo_fused_f32(
    const int* scalars, const float* best, const float* pos, const float* fit,
    const float* r_levy1, const float* r_levy2, const float* r_ab,
    const float* r_walk, float* pos_out, float* fit_out, float* scratch_pos,
    float* scratch_fit, float* cand, float* cand_fit, int n, int dim,
    int tile_n, int k_steps, unsigned step0, int objective, float half_width,
    float pa, float step_scale, float sigma, float neg_inv_beta, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool some = r_levy1 || r_levy2 || r_ab || r_walk;
  const bool all = r_levy1 && r_levy2 && r_ab && r_walk;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      some != all || (all && k_steps != 1) ||
      (k_steps > 1 && (scratch_pos == pos_out || scratch_fit == fit_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CuckooArgs a{scalars, best, pos, fit, r_levy1, r_levy2, r_ab,
                     r_walk, pos_out, fit_out, scratch_pos, scratch_fit,
                     cand, cand_fit, n, dim, tile_n, k_steps, step0,
                     objective, half_width, pa, step_scale, sigma,
                     neg_inv_beta};
  const unsigned blocks = static_cast<unsigned>(n / tile_n);
  cuckoo_fused_kernel<<<blocks, dsa_cuckoo_fused_threads(tile_n), 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
