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
// Design (first, simple version).  One thread per individual: a block
// stages its individuals' pos and trial in dynamic shared memory as two
// [D][block] tiles, the thread index fastest (no bank conflicts, no
// barriers).  The donors are read from the input in global memory at every
// step, only where the gene crosses (consecutive lanes read consecutive
// addresses, but for one wrap).  Over a launch a block reads, of each donor
// tile, a window of block + 108 lanes at most (the schedule's widest span),
// so the donor reads after the first are served by the L2 cache; staging
// the three windows in shared memory is left to a later version.  The
// outputs are written out of place.  The block is 128 threads where the
// two tiles fit the 227 KB a block may take, else 64, else 32 (D <= 908).
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/de_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS): donor k
// at step s rolls by lshift_k + kLaneShift[s % 8][k].
__constant__ int kLaneShift[8][3] = {
    {1, 45, 89},  {3, 51, 101}, {7, 57, 113}, {11, 63, 5},
    {17, 71, 19}, {23, 77, 31}, {29, 83, 43}, {37, 95, 59},
};

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

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

__global__ void de_fused_kernel(const DeArgs a) {
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

// Threads per block: the largest of 128, 64, 32 whose two tiles fit, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (2ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_de_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: pos [D, N], fit [N], the draw r
// [D, N] (or null), pos_out [D, N], fit_out [N]; scalars [7] i32 (seed,
// three tile shifts, three lane shifts).  N is a multiple of tile_n.
// Launched on `stream` without synchronising.  Returns the CUDA error of
// the launch (0 when accepted).
extern "C" int dsa_de_fused_f32(
    const int* scalars, const float* pos, const float* fit, const float* r,
    float* pos_out, float* fit_out, int n, int dim, int tile_n, int k_steps,
    unsigned step0, int objective, float f, float cr, float half_width,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || block == 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      (r && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeArgs a{scalars, pos, fit, r, pos_out, fit_out, n, dim, tile_n,
                 k_steps, step0, objective, f, cr, half_width};
  const size_t shared = 2ull * dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(de_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  de_fused_kernel<<<blocks, block, shared,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
