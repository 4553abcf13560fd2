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
// step, 0), c3 the same on stream 1.  With c2/c3 given as operands ([D],
// one step only) the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// exp_fast is the JAX package's bit-field 2^n times a degree-5 Horner
// polynomial (ops/cuda/salp_fused.py: exp2_fast), so kernel and plain
// version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, 16 steps, rastrigin.
// Bytes: pos read and written once, fit read and written: 4 (2 D + 2) N
// bytes, 0.26 GB, 0.08 ms at 3.35 TB/s.  Operations per element and step:
// the follower (an add, a product, the clip: 4), rastrigin (23) and the
// running best's select (1): 28, and 3 per salp and step; 1.4e10 a launch,
// 0.21 ms at 67 TFLOP/s: operations bound it.  Measured at that shape on an
// NVIDIA H100 80GB HBM3 at 700 W: 1.55 ms a launch, 7.3 times the bound:
// the objective's serial chain, with nothing else to hide its latency, a
// barrier a step and warp 0's halo columns keep it there (PERF.md).
//
// Design (first, simple version).  The chain runs across lanes, so after k
// steps lane i depends on lanes i-k .. i of its tile at the launch's start.
// A block of B threads owns B consecutive lanes of one tile (B divides
// tile_n, a multiple of 128) and stages them with a left halo of 16 lanes
// in shared memory, [D][B + 16], recomputing the halo each step: a halo
// column's value goes stale one column per step from the left, which never
// reaches an owned lane within 16 steps.  The tile's lane 0 reads the link
// from the input in global memory (outputs are written out of place).  Two
// such buffers alternate (read one, write the other, one barrier per step);
// a third, [D][B], holds each owned lane's best position.  Threads 0..15
// also compute the halo columns.  The block is 128 threads where
// (2 (B + 16) + B) D floats fit 226 KB, else 64, else 32 (D <= 452).  Each
// block reduces its lanes' bests to one candidate; the wrapper takes the
// first least candidate.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/salp_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

// Dynamic shared memory one block may take on sm_90 (232,448 bytes), less
// 1 KB for the candidate reduction's static arrays.
constexpr size_t kMaxSharedBytes = 226 * 1024;
constexpr int kHalo = 16;  // the most steps one launch may take

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

using dsa::fast::exp_fast;

__device__ __forceinline__ bool better(float fit, long long lane,
                                       float other_fit, long long other) {
  return fit < other_fit || (fit == other_fit && lane < other);
}

__global__ void salp_fused_kernel(const SalpArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int width = block + kHalo;
  float* cur = smem;
  float* nxt = cur + static_cast<size_t>(dim) * width;
  float* s_best = nxt + static_cast<size_t>(dim) * width;
  const size_t n = static_cast<size_t>(a.n);
  const long long first = static_cast<long long>(blockIdx.x) * block;
  const long long tile = first / a.tile_n;
  const int j0 = static_cast<int>(first - tile * a.tile_n);
  const long long n_tiles = a.n / a.tile_n;
  const size_t tile_base = static_cast<size_t>(tile) * a.tile_n;
  // The chain link: the previous tile's last lane (cyclically).
  const size_t link = static_cast<size_t>((tile + n_tiles - 1) % n_tiles) *
                          a.tile_n + a.tile_n - 1;
  const bool leader_block = first == 0;

  for (int c = t; c < width; c += block) {
    const int j = j0 - kHalo + c;   // lane within the tile
    if (j < 0) continue;            // before the tile: never read
    for (int d = 0; d < dim; ++d) {
      cur[d * width + c] = a.pos[d * n + tile_base + j];
    }
  }
  const int own = kHalo + t;
  const long long lane = first + t;
  float fit = a.fit[lane];
  float best_fit = fit;
  __syncthreads();
  for (int d = 0; d < dim; ++d) s_best[d * block + t] = cur[d * width + own];

  const bool host_rng = a.r2 != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const int it0 = a.scalars[1];

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    for (int c = t; c < width; c += block) {
      const int j = j0 - kHalo + c;
      if (j < 0) continue;
      if (leader_block && j == 0) {
        // Global lane 0 is the leader: it replaces its position.
        const float tt = static_cast<float>(it0 + step + 1);
        const float z = div(mul(4.0f, tt), a.t_max);
        const float c1 = mul(2.0f, exp_fast(mul(-1.0f, mul(z, z))));
        for (int d0 = 0; d0 < dim; d0 += 4) {
          float u2[4], u3[4];
          if (host_rng) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              u2[q] = d0 + q < dim ? a.r2[d0 + q] : 0.0f;
              u3[q] = d0 + q < dim ? a.r3[d0 + q] : 0.0f;
            }
          } else {
            const uint32_t g = static_cast<uint32_t>(d0 >> 2);
            const dsa::Philox4 p2 = dsa::philox4x32_10(0u, g, ctr, 0u, seed, 0u);
            const dsa::Philox4 p3 = dsa::philox4x32_10(0u, g, ctr, 1u, seed, 0u);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              u2[q] = dsa::uniform_from_bits(p2.v[q]);
              u3[q] = dsa::uniform_from_bits(p3.v[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int d = d0 + q;
            if (d < dim) {
              const float sign = u3[q] >= 0.5f ? 1.0f : -1.0f;
              const float v = add(a.food[d], mul(mul(sign, c1),
                                                 add(mul(a.span, u2[q]), a.lb)));
              nxt[d * width + c] = clip(v, a.half_width);
            }
          }
        }
      } else {
        for (int d = 0; d < dim; ++d) {
          const float x = cur[d * width + c];
          const float prev = j == 0 ? a.pos[d * n + link]
                                    : cur[d * width + (c > 0 ? c - 1 : c)];
          nxt[d * width + c] = clip(mul(0.5f, add(x, prev)), a.half_width);
        }
      }
    }
    __syncthreads();
    fit = dsa::evaluate_objective(a.objective, Column{nxt + own, width}, dim);
    if (fit < best_fit) {
      best_fit = fit;
      for (int d = 0; d < dim; ++d) s_best[d * block + t] = nxt[d * width + own];
    }
    float* swap = cur;
    cur = nxt;
    nxt = swap;
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = cur[d * width + own];
  a.fit_out[lane] = fit;

  // The block's candidate: the least running best, the lowest lane among
  // equals, and its position.
  __shared__ float w_fit[32];
  __shared__ long long w_lane[32];
  float bf = best_fit;
  long long bl = lane;
  for (int off = 16; off > 0; off >>= 1) {
    const float of = __shfl_down_sync(0xffffffffu, bf, off);
    const long long ol = __shfl_down_sync(0xffffffffu, bl, off);
    if (better(of, ol, bf, bl)) {
      bf = of;
      bl = ol;
    }
  }
  if ((t & 31) == 0) {
    w_fit[t >> 5] = bf;
    w_lane[t >> 5] = bl;
  }
  __syncthreads();
  if (t == 0) {
    for (int wi = 1; wi < (block >> 5); ++wi) {
      if (better(w_fit[wi], w_lane[wi], bf, bl)) {
        bf = w_fit[wi];
        bl = w_lane[wi];
      }
    }
    const int owner = static_cast<int>(bl - first);
    a.block_fit[blockIdx.x] = bf;
    for (int d = 0; d < dim; ++d) {
      a.block_pos[static_cast<size_t>(d) * gridDim.x + blockIdx.x] =
          s_best[d * block + owner];
    }
  }
}

size_t shared_bytes(int dim, int block) {
  return (2ull * (block + kHalo) + block) * dim * sizeof(float);
}

// Threads per block: the largest of 128, 64, 32 whose buffers fit, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (shared_bytes(dim, block) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope), so
// that the wrapper sizes the candidate arrays.
extern "C" int dsa_salp_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: food [D], pos [D, N], fit [N],
// r2/r3 [D] (both or neither), pos_out [D, N], fit_out [N], block_fit
// [N / block], block_pos [D, N / block]; scalars [2] i32 (seed,
// block-start iteration).  N is a multiple of tile_n, and tile_n of 128.
// Launched on `stream` without synchronising.  Returns the CUDA error of
// the launch (0 when accepted).
extern "C" int dsa_salp_fused_f32(
    const int* scalars, const float* food, const float* pos, const float* fit,
    const float* r2, const float* r3, float* pos_out, float* fit_out,
    float* block_fit, float* block_pos, int n, int dim, int tile_n,
    int k_steps, unsigned step0, int objective, float t_max, float span,
    float lb, float half_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || k_steps > kHalo || block == 0 ||
      tile_n <= 0 || tile_n % 128 != 0 || n % tile_n != 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || (r2 == nullptr) != (r3 == nullptr) ||
      (r2 != nullptr && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SalpArgs a{scalars, food, pos, fit, r2, r3, pos_out, fit_out,
                   block_fit, block_pos, n, dim, tile_n, k_steps, step0,
                   objective, t_max, span, lb, half_width};
  const size_t shared = shared_bytes(dim, block);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(salp_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(n / block);
  salp_fused_kernel<<<blocks, block, shared,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
