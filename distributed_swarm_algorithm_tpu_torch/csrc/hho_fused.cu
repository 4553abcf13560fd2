// Fused Harris-hawks generations for Hopper (sm_90a): k generations in one
// pass, one thread per hawk.
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
// the branch's draws and update, the final clip and rastrigin, and on a
// dive the pair, the Levy power and two more evaluations.  Operations bound
// it.
//
// Design (first, simple version).  One thread per hawk: a block stages its
// hawks and the dive's two trial points in dynamic shared memory as three
// [D][block] tiles, the thread index fastest (no bank conflicts, no
// barriers); the rabbit, the mean and the random hawk are read from global
// memory.  A warp's lanes take different branches; the dive's evaluations
// run on the diving lanes only.  The block is 128 threads where the three
// tiles fit the 227 KB a block may take, else 64, else 32 (D <= 605).
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/hho_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr uint32_t kRowStream = 7;

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

__device__ __forceinline__ float clip(float v, float hw) {
  return dsa::fast::clip(v, -hw, hw);
}

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

__global__ void hho_fused_kernel(const HhoArgs a) {
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

// Threads per block: the largest of 128, 64, 32 whose three tiles fit, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (3ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_hho_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: best and mean [D], pos [D, N],
// fit [N], the draws rows [4, N], planes [5, D, N], normals [2, D, N] (all
// three or none), pos_out [D, N], fit_out [N]; scalars [4] i32 (seed, peer
// tile shift, the iteration before the launch, peer lane shift).  N is a
// multiple of tile_n.  Launched on `stream` without synchronising.  Returns
// the CUDA error of the launch (0 when accepted).
extern "C" int dsa_hho_fused_f32(
    const int* scalars, const float* best, const float* mean,
    const float* pos, const float* fit, const float* rows,
    const float* planes, const float* normals, float* pos_out,
    float* fit_out, int n, int dim, int tile_n, int k_steps, unsigned step0,
    int objective, float half_width, float inv_t_max, float sigma,
    float neg_inv_beta, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  const bool some = rows || planes || normals;
  const bool all = rows && planes && normals;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || block == 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      some != all || (all && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HhoArgs a{scalars, best, mean, pos, fit, rows, planes, normals,
                  pos_out, fit_out, n, dim, tile_n, k_steps, step0,
                  objective, half_width, inv_t_max, sigma, neg_inv_beta};
  const size_t shared = 3ull * dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(hho_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  hho_fused_kernel<<<blocks, block, shared,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
