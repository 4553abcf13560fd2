// All-pairs firefly attraction for Hopper (sm_90a).
//
// dsa_firefly_attraction_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/firefly_fused.py:
//   firefly_attraction_pallas (body _make_kernel).
//
// What one launch computes, for rows x_i of pos_i [N, D] and sources x_j of
// pos_j [Nj, D] (the same swarm in the square case, another one in the
// rectangular case the sharded driver uses):
//
//   r2_ij  = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)     (the Gram identity)
//   W_ij   = beta0 exp_fast(-gamma r2_ij)  where f_j < f_i, else 0
//   move_i = sum_j W_ij x_j - (sum_j W_ij) x_i
//
// Arithmetic.  The dimensions split into groups of 32; each group's dot
// product (and squared norm) is a sequential sum of IEEE products from 0,
// and the groups combine as a pairwise tree ((g0 + g1) + (g2 + g3)).  The
// plain version (ops/cuda/firefly_fused.py) sums in the same order and
// evaluates exp_fast (fast_math.cuh) step for step, so W is the same bit for
// bit.  The sums over j differ: the kernel adds each tile of 64 sources into
// a partial and the partial into the total (a two-level sum, error at most
// (64 + Nj / 64) ulps of sum_j |W_ij x_j|), the plain version adds in float64
// and rounds once; the band of the comparison (firefly_fused.attraction_band)
// follows from that.  Equal fitness gives no attraction (the strict <), and
// a row with no brighter source gets a zero move.
//
// Bound on this card, at N = Nj = 65,536, D = 30 (chip_smoke.py: FF_OPS
// counts the operations from this source).  Bytes: the positions and fitness
// read once and the move written once, about 16 MB, 5 us.  Operations: the
// function needs every pair's brightness test, a brighter pair's dot product
// (2 D), distance and fast exponential (about 27), and a pair with W != 0
// its accumulation (2 D + 1): with about half the pairs brighter, some 1.9e11
// operations, 2.9 ms at 67 TFLOP/s.  Operations bound it.  This kernel also
// computes the dot product of every pair that is not brighter (its shuffles
// run outside the branch): a cost of the design, not of the function.
//
// Design (first, simple version).  One row is held by T = 1, 2 or 4 lanes of
// a warp (T = the groups of 32 dimensions, rounded up to a power of two), each
// keeping its group's coordinates, accumulator and tile partial in registers
// (32 floats each, no spills), so D <= 128.  A block of 128 threads streams
// the sources through shared memory in tiles of 64: their coordinates (each
// group padded to 36 floats, so the lanes of a row read different banks and
// reads can be 16 bytes), fitness and squared norms, which the block computes
// once per tile.  Every lane of the block reads the same source at once (a
// broadcast).  The lanes of a row combine their partial dot products by
// shuffles, which every lane of the warp executes, outside the data-dependent
// branch.  The products run on CUDA cores in full f32; no tensor cores, so no
// TF32.  Not done yet: several rows a thread to cut shared-memory reads,
// tensor-core products (3xTF32 or wgmma with a band), and skipping tiles that
// no row finds brighter.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/firefly_fused.py).

#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 32;        // dimensions a lane holds
constexpr int kGroupStride = 36;  // floats a staged group takes
constexpr int kTileJ = 64;        // sources a shared tile holds
constexpr int kMaxDim = 128;      // 4 groups

using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

// The pairwise tree over the T lanes of a row: lane g ends with
// ((p0 + p1) + (p2 + p3)) for T = 4 (addition commutes, so every lane of the
// row holds the same bits).  Every lane of the warp must call it.
template <int T>
__device__ __forceinline__ float group_tree(float v) {
#pragma unroll
  for (int s = 1; s < T; s <<= 1) {
    v = add(v, __shfl_xor_sync(0xffffffffu, v, s));
  }
  return v;
}

// |x|^2 of one staged source by one thread, in group_tree's order.
template <int T>
__device__ __forceinline__ float staged_sq(const float* x, int dim) {
  float p[T];
#pragma unroll
  for (int g = 0; g < T; ++g) {
    p[g] = 0.0f;
#pragma unroll
    for (int d = 0; d < kGroup; ++d) {
      if (g * kGroup + d < dim) {
        const float v = x[g * kGroupStride + d];
        p[g] = add(p[g], mul(v, v));
      }
    }
  }
#pragma unroll
  for (int s = 1; s < T; s <<= 1) {
#pragma unroll
    for (int g = 0; g < T; g += 2 * s) p[g] = add(p[g], p[g + s]);
  }
  return p[0];
}

template <int T>
__global__ void __launch_bounds__(kThreads)
firefly_kernel(const float* __restrict__ pos_i, const float* __restrict__ fit_i,
               const float* __restrict__ pos_j, const float* __restrict__ fit_j,
               float* __restrict__ out, int n, int nj, int dim, float beta0,
               float neg_gamma) {
  constexpr int kRows = kThreads / T;
  constexpr int kStride = T * kGroupStride;
  __shared__ __align__(16) float s_x[kTileJ * kStride];
  __shared__ float s_sq[kTileJ];
  __shared__ float s_f[kTileJ];

  const int g = threadIdx.x % T;
  const int i = blockIdx.x * kRows + threadIdx.x / T;
  const bool valid = i < n;
  const int d0 = g * kGroup;
  const float* row = pos_i + static_cast<size_t>(valid ? i : 0) * dim;

  float xi[kGroup], acc[kGroup];
  float sq = 0.0f;
#pragma unroll
  for (int d = 0; d < kGroup; ++d) {
    xi[d] = (valid && d0 + d < dim) ? row[d0 + d] : 0.0f;
    acc[d] = 0.0f;
    if (d0 + d < dim) sq = add(sq, mul(xi[d], xi[d]));
  }
  const float sqi = group_tree<T>(sq);
  const float fi = valid ? fit_i[i] : 0.0f;
  float wsum = 0.0f;

  for (int base = 0; base < nj; base += kTileJ) {
    const int m = min(kTileJ, nj - base);
    __syncthreads();  // the previous tile is no longer read
    const float* src = pos_j + static_cast<size_t>(base) * dim;
    for (int e = threadIdx.x; e < m * dim; e += kThreads) {
      const int jj = e / dim;
      const int d = e - jj * dim;
      s_x[jj * kStride + (d / kGroup) * kGroupStride + d % kGroup] = src[e];
    }
    if (threadIdx.x < m) s_f[threadIdx.x] = fit_j[base + threadIdx.x];
    __syncthreads();
    if (threadIdx.x < m) {
      s_sq[threadIdx.x] = staged_sq<T>(&s_x[threadIdx.x * kStride], dim);
    }
    __syncthreads();

    float part[kGroup];
#pragma unroll
    for (int d = 0; d < kGroup; ++d) part[d] = 0.0f;
    float wpart = 0.0f;
    for (int t = 0; t < m; ++t) {
      const float* xj = &s_x[t * kStride + g * kGroupStride];
      float c = 0.0f;
#pragma unroll
      for (int d = 0; d < kGroup; ++d) {
        if (d0 + d < dim) c = add(c, mul(xi[d], xj[d]));
      }
      c = group_tree<T>(c);
      if (valid && s_f[t] < fi) {
        const float r2 = fmaxf(sub(add(sqi, s_sq[t]), mul(2.0f, c)), 0.0f);
        const float w = mul(beta0, dsa::fast::exp_fast(mul(neg_gamma, r2)));
        if (w != 0.0f) {
          wpart = add(wpart, w);
#pragma unroll
          for (int d = 0; d < kGroup; ++d) {
            if (d0 + d < dim) part[d] = add(part[d], mul(w, xj[d]));
          }
        }
      }
    }
    wsum = add(wsum, wpart);
#pragma unroll
    for (int d = 0; d < kGroup; ++d) acc[d] = add(acc[d], part[d]);
  }

  if (valid) {
    float* o = out + static_cast<size_t>(i) * dim;
#pragma unroll
    for (int d = 0; d < kGroup; ++d) {
      if (d0 + d < dim) o[d0 + d] = sub(acc[d], mul(wsum, xi[d]));
    }
  }
}

template <int T>
cudaError_t launch(const float* pos_i, const float* fit_i, const float* pos_j,
                   const float* fit_j, float* out, int n, int nj, int dim,
                   float beta0, float neg_gamma, cudaStream_t s) {
  constexpr int kRows = kThreads / T;
  const dim3 grid((n + kRows - 1) / kRows);
  firefly_kernel<T><<<grid, kThreads, 0, s>>>(pos_i, fit_i, pos_j, fit_j, out,
                                              n, nj, dim, beta0, neg_gamma);
  return cudaGetLastError();
}

}  // namespace

// Lanes that hold one row at dimension `dim` (0 outside 1..128): the plain
// version's grouping, exported so that a test can hold the two together.
extern "C" int dsa_firefly_lanes(int dim) {
  if (dim < 1 || dim > kMaxDim) return 0;
  const int groups = (dim + kGroup - 1) / kGroup;
  return groups == 1 ? 1 : groups == 2 ? 2 : 4;
}

// pos_i [n, dim], fit_i [n], pos_j [nj, dim], fit_j [nj] f32 in, out
// [n, dim] f32, all contiguous on `device`; launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_firefly_attraction_f32(const float* pos_i,
                                          const float* fit_i,
                                          const float* pos_j,
                                          const float* fit_j, float* out,
                                          int n, int nj, int dim, float beta0,
                                          float neg_gamma, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || nj <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dsa_firefly_lanes(dim)) {
    case 1:
      err = launch<1>(pos_i, fit_i, pos_j, fit_j, out, n, nj, dim, beta0,
                      neg_gamma, s);
      break;
    case 2:
      err = launch<2>(pos_i, fit_i, pos_j, fit_j, out, n, nj, dim, beta0,
                      neg_gamma, s);
      break;
    case 4:
      err = launch<4>(pos_i, fit_i, pos_j, fit_j, out, n, nj, dim, beta0,
                      neg_gamma, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
