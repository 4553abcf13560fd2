// Exact all-pairs separation force for the protocol tick, for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// separation.py:separation_pallas and computes the same function:
//
//   near(i,j) = alive_i & alive_j & i != j & d2(i,j) < personal_space^2
//   f_i       = sum_j near * k_sep * (p_i - p_j) * rsqrt(max(d2, eps^2))^3
//
// Bound on this card: operations.  Every pair needs its squared distance
// and the cut (3D operations) and a near pair the force (one rsqrt and
// 2D + 4 more); the bytes are N * (2 * 4D + 1), about 1 MB at N = 65,536,
// so memory is never the limit.  On the tick's main path (65,536 agents
// over +-1,000 m) only about 13,000 of 4.3e9 ordered pairs are near.
//
// Design: pay the cut on every pair and the force only where a pair is near.
// The force costs about 25 instructions a pair, an rsqrt among them, against 3D
// for the cut, and almost no pair is near.  A block of kThreads threads holds
// kRecv receivers a thread and walks all senders in tiles of kTile staged in
// shared memory as packed positions (D = 2: one 16-byte load brings two
// senders, so it serves 2 kRecv pairs; D = 3: one sender padded to 16 bytes).
// Dead senders and the ragged tail are staged at +inf and a dead receiver (or a
// slot past n) holds NaN, so the cut d2 < r2 excludes them and no alive flag is
// read in the inner loop.  The fast path computes each pair's d2 as the plain
// version does (each product and sum rounded, in axis order) and ORs the cut
// into a flag: 3D operations a pair.  After each group of kGroup senders the
// warp votes once (__any_sync).  Only a warp with a near pair in the group, or
// one that holds its own receiver (i = j gives d2 = 0, excluded there),
// recomputes the group's pairs with the force, each receiver over its senders
// in ascending order.  So every receiver sums its terms in sender order and the
// result does not change from run to run.  Where the swarm is crowded every
// warp takes the branch on every group and pays the fast path on top of the
// force.  kThreads = 128, kRecv = 2 and kGroup = 32 (16 at D = 3, where 32
// spills) were the fastest of the shapes timed at N = 65,536 (1 to 4 receivers,
// groups of 4 to 64 senders, blocks of 32 to 256 threads); the vote's cost
// falls with the group, and the grid is 256 blocks there.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/separation.py).
// No --use_fast_math: the products, sums and multiply-adds are IEEE
// intrinsics; the force's rsqrtf differs from the plain version's by a few
// ulps, which its band covers.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRecv = 2;
constexpr int kTile = 512;   // senders staged a tile
// Senders a vote: at D = 3 a group of 32 spills registers.
template <int D>
constexpr int kGroup = D == 2 ? 32 : 16;

// Floats a staged sender takes: D = 2 packs two senders in 16 bytes.
template <int D>
struct Stage {
  static constexpr int kStride = D == 2 ? 2 : 4;
};

// The group's senders from the tile, with 16-byte loads.
template <int D>
__device__ __forceinline__ void load_group(const float* tile, int g0,
                                           float (&q)[kGroup<D>][D]) {
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  if constexpr (D == 2) {
#pragma unroll
    for (int h = 0; h < kGroup<D> / 2; ++h) {
      const float4 v = t4[g0 / 2 + h];
      q[2 * h][0] = v.x;
      q[2 * h][1] = v.y;
      q[2 * h + 1][0] = v.z;
      q[2 * h + 1][1] = v.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < kGroup<D>; ++g) {
      const float4 v = t4[g0 + g];
      q[g][0] = v.x;
      q[g][1] = v.y;
      q[g][2] = v.z;
    }
  }
}

// d2 rounds each product and sum (no fused multiply-add), in axis order,
// as the plain version does: the cut d2 < r2_cut then falls the same way
// in both for every pair.
template <int D>
__device__ __forceinline__ float dist2(const float (&p)[D], const float (&q)[D],
                                       float (&diff)[D]) {
  diff[0] = __fsub_rn(p[0], q[0]);
  float d2 = __fmul_rn(diff[0], diff[0]);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    diff[d] = __fsub_rn(p[d], q[d]);
    d2 = __fadd_rn(d2, __fmul_rn(diff[d], diff[d]));
  }
  return d2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
separation_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ alive,
                  float* __restrict__ out,
                  int n, float k_sep, float r2_cut, float eps2) {
  constexpr int kStride = Stage<D>::kStride;
  __shared__ __align__(16) float s_tile[kTile * kStride];

  const int i0 = blockIdx.x * (kThreads * kRecv) + threadIdx.x;
  float p[kRecv][D];
  float acc[kRecv][D];
#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
    const int i = i0 + r * kThreads;
    const bool live = i < n && alive[i] != 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      p[r][d] = live ? pos[static_cast<size_t>(i) * D + d] : NAN;
      acc[r][d] = 0.0f;
    }
  }

  for (int base = 0; base < n; base += kTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int s = threadIdx.x; s < kTile; s += kThreads) {
      const int j = base + s;
      const bool live = j < n && alive[j] != 0;
#pragma unroll
      for (int d = 0; d < kStride; ++d) {
        s_tile[s * kStride + d] =
            d >= D ? 0.0f
                   : live ? pos[static_cast<size_t>(j) * D + d] : INFINITY;
      }
    }
    __syncthreads();
    const int m = min(kTile, n - base);
    for (int g0 = 0; g0 < m; g0 += kGroup<D>) {
      float q[kGroup<D>][D];
      load_group<D>(s_tile, g0, q);
      bool hit = false;
#pragma unroll
      for (int g = 0; g < kGroup<D>; ++g) {
#pragma unroll
        for (int r = 0; r < kRecv; ++r) {
          float diff[D];
          hit |= dist2<D>(p[r], q[g], diff) < r2_cut;
        }
      }
      if (!__any_sync(0xffffffffu, hit)) continue;
      // The rare branch: the group again, with the force, per receiver in
      // sender order.
#pragma unroll
      for (int r = 0; r < kRecv; ++r) {
        const int i = i0 + r * kThreads;
#pragma unroll
        for (int g = 0; g < kGroup<D>; ++g) {
          float diff[D];
          const float d2 = dist2<D>(p[r], q[g], diff);
          const bool near = d2 < r2_cut && base + g0 + g != i;
          const float inv = rsqrtf(fmaxf(d2, eps2));
          const float mag = __fmul_rn(__fmul_rn(__fmul_rn(k_sep, inv), inv),
                                      inv);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            acc[r][d] = near ? __fmaf_rn(mag, diff[d], acc[r][d]) : acc[r][d];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRecv; ++r) {
    const int i = i0 + r * kThreads;
    if (i < n) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        out[static_cast<size_t>(i) * D + d] = acc[r][d];
      }
    }
  }
}

}  // namespace

// pos [n, dim] f32 and alive [n] u8 (bool) in, out [n, dim] f32, all
// contiguous on `device`; launched on `stream` without synchronising.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int dsa_separation_f32(const float* pos, const unsigned char* alive,
                                  float* out, int n, int dim, float k_sep,
                                  float r2_cut, float eps2, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads * kRecv - 1) / (kThreads * kRecv));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 2:
      separation_kernel<2><<<grid, kThreads, 0, s>>>(pos, alive, out, n,
                                                     k_sep, r2_cut, eps2);
      break;
    case 3:
      separation_kernel<3><<<grid, kThreads, 0, s>>>(pos, alive, out, n,
                                                     k_sep, r2_cut, eps2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
