// Exact all-pairs separation force for the protocol tick, for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// separation.py:separation_pallas and computes the same function:
//
//   near(i,j) = alive_i & alive_j & i != j & d2(i,j) < personal_space^2
//   f_i       = sum_j near * k_sep * (p_i - p_j) * rsqrt(max(d2, eps^2))^3
//
// Bound on this card: operations.  Every pair needs its squared distance
// (3D - 1 f32 operations and a compare) and a near pair the force (one
// rsqrt and 2D + 4 more); the bytes are N * (2 * 4D + 1), about 1 MB at
// N = 65,536, so memory is never the limit.
//
// Design (first, simple version): one thread per receiver i keeps its
// force in registers; a block of kBlock receivers walks all senders j in
// tiles of kBlock positions and alive flags staged in shared memory, where
// every thread of the block reads the same sender at once (a broadcast,
// free of bank conflicts).  The ragged last tile is masked by j < n, so no
// padding with dead agents is needed.  Sums run in sender order, so a
// result does not change from run to run.  Not done yet: splitting the
// sender range across blocks to fill the card at small N, and skipping
// tiles that lie beyond the personal space.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/separation.py).
// No --use_fast_math: rsqrtf and the divisions stay IEEE-conformant.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

template <int D>
__global__ void __launch_bounds__(kBlock)
separation_kernel(const float* __restrict__ pos,
                  const unsigned char* __restrict__ alive,
                  float* __restrict__ out,
                  int n, float k_sep, float r2_cut, float eps2) {
  __shared__ float s_pos[D][kBlock];
  __shared__ unsigned char s_alive[kBlock];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  float p_i[D];
  float acc[D];
  bool alive_i = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p_i[d] = 0.0f;
    acc[d] = 0.0f;
  }
  if (i < n) {
    alive_i = alive[i] != 0;
#pragma unroll
    for (int d = 0; d < D; ++d) p_i[d] = pos[i * D + d];
  }

  for (int base = 0; base < n; base += kBlock) {
    const int j = base + threadIdx.x;
    __syncthreads();  // the previous tile is no longer read
    if (j < n) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_pos[d][threadIdx.x] = pos[j * D + d];
      s_alive[threadIdx.x] = alive[j];
    } else {
      s_alive[threadIdx.x] = 0;
    }
    __syncthreads();
    if (!alive_i) continue;  // a dead receiver feels nothing
    const int m = min(kBlock, n - base);
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      // d2 rounds each product and sum (no fused multiply-add), in axis
      // order, as the plain version does: the cut d2 < r2_cut then falls
      // the same way in both for every pair.
      float diff[D];
      float d2 = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        diff[d] = p_i[d] - s_pos[d][t];
        d2 = __fadd_rn(d2, __fmul_rn(diff[d], diff[d]));
      }
      const bool near = s_alive[t] != 0 && (base + t) != i && d2 < r2_cut;
      const float inv = rsqrtf(fmaxf(d2, eps2));
      const float mag = near ? k_sep * inv * inv * inv : 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += mag * diff[d];
    }
  }

  if (i < n) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[i * D + d] = acc[d];
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
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 2:
      separation_kernel<2><<<grid, kBlock, 0, s>>>(pos, alive, out, n, k_sep,
                                                   r2_cut, eps2);
      break;
    case 3:
      separation_kernel<3><<<grid, kBlock, 0, s>>>(pos, alive, out, n, k_sep,
                                                   r2_cut, eps2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
