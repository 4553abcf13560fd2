// Hashgrid slot-plane separation sweep for the protocol tick, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// grid_separation.py:separation_hashgrid_pallas (both of its pallas_call
// sites: the whole-row kernel and the lane-tiled one, a TPU VMEM
// workaround).  Planes x[g*g*K], y[g*g*K] hold the cell-sorted in-grid
// agents, slot = cell * K + rank, cell = cx * g + cy; empty, dead and
// capped-out slots hold the 1e18 sentinel.  For each in-grid slot i:
//
//   f_i = sum_j near * k * rsqrt(max(d2, eps^2))^3 * (p_i - p_j)
//   near = d2 < ps^2,  j != i over the K slots of each of the (2R+1)^2
//   stencil cells (cx + dr, cy + dc) mod g, |dr|, |dc| <= R
//
// with the select-form minimum image on both axes (exact for true
// displacements, inert on the sentinel, whose pairs fail the cut).
//
// The TPU kernel computes each pair once and applies the reaction with lane
// and row rolls, which saves TPU shifts.  Here each receiver gathers its
// stencil and every pair is computed from both ends: no atomics and no
// reaction planes.  One thread per in-grid agent, in the plan's sort order,
// so a warp's receivers sit in the same or neighbouring cells and read the
// same stencil slots (broadcast loads through L1; the planes, 4 MB each at
// g = 256, K = 16, stay in the 50 MB L2).  Agents outside the grid skip; the
// force planes are zeroed by the wrapper.
//
// Rounding: d2 = fma(dx, dx, dy * dy), as XLA rounds the TPU kernel's
// dx*dx + dy*dy and as the plain version (ops/cuda/grid_separation.py)
// computes it, and rsqrtf, the function torch.rsqrt computes on the card;
// the products k*inv*inv*inv and scale*d in the plain version's order.  The
// terms are summed in stencil order, the plain version's sum in another, so
// the two agree within a few ulps of sum_j |term_ij|.
//
// Bound on this card: bytes.  The function reads the two position planes
// and writes the two force planes (16 MB at g = 256, K = 16) and reads the
// slot index: 5 us.  Its operations are a distance test per pair of
// in-grid agents in a stencil (two differences, two wraps, a product and a
// multiply-add, the cut) and about eight more per near pair (clamp, rsqrt,
// three products, two multiply-adds), under 0.1 us at a station swarm's
// density.  What limits the kernel is instruction throughput: each agent
// walks all (2R+1)^2 * K = 144 stencil slots at R = 1, K = 16, mostly
// sentinels in a sparse swarm.  Registers: a receiver's position and force
// and the loop state; no shared memory.  Not done yet: skipping empty
// stencil cells with the occupancy counts, computing each pair once.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/grid_separation.py).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float wrap(float v, float hw, float two_hw) {
  return v >= hw ? __fsub_rn(v, two_hw) : (v < -hw ? __fadd_rn(v, two_hw) : v);
}

__global__ void __launch_bounds__(kBlock)
grid_sweep_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const int* __restrict__ slot, float* __restrict__ fx,
                  float* __restrict__ fy, int n, int g, int K, int R,
                  float k_sep, float ps2, float eps2, float hw) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= n) return;
  const int s = slot[t];
  const int n_slots = g * g * K;
  if (s < 0 || s >= n_slots) return;  // dead or capped out: not in the grid
  const int cell = s / K;
  const int cx = cell / g;
  const int cy = cell - cx * g;
  const float two_hw = 2.0f * hw;
  const float xi = x[s], yi = y[s];
  float ax = 0.0f, ay = 0.0f;
  for (int dr = -R; dr <= R; ++dr) {
    const int row = (cx + dr + g) % g;
    for (int dc = -R; dc <= R; ++dc) {
      const int base = (row * g + (cy + dc + g) % g) * K;
      for (int q = 0; q < K; ++q) {
        const int j = base + q;
        if (j == s) continue;
        const float dx = wrap(__fsub_rn(xi, __ldg(x + j)), hw, two_hw);
        const float dy = wrap(__fsub_rn(yi, __ldg(y + j)), hw, two_hw);
        const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
        if (d2 < ps2) {
          const float inv = rsqrtf(fmaxf(d2, eps2));
          const float scale = __fmul_rn(__fmul_rn(__fmul_rn(k_sep, inv), inv),
                                        inv);
          ax = __fadd_rn(ax, __fmul_rn(scale, dx));
          ay = __fadd_rn(ay, __fmul_rn(scale, dy));
        }
      }
    }
  }
  fx[s] = ax;
  fy[s] = ay;
}

}  // namespace

// x, y, fx, fy [g*g*K] f32 and slot [n] i32 (an agent's slot, or g*g*K when
// it is not in the grid), all contiguous on `device`; fx, fy zeroed by the
// caller.  Launched on `stream` without synchronising.  Returns the CUDA
// error of the launch (0 when accepted).
extern "C" int dsa_grid_sweep_f32(const float* x, const float* y,
                                  const int* slot, float* fx, float* fy,
                                  int n, int g, int K, int R, float k_sep,
                                  float ps2, float eps2, float hw, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || g < 2 * R + 1 || K < 1 || R < 1 || R > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  grid_sweep_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, slot, fx, fy, n, g, K, R, k_sep, ps2, eps2, hw);
  return static_cast<int>(cudaGetLastError());
}
