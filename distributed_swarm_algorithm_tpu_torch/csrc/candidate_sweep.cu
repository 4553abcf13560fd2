// Plan-native candidate sweep for the hashgrid protocol tick, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// candidate_sweep.py:candidate_sweep_pallas.  The operands are the plan's
// own tables: cand [C, W] (per cell, every live agent of its 3x3 stencil
// neighbourhood, padded with n) and recv [C, RK] (per cell, its own live
// agents, padded with n).  For each cell c and receiver a = recv[c, r] < n:
//
//   f_a = sum_w near * k / max(d, eps)^3 * (p_a - p_b),  b = cand[c, w]
//   near = b < n, b != a, d < ps,  d = sqrt(dx^2 + dy^2)
//
// with the select-form minimum image, at the current positions (a stale
// Verlet plan stays exact), written straight to the receiver's row of the
// output: an agent sits in at most one receiver slot, so no atomics.
//
// Design (first, simple version): one warp per cell, four cells a block.
// The warp reads its receiver row first and skips the cell when it has
// none (most cells of a sparse swarm).  Else it stages the row's valid
// candidates (index and position) in shared memory, compacted with a
// ballot so the padding (at W = 128 from a cap of 48, most columns hold n)
// is never swept, in row order; then each lane takes receivers r = lane,
// lane + 32, ... and sums its candidates in that order.  Shared memory: 12
// bytes a candidate, 4 * W * 12 bytes a block (6 KB at W = 128), so W up to
// 1,024 within the 48 KB a block takes without opting in.  Registers: one
// receiver's position and force and the loop state.
//
// Rounding: every operation is an IEEE intrinsic in the plain version's
// order (ops/cuda/candidate_sweep.py: the union sweep of ops/neighbors.py
// with its terms summed column after column): d^2 = fma(dy, dy, dx * dx)
// as XLA rounds jnp.linalg.norm and the plain version emulates, then the
// correctly rounded square root, k / ((dc * dc) * dc), the product by the
// displacement and the sum in row order; skipped columns add +0, which
// changes no sum that starts at +0.  So kernel and plain version agree bit
// for bit.
//
// Bound on this card: bytes.  The function reads the tables once (cand
// 10.9 MB, recv 4.1 MB at g = 146, W = 128, RK = 48), the positions, and
// writes the force: 16 MB, 5 us.  Its operations are a distance test per
// (receiver, candidate) pair (two differences, two wraps, a product, a
// multiply-add, the square root, the cut) and about eight more with a
// division per near pair, under 0.3 us at a station swarm's density, where
// most table entries are padding.  Not done yet: reading only the valid
// prefix of each row, several cells per warp where rows are short.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/candidate_sweep.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // cells per block
constexpr int kBlock = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float wrap(float v, float hw, float two_hw) {
  return v >= hw ? __fsub_rn(v, two_hw) : (v < -hw ? __fadd_rn(v, two_hw) : v);
}

__global__ void __launch_bounds__(kBlock)
candidate_sweep_kernel(const float* __restrict__ pos,
                       const int* __restrict__ cand,
                       const int* __restrict__ recv, float* __restrict__ out,
                       int n, int cells, int W, int RK, float k_sep, float ps,
                       float eps, float hw) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= cells) return;  // whole warps leave; no block barrier follows

  // Occupancy skip: a cell with no receivers sweeps nothing.
  bool any = false;
  for (int r = lane; r < RK && !any; r += 32) {
    const int a = recv[(long long)c * RK + r];
    any = a >= 0 && a < n;
  }
  if (!__any_sync(kFull, any)) return;

  int* s_idx = reinterpret_cast<int*>(smem) + warp * W;
  float* s_x = reinterpret_cast<float*>(smem) + kWarps * W + warp * W;
  float* s_y = reinterpret_cast<float*>(smem) + 2 * kWarps * W + warp * W;
  const float two_hw = 2.0f * hw;

  // Stage the valid candidates, compacted, in row order.
  int total = 0;
  for (int base = 0; base < W; base += 32) {
    const int w = base + lane;
    const int b = w < W ? cand[(long long)c * W + w] : n;
    const bool valid = b >= 0 && b < n;
    const unsigned mask = __ballot_sync(kFull, valid);
    if (valid) {
      const int at = total + __popc(mask & ((1u << lane) - 1u));
      s_idx[at] = b;
      s_x[at] = pos[2 * b];
      s_y[at] = pos[2 * b + 1];
    }
    total += __popc(mask);
  }
  __syncwarp();

  for (int r = lane; r < RK; r += 32) {
    const int a = recv[(long long)c * RK + r];
    if (a < 0 || a >= n) continue;
    const float ax = pos[2 * a], ay = pos[2 * a + 1];
    float fx = 0.0f, fy = 0.0f;
    for (int q = 0; q < total; ++q) {
      if (s_idx[q] == a) continue;
      const float dx = wrap(__fsub_rn(ax, s_x[q]), hw, two_hw);
      const float dy = wrap(__fsub_rn(ay, s_y[q]), hw, two_hw);
      const float d = __fsqrt_rn(__fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
      if (!(d < ps)) continue;
      const float dc = fmaxf(d, eps);
      const float scale = __fdiv_rn(k_sep, __fmul_rn(__fmul_rn(dc, dc), dc));
      fx = __fadd_rn(fx, __fmul_rn(scale, dx));
      fy = __fadd_rn(fy, __fmul_rn(scale, dy));
    }
    out[2 * a] = fx;
    out[2 * a + 1] = fy;
  }
}

}  // namespace

// pos [n, 2] f32, cand [cells, W] and recv [cells, RK] i32 (padded with n),
// out [n, 2] f32 zeroed by the caller, all contiguous on `device`; launched
// on `stream` without synchronising.  Returns the CUDA error of the launch
// (0 when accepted).
extern "C" int dsa_candidate_sweep_f32(const float* pos, const int* cand,
                                       const int* recv, float* out, int n,
                                       int cells, int W, int RK, float k_sep,
                                       float ps, float eps, float hw,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kWarps) * W * 12;
  if (n <= 0 || cells <= 0 || W < 1 || RK < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cells + kWarps - 1) / kWarps);
  candidate_sweep_kernel<<<grid, kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      pos, cand, recv, out, n, cells, W, RK, k_sep, ps, eps, hw);
  return static_cast<int>(cudaGetLastError());
}
