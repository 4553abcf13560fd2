// Morton-window separation force for the protocol tick, for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// window_separation.py:separation_window_pallas.  The agent axis is already
// in (approximate) Morton order; each slot i is compared with the slots
// j = i - s for the shifts s = +1, -1, +2, -2, ..., +-W:
//
//   valid = 0 <= j < n, alive_i, alive_j
//   diff  = p_i - p_j;  dist = sqrt(diff_x^2 + diff_y^2);  dc = max(dist, eps)
//   near  = valid & dist < personal_space
//   f_i  += near ? (k_sep / (dc * dc)) * diff / dc : 0
//
// This is the rounding of the portable separation_window of the JAX package
// (ops/neighbors.py), which the JAX package runs everywhere but on a TPU and
// which the port's plain version (ops/neighbors.py) repeats op for op.  The
// TPU kernel computes the same function rounded as k / dc^3 * diff.  Every
// operation here is an IEEE intrinsic (__fsub_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), which the compiler never fuses into a
// multiply-add, and the shifts are summed in the plain version's order, so
// kernel and plain version decide every cut the same way and agree bit for
// bit.
//
// Bound on this card: bytes, barely.  The bytes are 17 per slot (position
// and alive flag read, force written), 18 MB at N = 1,048,576, 5.3 us.
// Each of the 2W partners of a slot costs a distance test (two
// differences, two products, a sum, a square root, the clamp and the cut)
// and a near pair eight more operations with three divisions, about 4 us
// at W = 16 and the f32 peak.  The IEEE division and square root are
// instruction sequences, not single operations, so the kernel sits well
// above the bound on issue.
//
// Design (first, simple version): one thread per receiver slot keeps its
// force in registers.  A block of kBlock receivers stages its tile of
// positions and alive flags plus the +-W halo in shared memory, loaded
// once with coalesced reads; slots outside [0, n) are staged as dead, so
// one alive test also covers the range test.  Where the halo does not fit
// the shared-memory budget (W in the thousands) the kernel reads each
// partner from global memory instead; any W >= 1 works, with no limit like
// the TPU kernel's 512-lane row.  Not done yet: several receivers per
// thread, and computing each pair once for both of its ends.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/window_separation.py).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
// Shared memory a block may take without opting in: 48 KB.
constexpr long long kStageBytes = 48 * 1024;

// The force one partner exerts on receiver (xi, yi), added to (fx, fy) in
// the plain version's rounding.
__device__ __forceinline__ void add_partner(float xi, float yi, float xj,
                                            float yj, bool alive_j,
                                            float k_sep, float r_cut,
                                            float eps, float& fx, float& fy) {
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float dc = fmaxf(dist, eps);
  if (alive_j && dist < r_cut) {
    const float mag = __fdiv_rn(k_sep, __fmul_rn(dc, dc));
    fx = __fadd_rn(fx, __fdiv_rn(__fmul_rn(mag, dx), dc));
    fy = __fadd_rn(fy, __fdiv_rn(__fmul_rn(mag, dy), dc));
  }
}

// Halo staged in shared memory: kBlock + 2W slots of x, y and alive.
__global__ void __launch_bounds__(kBlock)
window_staged_kernel(const float* __restrict__ pos,
                     const unsigned char* __restrict__ alive,
                     float* __restrict__ out, int n, int window, float k_sep,
                     float r_cut, float eps) {
  extern __shared__ float smem[];
  const int span = kBlock + 2 * window;
  float* s_x = smem;
  float* s_y = smem + span;
  unsigned char* s_alive = reinterpret_cast<unsigned char*>(smem + 2 * span);

  const int base = blockIdx.x * kBlock - window;  // slot of s_x[0]
  for (int k = threadIdx.x; k < span; k += kBlock) {
    const int j = base + k;
    const bool in = j >= 0 && j < n;
    s_x[k] = in ? pos[2 * j] : 0.0f;
    s_y[k] = in ? pos[2 * j + 1] : 0.0f;
    s_alive[k] = in ? alive[j] : 0;
  }
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const int t = threadIdx.x + window;  // receiver's staged slot
  float fx = 0.0f, fy = 0.0f;
  if (s_alive[t]) {
    const float xi = s_x[t], yi = s_y[t];
    for (int shift = 1; shift <= window; ++shift) {
      // s = +shift: partner i - shift; s = -shift: partner i + shift.
      add_partner(xi, yi, s_x[t - shift], s_y[t - shift],
                  s_alive[t - shift] != 0, k_sep, r_cut, eps, fx, fy);
      add_partner(xi, yi, s_x[t + shift], s_y[t + shift],
                  s_alive[t + shift] != 0, k_sep, r_cut, eps, fx, fy);
    }
  }
  out[2 * i] = fx;
  out[2 * i + 1] = fy;
}

// Partners read from global memory, for a halo too wide to stage.
__global__ void __launch_bounds__(kBlock)
window_global_kernel(const float* __restrict__ pos,
                     const unsigned char* __restrict__ alive,
                     float* __restrict__ out, int n, int window, float k_sep,
                     float r_cut, float eps) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float fx = 0.0f, fy = 0.0f;
  if (alive[i]) {
    const float xi = pos[2 * i], yi = pos[2 * i + 1];
    // Shifts of n or more have no partner in range; leaving them out adds
    // nothing (the sums start at +0 and never become -0).
    const int reach = min(window, n - 1);
    for (int shift = 1; shift <= reach; ++shift) {
      const int lo = i - shift, hi = i + shift;
      const bool lo_in = lo >= 0, hi_in = hi < n;
      add_partner(xi, yi, lo_in ? pos[2 * lo] : 0.0f,
                  lo_in ? pos[2 * lo + 1] : 0.0f, lo_in && alive[lo] != 0,
                  k_sep, r_cut, eps, fx, fy);
      add_partner(xi, yi, hi_in ? pos[2 * hi] : 0.0f,
                  hi_in ? pos[2 * hi + 1] : 0.0f, hi_in && alive[hi] != 0,
                  k_sep, r_cut, eps, fx, fy);
    }
  }
  out[2 * i] = fx;
  out[2 * i + 1] = fy;
}

// Bytes of shared memory the staged kernel needs for `window`, or 0 when
// the halo does not fit and the global-memory kernel runs instead.
long long stage_bytes(int window) {
  const long long span = kBlock + 2LL * window;
  const long long bytes = span * (2 * sizeof(float) + 1);
  return bytes <= kStageBytes ? bytes : 0;
}

}  // namespace

// pos [n, 2] f32 and alive [n] u8 (bool) in, out [n, 2] f32, all contiguous
// on `device`, sorted by Morton key; launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_window_separation_f32(const float* pos,
                                         const unsigned char* alive,
                                         float* out, int n, int window,
                                         float k_sep, float r_cut, float eps,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || window < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stage = stage_bytes(window);
  if (stage > 0) {
    window_staged_kernel<<<grid, kBlock, static_cast<size_t>(stage), s>>>(
        pos, alive, out, n, window, k_sep, r_cut, eps);
  } else {
    window_global_kernel<<<grid, kBlock, 0, s>>>(pos, alive, out, n, window,
                                                 k_sep, r_cut, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
