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
// multiply-add, and each receiver sums its terms in the plain version's
// shift order, so kernel and plain version agree bit for bit.
//
// Bound on this card: bytes.  The bytes are 17 per slot (position and
// alive flag read, force written), 18 MB at N = 1,048,576, 5.3 us.  The
// function needs a distance test for each of the 2W partners of a slot
// (two differences, two products, a sum and the cut: 6 operations) and,
// for a near pair only, the square root, the clamp and the force (10), 2.2
// us at W = 16 and the f32 peak on the main path's 5% of near pairs.
//
// Design (rule 2's redesign of the staged kernel).  The first version ran
// an IEEE square root (an instruction sequence) for every partner and the
// near branch, with its three divisions, in almost every warp at almost
// every shift (a warp of 32 receivers holds a near lane at a given shift
// with probability ~0.8 where 5% of the pairs are near).  Now:
//   - the cut needs no square root.  __fsqrt_rn is monotone, so sqrt_rn(s)
//     < r_cut exactly when s < t, t the least float whose correctly rounded
//     square root is >= r_cut; the wrapper finds t by a search over the
//     float32 bit patterns (ops/cuda/window_separation.py: cut_threshold)
//     and passes it in.  NaN and Inf fail both forms alike;
//   - a slot that is dead or outside [0, n) is staged with a NaN position,
//     so one comparison is the whole test: a NaN fails s < t as the alive
//     and range tests would;
//   - each lane first builds the 32-bit mask of its near shifts in the
//     plain order (+1, -1, +2, -2, ... for 16 shifts a group of 32 tests);
//     the warp then lays its (receiver, shift) near pairs out in a queue in
//     shared memory, lane by lane and shift by shift (offsets by a warp
//     prefix sum of the masks' popcounts), and works it off in rounds of
//     32: lane k computes entry 32 r + k with the same intrinsics, and each
//     receiver adds the entries that are its own, in queue order, which is
//     its shift order.  A warp with 53 near pairs runs two rounds of
//     divisions where the first version ran ~26 shifts of them;
//   - where the rounds would not be fewer than the most near pairs one lane
//     holds (a crowded warp: up to 32 a lane), each lane adds its own near
//     pairs in shift order instead; the choice is the warp's, and both give
//     the same bits.
// No size is capped: a group's queue holds up to 32 x 32 entries.  Where
// the halo does not fit the shared-memory budget (W in the thousands) the
// first version's kernel reads each partner from global memory instead;
// any W >= 1 works, with no limit like the TPU kernel's 512-lane row.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/window_separation.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// Near pairs a group of 32 tests can give a warp: its queue's length.
constexpr int kQueue = 32 * 32;
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

// The squared distance of the plain version and the differences it rounds
// from.
__device__ __forceinline__ float sq_dist(float2 me, float2 p, float& dx,
                                         float& dy) {
  dx = __fsub_rn(me.x, p.x);
  dy = __fsub_rn(me.y, p.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The term of a near pair: (k / dc^2) * diff / dc, dc = max(sqrt(s), eps).
__device__ __forceinline__ float2 near_term(float2 me, float2 p, float k_sep,
                                            float eps) {
  float dx, dy;
  const float s = sq_dist(me, p, dx, dy);
  const float dc = fmaxf(__fsqrt_rn(s), eps);
  const float mag = __fdiv_rn(k_sep, __fmul_rn(dc, dc));
  return make_float2(__fdiv_rn(__fmul_rn(mag, dx), dc),
                     __fdiv_rn(__fmul_rn(mag, dy), dc));
}

// Staged slot of the partner that test k of group g names, for the receiver
// at staged slot t: shift 16 g + k / 2 + 1, minus for even k (partner i -
// shift), plus for odd k.
__device__ __forceinline__ int partner_slot(int t, int g, int k) {
  const int shift = 16 * g + (k >> 1) + 1;
  return (k & 1) ? t + shift : t - shift;
}

// Shared memory of the staged kernel: each warp's term buffer [32] float2
// and queue [kQueue] u16, then the positions [kBlock + 2 Wp] float2, Wp the
// window rounded up to a whole group of 16 shifts.
__host__ __device__ constexpr long long staged_fixed_bytes() {
  return kWarps * (32 * 8LL + kQueue * 2LL);
}

__host__ __device__ constexpr int padded_window(int window) {
  return (window + 15) & ~15;
}

// The halo staged in shared memory: kBlock + 2 Wp slots of (x, y), NaN where
// the slot is dead or outside [0, n), so every group runs its 32 tests
// without a bound (the last group's tests past W are masked off).  `cut`
// is t above.
__global__ void __launch_bounds__(kBlock)
window_staged_kernel(const float* __restrict__ pos,
                     const unsigned char* __restrict__ alive,
                     float* __restrict__ out, int n, int window, float k_sep,
                     float cut, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_term = reinterpret_cast<float2*>(smem);
  uint16_t* s_queue =
      reinterpret_cast<uint16_t*>(smem + kWarps * 32 * sizeof(float2));
  float2* s_xy = reinterpret_cast<float2*>(smem + staged_fixed_bytes());
  const int wp = padded_window(window);
  const int span = kBlock + 2 * wp;
  const float nan = __int_as_float(0x7fffffff);

  const int base = blockIdx.x * kBlock - wp;  // slot of s_xy[0]
#pragma unroll 1
  for (int k = threadIdx.x; k < span; k += kBlock) {
    const int j = base + k;
    const bool in = j >= 0 && j < n && alive[j] != 0;
    s_xy[k] = in ? make_float2(pos[2 * j], pos[2 * j + 1])
                 : make_float2(nan, nan);
  }
  __syncthreads();   // the only barrier: every thread goes on to the end

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int t = threadIdx.x + wp;  // receiver's staged slot
  const bool live = i < n && alive[i] != 0;
  const float2 me = s_xy[t];
  float2* term = s_term + warp * 32;
  uint16_t* queue = s_queue + warp * kQueue;
  const int warp_t = warp * 32 + wp;   // staged slot of the warp's lane 0
  float fx = 0.0f, fy = 0.0f;
  const int groups = (window + 15) >> 4;
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
    // The near shifts of this group, bit k for test k: shift 16 g + j + 1
    // below (k = 2 j) and above (k = 2 j + 1).
    uint32_t mask = 0;
    const float2* below = s_xy + (t - 16 * g - 1);
    const float2* above = s_xy + (t + 16 * g + 1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float dx, dy;
      if (sq_dist(me, below[-j], dx, dy) < cut) mask |= 1u << (2 * j);
      if (sq_dist(me, above[j], dx, dy) < cut) mask |= 2u << (2 * j);
    }
    const int left = window - 16 * g;   // shifts of the window in this group
    if (left < 16) mask &= (1u << (2 * left)) - 1u;
    if (!live) mask = 0;
    const int count = __popc(mask);
    int incl = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int off = incl - count;
    const int total = __shfl_sync(kFull, incl, 31);
    if (total == 0) continue;
    const int most = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(count)));
    if (((total + 31) >> 5) >= most) {
      // Crowded: each lane adds its own near pairs in shift order.
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const float2 f = near_term(me, s_xy[partner_slot(t, g, k)], k_sep,
                                   eps);
        fx = __fadd_rn(fx, f.x);
        fy = __fadd_rn(fy, f.y);
      }
      continue;
    }
    // The queue: this lane's near pairs at off, off + 1, ... in shift
    // order, each (lane << 5) | test.
#pragma unroll 1
    for (int e = off; mask; ++e) {
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      queue[e] = static_cast<uint16_t>((lane << 5) | k);
    }
    __syncwarp();
#pragma unroll 1
    for (int at = 0; at < total; at += 32) {
      const int p = at + lane;
      if (p < total) {
        const int entry = queue[p];
        const int r = warp_t + (entry >> 5);
        term[lane] = near_term(s_xy[r], s_xy[partner_slot(r, g, entry & 31)],
                               k_sep, eps);
      }
      __syncwarp();
      const int hi = min(off + count, at + 32);
#pragma unroll 1
      for (int e = max(off, at); e < hi; ++e) {
        const float2 f = term[e - at];
        fx = __fadd_rn(fx, f.x);
        fy = __fadd_rn(fy, f.y);
      }
      __syncwarp();
    }
  }
  if (i < n) {
    out[2 * i] = fx;
    out[2 * i + 1] = fy;
  }
}

// Partners read from global memory, for a halo too wide to stage (the first
// version).
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
  const long long bytes = staged_fixed_bytes() +
                          (kBlock + 2LL * padded_window(window)) *
                              sizeof(float2);
  return bytes <= kStageBytes ? bytes : 0;
}

}  // namespace

// pos [n, 2] f32 and alive [n] u8 (bool) in, out [n, 2] f32, all contiguous
// on `device`, sorted by Morton key; `cut` the least float32 whose
// correctly rounded square root is >= r_cut.  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_window_separation_f32(const float* pos,
                                         const unsigned char* alive,
                                         float* out, int n, int window,
                                         float k_sep, float r_cut, float cut,
                                         float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || window < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stage = stage_bytes(window);
  if (stage > 0) {
    window_staged_kernel<<<grid, kBlock, static_cast<size_t>(stage), s>>>(
        pos, alive, out, n, window, k_sep, cut, eps);
  } else {
    window_global_kernel<<<grid, kBlock, 0, s>>>(pos, alive, out, n, window,
                                                 k_sep, r_cut, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
