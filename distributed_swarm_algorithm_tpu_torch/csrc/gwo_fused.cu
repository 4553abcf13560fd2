// Fused grey-wolf-optimizer steps for Hopper (sm_90a): k pack updates in
// one pass.
//
// dsa_gwo_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/gwo_fused.py:fused_gwo_step_t
//   (body _make_kernel).
//
// What one launch computes, for pos in the transposed layout [D, N] (wolves
// along the fast axis) and the leaders [3, D] held fixed over the launch,
// k_steps times:
//
//   a = 2 (1 - min((t0 + step) / t_max, 1))
//   for leader l = 0, 1, 2, with uniforms r1 = u_a[l D + d], r2 = u_c[l D + d]:
//     A = 2 a r1 - a;  C = 2 r2
//     acc += lead_l - A |C lead_l - pos|         (acc starts at 0)
//   pos = clip(acc / 3, +-half_width)
//
// and then, once, fit = objective(pos).  t0, the iteration at the launch's
// start, is read from the device; the wrapper's caller re-ranks the leaders
// between launches.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed.  u_a is
// stream 0 and u_c stream 1, each a [3 D] block per wolf in the leaders'
// order (index l D + d): word j of the call with the counter (lane, g,
// global step, stream) is index 4 g + j.  No launch geometry enters, so
// the plain PyTorch version draws the same numbers; with u_a/u_c given as
// operands ([3 D, N], one step only) the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction
// (see swarm_objectives.cuh); the two divisions are true divisions.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin.  Bytes:
// pos read and written once, fit written: 4 (2 D + 1) N bytes, 0.26 GB,
// 0.08 ms at 3.35 TB/s.  Operations per element and step: two Philox calls
// per four of the 3 D indices (150), six uniforms (18), three attraction
// terms (24), the sum, the division and the clip (6): 198, and rastrigin
// once per launch; 5.1e10 a launch, 0.76 ms at 67 TFLOP/s: operations bound
// it, and the Philox rounds are three quarters of them.  Measured at that
// shape on an NVIDIA H100 80GB HBM3 at 700 W: 2.77 ms a launch, 3.7 times
// the bound (PERF.md).
//
// Design (first, simple version).  One thread per wolf.  A block stages its
// wolves' pos and the running sum acc in dynamic shared memory as
// [2][D][block], the thread index fastest (a thread owns a column: no bank
// conflicts, no barriers).  Each step walks the 3 D indices in order, one
// Philox call per stream for four of them: leader 0 writes acc, leader 1
// adds to it, leader 2 finishes the sum and overwrites pos, whose last
// reader it is.  The block is 128 threads where 2 D 128 floats fit the
// 227 KB a block may take, else 64, else 32 (D <= 908); above 48 KB the
// entry opts in with cudaFuncSetAttribute.  The ragged edge is masked.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/gwo_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;

struct GwoArgs {
  const int* scalars;     // [2] i32 on the device: seed, block-start iteration
  const float* leaders;   // [3, D]
  const float* pos;       // [D, N]
  const float* r_a;       // [3 D, N] or null: draw in the kernel
  const float* r_c;       // [3 D, N]
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  int n;
  int dim;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float t_max, half_width;
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

__global__ void gwo_fused_kernel(const GwoArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const int dim3 = 3 * dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  float* s_acc = s_pos + static_cast<size_t>(dim) * block;

  for (int d = 0; d < dim; ++d) s_pos[d * block] = a.pos[d * n + lane];
  const float t0 = static_cast<float>(a.scalars[1]);
  const bool host_rng = a.r_a != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float frac =
        fminf(div(add(t0, static_cast<float>(step)), a.t_max), 1.0f);
    const float aa = mul(2.0f, sub(1.0f, frac));
    const float two_a = mul(2.0f, aa);
    for (int i0 = 0; i0 < dim3; i0 += 4) {
      float ua[4], uc[4];
      if (host_rng) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = i0 + j < dim3;
          ua[j] = in ? a.r_a[(i0 + j) * n + lane] : 0.0f;
          uc[j] = in ? a.r_c[(i0 + j) * n + lane] : 0.0f;
        }
      } else {
        const uint32_t g = static_cast<uint32_t>(i0 >> 2);
        const dsa::Philox4 pa =
            dsa::philox4x32_10(static_cast<uint32_t>(lane), g, ctr, 0u, seed, 0u);
        const dsa::Philox4 pc =
            dsa::philox4x32_10(static_cast<uint32_t>(lane), g, ctr, 1u, seed, 0u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ua[j] = dsa::uniform_from_bits(pa.v[j]);
          uc[j] = dsa::uniform_from_bits(pc.v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j;
        if (i < dim3) {
          const int ell = i / dim;
          const int d = i - ell * dim;
          const float lead = a.leaders[i];
          const float x = s_pos[d * block];
          const float big_a = sub(mul(two_a, ua[j]), aa);
          const float big_c = mul(2.0f, uc[j]);
          const float dist = fabsf(sub(mul(big_c, lead), x));
          const float term = sub(lead, mul(big_a, dist));
          if (ell == 0) {
            s_acc[d * block] = add(0.0f, term);
          } else if (ell == 1) {
            s_acc[d * block] = add(s_acc[d * block], term);
          } else {
            const float v = div(add(s_acc[d * block], term), 3.0f);
            s_pos[d * block] = fminf(fmaxf(v, -a.half_width), a.half_width);
          }
        }
      }
    }
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = s_pos[d * block];
  a.fit_out[lane] =
      dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
}

// Threads per block: the largest of 128, 64, 32 whose tile fits, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (2ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_gwo_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: leaders [3, D], pos [D, N], r_a
// and r_c [3 D, N] (both or neither), pos_out [D, N], fit_out [N]; scalars
// [2] i32 (seed, block-start iteration).  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_gwo_fused_f32(
    const int* scalars, const float* leaders, const float* pos,
    const float* r_a, const float* r_c, float* pos_out, float* fit_out, int n,
    int dim, int k_steps, unsigned step0, int objective, float t_max,
    float half_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  if (n <= 0 || dim <= 0 || k_steps <= 0 || block == 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || (r_a == nullptr) != (r_c == nullptr) ||
      (r_a != nullptr && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GwoArgs a{scalars, leaders, pos, r_a, r_c, pos_out, fit_out, n,
                  dim, k_steps, step0, objective, t_max, half_width};
  const size_t shared = 2ull * dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(gwo_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  gwo_fused_kernel<<<blocks, block, shared,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
