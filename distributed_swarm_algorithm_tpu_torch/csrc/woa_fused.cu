// Fused whale-optimization steps for Hopper (sm_90a): k pod updates in one
// pass.
//
// dsa_woa_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/woa_fused.py:fused_woa_step_t
//   (body _make_kernel).
//
// What one launch computes, for pos in the transposed layout [D, N] (whales
// along the fast axis), N a whole number of tiles of tile_n lanes, and the
// incumbent best held fixed, k_steps times:
//
//   a = 2 (1 - min((t0 + step) / t_max, 1));  A = 2 a u_a - a;  C = 2 u_c
//   peer = lane (j - s) mod tile_n of tile (i + tshift) mod n_tiles of the
//          launch's INPUT, for lane j of tile i, s = lshift + shift[step % 8]
//   p < 1/2:  prey = |A| >= 1 ? peer : best (per element)
//             x = prey - A |C prey - x|
//   else:     l = 2 u_l - 1;  x = |best - x| e^{b l} cos(2 pi l) + best
//   x clipped to +-half_width
//
// and then, once, fit = objective(x).  The peer is the block-start snapshot
// of another tile, a roll of its lanes (jnp.roll's direction); t0, tshift
// and lshift are read from the device.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed.  u_a is
// stream 0 and u_c stream 1 over the dimensions, counter (lane, block of
// four dimensions, global step, stream); p and u_l are words 0 and 1 of the
// call (lane, 0, global step, 2).  No launch geometry enters, so the plain
// PyTorch version draws the same numbers; with the four draws given as
// operands (one step only) the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no contraction;
// e^{b l} calls expf as torch.exp does on the card, cos(2 pi l) is the
// header's polynomial.
//
// Bound on this card, at N = 1,048,576, D = 30, 8 steps, rastrigin.  Bytes:
// pos read and written once, fit written: 4 (2 D + 1) N bytes, 0.26 GB,
// 0.08 ms at 3.35 TB/s (the peer reads come from the same input).
// Operations per element and step: A's and C's draws (56), A and C (3),
// the explore test and select (3), the contraction (5), the spiral (5), the
// select and the clip (3): 75; per whale and step 147 (the row call and its
// two uniforms, the schedule, expf, the cos2pi polynomial, the peer's
// lane); rastrigin once a launch; 2.1e10 a launch, 0.31 ms at 67 TFLOP/s:
// operations bound it.  Measured at that shape on an NVIDIA H100 80GB HBM3
// at 700 W: 0.76 ms a launch, 2.5 times the bound (PERF.md).
//
// Design (first, simple version).  One thread per whale, as B5: a block
// stages its whales' pos in dynamic shared memory as [D][block], the thread
// index fastest (no bank conflicts, no barriers), and reads the peer
// straight from the input in global memory (consecutive lanes read
// consecutive addresses, but for one wrap), so the outputs are written out
// of place.  The block is 128 threads where D 128 floats fit the 227 KB a
// block may take, else 64, else 32 (D <= 1816); above 48 KB the entry opts
// in with cudaFuncSetAttribute.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/woa_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;

// The per-step lane rotations (ops/cuda/family.py: LANE_SHIFTS, first
// column): the peer's roll is lshift + kLaneShift[step % 8].
__constant__ int kLaneShift[8] = {1, 3, 7, 11, 17, 23, 29, 37};

struct WoaArgs {
  const int* scalars;     // [4] i32 on the device: seed, tshift, t0, lshift
  const float* best;      // [D]
  const float* pos;       // [D, N]
  const float* r_a;       // [D, N] or null: draw in the kernel
  const float* r_c;       // [D, N]
  const float* r_p;       // [N]
  const float* r_l;       // [N]
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  int n;
  int dim;
  int tile_n;
  int k_steps;
  uint32_t step0;         // global index of the launch's first step
  int objective;
  float t_max, spiral_b, half_width;
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

__global__ void woa_fused_kernel(const WoaArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below, so the edge may leave
  const int lane = static_cast<int>(lane_ll);
  const int dim = a.dim;
  const size_t n = static_cast<size_t>(a.n);
  float* s_pos = smem + t;
  for (int d = 0; d < dim; ++d) s_pos[d * block] = a.pos[d * n + lane];

  const bool host_rng = a.r_a != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const long long n_tiles = a.n / a.tile_n;
  const long long tile = lane / a.tile_n;
  const long long j = lane - tile * a.tile_n;
  const long long tshift = a.scalars[1];
  const float t0 = static_cast<float>(a.scalars[2]);
  const long long lshift = a.scalars[3];
  const long long peer_tile = ((tile + tshift) % n_tiles + n_tiles) % n_tiles;

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float frac =
        fminf(div(add(t0, static_cast<float>(step)), a.t_max), 1.0f);
    const float aa = mul(2.0f, sub(1.0f, frac));
    const float two_a = mul(2.0f, aa);
    float u_p, u_l;
    if (host_rng) {
      u_p = a.r_p[lane];
      u_l = a.r_l[lane];
    } else {
      const dsa::Philox4 rows = dsa::philox4x32_10(
          static_cast<uint32_t>(lane), 0u, ctr, 2u, seed, 0u);
      u_p = dsa::uniform_from_bits(rows.v[0]);
      u_l = dsa::uniform_from_bits(rows.v[1]);
    }
    const bool contract = u_p < 0.5f;
    const float l = sub(mul(2.0f, u_l), 1.0f);
    const float spiral_scale = expf(mul(a.spiral_b, l));
    const float spiral_cos = dsa::obj::cos2pi(l);
    const long long s = lshift + kLaneShift[step & 7];
    const long long pj = ((j - s) % a.tile_n + a.tile_n) % a.tile_n;
    const float* peer = a.pos + peer_tile * a.tile_n + pj;

    for (int d0 = 0; d0 < dim; d0 += 4) {
      float ua[4], uc[4];
      if (host_rng) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = d0 + q < dim;
          ua[q] = in ? a.r_a[(d0 + q) * n + lane] : 0.0f;
          uc[q] = in ? a.r_c[(d0 + q) * n + lane] : 0.0f;
        }
      } else {
        const uint32_t g = static_cast<uint32_t>(d0 >> 2);
        const dsa::Philox4 pa =
            dsa::philox4x32_10(static_cast<uint32_t>(lane), g, ctr, 0u, seed, 0u);
        const dsa::Philox4 pc =
            dsa::philox4x32_10(static_cast<uint32_t>(lane), g, ctr, 1u, seed, 0u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ua[q] = dsa::uniform_from_bits(pa.v[q]);
          uc[q] = dsa::uniform_from_bits(pc.v[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + q;
        if (d < dim) {
          const float x = s_pos[d * block];
          const float b = a.best[d];
          float v;
          if (contract) {
            const float big_a = sub(mul(two_a, ua[q]), aa);
            const float big_c = mul(2.0f, uc[q]);
            const float prey = fabsf(big_a) >= 1.0f ? peer[d * n] : b;
            v = sub(prey, mul(big_a, fabsf(sub(mul(big_c, prey), x))));
          } else {
            v = add(mul(mul(fabsf(sub(b, x)), spiral_scale), spiral_cos), b);
          }
          s_pos[d * block] = fminf(fmaxf(v, -a.half_width), a.half_width);
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
    if (1ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_woa_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: best [D], pos [D, N], the draws
// r_a/r_c [D, N] and r_p/r_l [N] (all four or none), pos_out [D, N],
// fit_out [N]; scalars [4] i32 (seed, tile shift, block-start iteration,
// lane shift).  N is a multiple of tile_n.  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_woa_fused_f32(
    const int* scalars, const float* best, const float* pos, const float* r_a,
    const float* r_c, const float* r_p, const float* r_l, float* pos_out,
    float* fit_out, int n, int dim, int tile_n, int k_steps, unsigned step0,
    int objective, float t_max, float spiral_b, float half_width, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  const bool some = r_a || r_c || r_p || r_l;
  const bool all = r_a && r_c && r_p && r_l;
  if (n <= 0 || dim <= 0 || k_steps <= 0 || block == 0 || tile_n <= 0 ||
      n % tile_n != 0 || objective < 0 || objective >= dsa::kObjectiveCount ||
      some != all || (all && k_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WoaArgs a{scalars, best, pos, r_a, r_c, r_p, r_l, pos_out, fit_out,
                  n, dim, tile_n, k_steps, step0, objective, t_max,
                  spiral_b, half_width};
  const size_t shared = 1ull * dim * block * sizeof(float);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(woa_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  woa_fused_kernel<<<blocks, block, shared,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
