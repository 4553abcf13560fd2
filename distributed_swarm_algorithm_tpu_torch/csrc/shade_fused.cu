// Fused SHADE-R generation for Hopper (sm_90a): one current-to-pbest/1
// generation with rotational donors.
//
// dsa_shade_fused_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/shade_fused.py:
//   fused_shade_step_t (body _make_kernel).
//
// What one launch computes, for pos and archive in the transposed layout
// [D, N], N a whole number of tiles of tile_n lanes (a multiple of 128),
// for lane j of tile i:
//
//   roll(X, t, l)[j] = lane (j - l) mod tile_n of tile (i + t) mod n_tiles
//   r1 = roll(pos, s1, l1);  r2 = u_src < frac / 65536 ? roll(archive, s3,
//   l3) : roll(pos, s2, l2);  pb = elite column (j - le) mod 128
//   mutant = clip((x + F (pb - x)) + F (r1 - r2), +-half_width)
//   trial  = u_cross < CR ? mutant : x      (per gene, no j_rand)
//   x, fit = f(trial) <= fit ? (trial, f(trial)) : (x, fit)
//
// with F and CR per individual ([N] rows), the elite pool [D, 128], and
// the shifts and frac read from the device.  Every read comes from an
// input, so lanes are independent.
//
// Random numbers: Philox4x32-10 (philox.cuh) keyed by the seed; u_cross is
// stream 0 over the dimensions, counter (lane, block of four dimensions,
// generation, 0); u_src is word 0 of the call (lane, 0, generation, 1).
// With both given as operands the kernel reads them instead.
//
// Arithmetic: IEEE intrinsics in the plain version's order, no
// contraction, so kernel and plain version agree bit for bit.
//
// Bound on this card, at N = 1,048,576, D = 30, rastrigin.  Bytes: pos
// and archive read once, fit, F and CR read once, the elite pool, pos and
// fit written: 4 (3 D + 4) N + 512 D bytes, 0.39 GB, 0.117 ms at 3.35
// TB/s.  Operations per element: the draw (28), the crossover test (1),
// the source select (1), the mutant with its clip (9), the select (1),
// rastrigin (23): 63; per individual 128 (the source draw's call and
// uniform, the donor lanes); 2.1e9, 0.031 ms at 67 TFLOP/s: bytes bound it.
//
// Design (first, simple version).  One thread per individual.  A block
// stages the elite pool [D][128] in dynamic shared memory once and its
// trial as [D][block], the thread index fastest; pos and the donors are
// read from global memory (consecutive lanes read consecutive addresses,
// but for one wrap), only where the gene crosses, and the outputs are
// written out of place.  The block is 128 threads where both fit the
// 227 KB a block may take, else 64, else 32 (D <= 363).
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/shade_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "swarm_objectives.cuh"

namespace {

constexpr size_t kMaxSharedBytes = 227 * 1024;
constexpr int kElite = 128;

struct ShadeArgs {
  const int* scalars;     // [9] i32: seed, s1, s2, s3, l1, l2, l3, le, frac
  const float* pos;       // [D, N]
  const float* fit;       // [N]
  const float* f_row;     // [N]
  const float* cr_row;    // [N]
  const float* archive;   // [D, N]
  const float* elite;     // [D, 128]
  const float* r_cross;   // [D, N] or null: draw in the kernel
  const float* r_src;     // [N]
  float* pos_out;         // [D, N]
  float* fit_out;         // [N]
  int n;
  int dim;
  int tile_n;
  uint32_t step;          // the generation: Philox counter word 2
  int objective;
  float half_width;
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

__device__ __forceinline__ long long wrap(long long v, long long m) {
  return (v % m + m) % m;
}

__global__ void shade_fused_kernel(const ShadeArgs a) {
  extern __shared__ float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  float* s_elite = smem;
  float* s_trial = smem + static_cast<size_t>(dim) * kElite + t;
  for (int i = t; i < dim * kElite; i += block) s_elite[i] = a.elite[i];
  __syncthreads();
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;  // no barrier below
  const int lane = static_cast<int>(lane_ll);
  const size_t n = static_cast<size_t>(a.n);

  const bool host_rng = a.r_cross != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const long long tile_n = a.tile_n;
  const long long n_tiles = a.n / tile_n;
  const long long tile = lane / tile_n;
  const long long j = lane - tile * tile_n;
  const float* r1 = a.pos + wrap(tile + a.scalars[1], n_tiles) * tile_n +
                    wrap(j - a.scalars[4], tile_n);
  const float* r2p = a.pos + wrap(tile + a.scalars[2], n_tiles) * tile_n +
                     wrap(j - a.scalars[5], tile_n);
  const float* r2a = a.archive + wrap(tile + a.scalars[3], n_tiles) * tile_n +
                     wrap(j - a.scalars[6], tile_n);
  const int ecol = static_cast<int>(wrap(j - a.scalars[7], kElite));
  const float frac = div(static_cast<float>(a.scalars[8]), 65536.0f);
  const float u_src =
      host_rng ? a.r_src[lane]
               : dsa::uniform_from_bits(
                     dsa::philox4x32_10(static_cast<uint32_t>(lane), 0u,
                                        a.step, 1u, seed, 0u).v[0]);
  const float* r2 = u_src < frac ? r2a : r2p;
  const float f = a.f_row[lane];
  const float cr = a.cr_row[lane];

  for (int d0 = 0; d0 < dim; d0 += 4) {
    float u[4];
    if (host_rng) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        u[q] = d0 + q < dim ? a.r_cross[(d0 + q) * n + lane] : 0.0f;
      }
    } else {
      const dsa::Philox4 p = dsa::philox4x32_10(
          static_cast<uint32_t>(lane), static_cast<uint32_t>(d0 >> 2), a.step,
          0u, seed, 0u);
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = dsa::uniform_from_bits(p.v[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = d0 + q;
      if (d < dim) {
        const size_t off = static_cast<size_t>(d) * n;
        float v = a.pos[off + lane];
        if (u[q] < cr) {
          const float pb = s_elite[d * kElite + ecol];
          const float m = add(add(v, mul(f, sub(pb, v))),
                              mul(f, sub(r1[off], r2[off])));
          v = fminf(fmaxf(m, -a.half_width), a.half_width);
        }
        s_trial[d * block] = v;
      }
    }
  }
  const float tfit =
      dsa::evaluate_objective(a.objective, Column{s_trial, block}, dim);
  const bool accept = tfit <= a.fit[lane];
  for (int d = 0; d < dim; ++d) {
    const size_t off = static_cast<size_t>(d) * n + lane;
    a.pos_out[off] = accept ? s_trial[d * block] : a.pos[off];
  }
  a.fit_out[lane] = accept ? tfit : a.fit[lane];
}

size_t shared_bytes(int dim, int block) {
  return 1ull * dim * (block + kElite) * sizeof(float);
}

// Threads per block: the largest of 128, 64, 32 whose buffers fit, or 0.
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (shared_bytes(dim, block) <= kMaxSharedBytes) return block;
  }
  return 0;
}

}  // namespace

// Threads per block the entry uses for `dim` (0: outside the envelope).
extern "C" int dsa_shade_fused_block(int dim) { return pick_block(dim); }

// All arrays f32, contiguous, on `device`: pos [D, N], fit, f_row, cr_row
// [N], archive [D, N], elite [D, 128], the draws r_cross [D, N] and r_src
// [N] (both or neither), pos_out [D, N], fit_out [N]; scalars [9] i32.
// N is a multiple of tile_n, tile_n of 128.  Launched on `stream` without
// synchronising.  Returns the CUDA error of the launch (0 when accepted).
extern "C" int dsa_shade_fused_f32(
    const int* scalars, const float* pos, const float* fit,
    const float* f_row, const float* cr_row, const float* archive,
    const float* elite, const float* r_cross, const float* r_src,
    float* pos_out, float* fit_out, int n, int dim, int tile_n,
    unsigned step, int objective, float half_width, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int block = pick_block(dim);
  if (n <= 0 || dim <= 0 || block == 0 || tile_n <= 0 ||
      n % tile_n != 0 || tile_n % kElite != 0 || objective < 0 ||
      objective >= dsa::kObjectiveCount || (!r_cross != !r_src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ShadeArgs a{scalars, pos, fit, f_row, cr_row, archive, elite,
                    r_cross, r_src, pos_out, fit_out, n, dim, tile_n, step,
                    objective, half_width};
  const size_t shared = shared_bytes(dim, block);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(shade_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = (static_cast<unsigned>(n) + block - 1) / block;
  shade_fused_kernel<<<blocks, block, shared,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
