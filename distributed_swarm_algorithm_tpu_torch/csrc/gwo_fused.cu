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
// it, and the Philox rounds are three quarters of them.  The bound counts
// Philox's integer work at the f32 rate; its 32-bit products issue on the
// pipe that also runs f32 multiply-adds, at half the f32 rate, so 30 of
// them a group and stream pair hold a floor of 0.73-0.82 ms a launch here.
// The first version took 2.77 ms; this one 1.49 ms (PERF.md; chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W).  Occupancy and instruction mix
// there (chip_smoke.py phase 2): 72-84 registers by D mod 4 (84 at D = 30:
// 6 blocks of 128 threads an SM), no spills; the D = 30 kernel's SASS holds
// 144 IMAD.WIDE (both words of a product), 73 IMAD and 8 IMAD.HI against
// 178 LOP3 and 343 IADD3 among 3,992 instructions.
//
// Design (rule 2's redesign).  One thread per wolf.  The first version
// divided each index by D at run time (a ~20-instruction sequence, 90 times
// a wolf-step), read the leaders from global memory at every index, and
// sent pos and the running sum through shared memory three times an index.
// Now:
//   - the walk goes over chunks of 4 dimensions, and for each chunk over the
//     three leaders: index l D + d lies in Philox group (l D >> 2) + q (+ 1)
//     at word ((l D) & 3) + j.  The kernel is a template on D mod 4, so each
//     leader's word offset o_l = (l D) & 3 is a constant: a leader whose
//     indices start mid-group carries the words of its current group in
//     registers to the next chunk (the group it shares with the previous
//     leader is drawn by both, one extra group a step at most twice).  No
//     division or remainder by a runtime value;
//   - the three terms of a dimension sum in registers (acc starts at 0 and
//     takes leaders 0, 1, 2 in order, as the plain version does), and pos
//     is read and written once a dimension and step, in a [D][block]
//     shared tile with the thread index fastest (no bank conflicts); the
//     leaders are staged once a block in shared memory ([3][D rounded to
//     4]) and read 4 at a time;
//   - the Philox work that depends only on the lane or the step is hoisted
//     (philox_pair.cuh): 30 products a group and stream pair instead of 40.
// pos stays in shared memory at every D: with the chunk loop rolled there is
// one copy of the Philox code a leader, and the tile costs two of the ~125
// instructions of a dimension-step.  A register-held pos for D <= 32 needs
// the chunk loop unrolled (a register array takes no runtime index): that
// repeats the Philox code 8 times, ran out of registers and spilled.  The block is 128 threads
// where the first version's [2][D][128] tile fits the 227 KB a block may
// take, else 64, else 32 (D <= 908, the envelope kept); above 48 KB the
// entry opts in with cudaFuncSetAttribute.  The ragged edge is masked.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/gwo_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "philox_pair.cuh"
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

__device__ __forceinline__ void draw(const dsa::PhiloxPairLane& pl,
                                     const dsa::PhiloxPairStep& ps, int g,
                                     uint32_t wa[4], uint32_t wc[4]) {
  dsa::Philox4 w[2];
  dsa::philox_pair_group(pl, ps, static_cast<uint32_t>(g), w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wa[j] = w[0].v[j];
    wc[j] = w[1].v[j];
  }
}

template <int kR>   // D mod 4
__global__ void gwo_fused_kernel(const GwoArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const int dim = a.dim;
  const int dim4 = (dim + 3) & ~3;
  float* s_lead = smem;                     // [3][dim4]
  float* s_pos = smem + 3 * dim4 + t;       // column t of [dim][block]
  for (int e = t; e < dim4; e += block) {
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      s_lead[l * dim4 + e] = e < dim ? a.leaders[l * dim + e] : 0.0f;
    }
  }
  __syncthreads();   // the only barrier: the ragged edge may leave below
  const long long lane_ll = static_cast<long long>(blockIdx.x) * block + t;
  if (lane_ll >= a.n) return;
  const int lane = static_cast<int>(lane_ll);
  const size_t n = static_cast<size_t>(a.n);

  for (int d = 0; d < dim; ++d) s_pos[d * block] = a.pos[d * n + lane];
  const float t0 = static_cast<float>(a.scalars[1]);
  const bool host_rng = a.r_a != nullptr;
  const uint32_t seed = host_rng ? 0u : static_cast<uint32_t>(a.scalars[0]);
  const dsa::PhiloxPairLane pl = dsa::philox_pair_lane(static_cast<uint32_t>(lane));
  int gbase[3];   // Philox group of each leader's first index
#pragma unroll
  for (int l = 0; l < 3; ++l) gbase[l] = (l * dim) >> 2;
  const int chunks = dim4 >> 2;

  for (int step = 0; step < a.k_steps; ++step) {
    const uint32_t ctr = a.step0 + static_cast<uint32_t>(step);
    const float frac =
        fminf(div(add(t0, static_cast<float>(step)), a.t_max), 1.0f);
    const float aa = mul(2.0f, sub(1.0f, frac));
    const float two_a = mul(2.0f, aa);
    const dsa::PhiloxPairStep ps = dsa::philox_pair_step(pl, ctr, seed);

    // The words of a misaligned leader's current group.
    uint32_t cur_a[3][4], cur_c[3][4];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      if (((l * kR) & 3) != 0 && !host_rng) {
        draw(pl, ps, gbase[l], cur_a[l], cur_c[l]);
      }
    }

    for (int q = 0; q < chunks; ++q) {
      const int d0 = 4 * q;
      const int nv = min(4, dim - d0);
      float x[4], acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = j < nv ? s_pos[(d0 + j) * block] : 0.0f;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const int o = (l * kR) & 3;   // a constant once l is unrolled
        float ua[4], uc[4];
        if (host_rng) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t i = static_cast<size_t>(l * dim + d0 + j);
            ua[j] = j < nv ? a.r_a[i * n + lane] : 0.0f;
            uc[j] = j < nv ? a.r_c[i * n + lane] : 0.0f;
          }
        } else {
          uint32_t wa[4], wc[4];
          if (o == 0) {
            draw(pl, ps, gbase[l] + q, wa, wc);
          } else {
            uint32_t na[4] = {0u, 0u, 0u, 0u}, nc[4] = {0u, 0u, 0u, 0u};
            if (d0 + 4 - o < dim) draw(pl, ps, gbase[l] + q + 1, na, nc);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wa[j] = j < 4 - o ? cur_a[l][(o + j) & 3] : na[(j + o) & 3];
              wc[j] = j < 4 - o ? cur_c[l][(o + j) & 3] : nc[(j + o) & 3];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              cur_a[l][j] = na[j];
              cur_c[l][j] = nc[j];
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ua[j] = dsa::uniform_from_bits(wa[j]);
            uc[j] = dsa::uniform_from_bits(wc[j]);
          }
        }
        const float4 lead4 =
            *reinterpret_cast<const float4*>(s_lead + l * dim4 + d0);
        const float lead[4] = {lead4.x, lead4.y, lead4.z, lead4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float big_a = sub(mul(two_a, ua[j]), aa);
          const float big_c = mul(2.0f, uc[j]);
          const float dist = fabsf(sub(mul(big_c, lead[j]), x[j]));
          const float term = sub(lead[j], mul(big_a, dist));
          if (l == 0) {
            acc[j] = add(0.0f, term);
          } else if (l == 1) {
            acc[j] = add(acc[j], term);
          } else {
            const float v = div(add(acc[j], term), 3.0f);
            acc[j] = fminf(fmaxf(v, -a.half_width), a.half_width);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nv) s_pos[(d0 + j) * block] = acc[j];
      }
    }
  }

  for (int d = 0; d < dim; ++d) a.pos_out[d * n + lane] = s_pos[d * block];
  a.fit_out[lane] =
      dsa::evaluate_objective(a.objective, Column{s_pos, block}, dim);
}

// Both streams' words for each (lane, g, ctr, seed) of the arrays, by the
// hoisted helper and by philox4x32_10: out [n][2 helper, ref][2 streams][4].
__global__ void philox_check_kernel(const uint32_t* lanes, const uint32_t* gs,
                                    const uint32_t* ctrs,
                                    const uint32_t* seeds, int n,
                                    uint32_t* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const dsa::PhiloxPairLane pl = dsa::philox_pair_lane(lanes[e]);
  const dsa::PhiloxPairStep ps = dsa::philox_pair_step(pl, ctrs[e], seeds[e]);
  dsa::Philox4 w[2];
  dsa::philox_pair_group(pl, ps, gs[e], w);
  uint32_t* o = out + static_cast<size_t>(e) * 16;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const dsa::Philox4 r = dsa::philox4x32_10(lanes[e], gs[e], ctrs[e],
                                              static_cast<uint32_t>(s),
                                              seeds[e], 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * s + j] = w[s].v[j];
      o[8 + 4 * s + j] = r.v[j];
    }
  }
}

// Threads per block: the largest of 128, 64, 32 whose first-version tile
// [2][D][block] fits, or 0 (the envelope, D <= 908).
int pick_block(int dim) {
  for (int block = 128; block >= 32; block >>= 1) {
    if (2ull * dim * block * sizeof(float) <= kMaxSharedBytes) return block;
  }
  return 0;
}

template <int kR>
cudaError_t launch(const GwoArgs& a, int block, cudaStream_t s) {
  const int dim4 = (a.dim + 3) & ~3;
  const size_t shared = (3ull * dim4 + 1ull * a.dim * block) * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gwo_fused_kernel<kR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (static_cast<unsigned>(a.n) + block - 1) / block;
  gwo_fused_kernel<kR><<<blocks, block, shared, s>>>(a);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim & 3) {
    case 0: err = launch<0>(a, block, s); break;
    case 1: err = launch<1>(a, block, s); break;
    case 2: err = launch<2>(a, block, s); break;
    default: err = launch<3>(a, block, s); break;
  }
  return static_cast<int>(err);
}

// The hoisted Philox helper against philox4x32_10 (a test's entry): for
// each of the n (lane, g, ctr, seed), out[16 e ...] holds the helper's
// words of streams 0 and 1, then philox4x32_10's.  All arrays uint32 on
// `device`; launched on `stream`.
extern "C" int dsa_gwo_philox_check(const unsigned* lanes, const unsigned* gs,
                                    const unsigned* ctrs,
                                    const unsigned* seeds, int n,
                                    unsigned* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  philox_check_kernel<<<(n + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(lanes, gs, ctrs,
                                                             seeds, n, out);
  return static_cast<int>(cudaGetLastError());
}
