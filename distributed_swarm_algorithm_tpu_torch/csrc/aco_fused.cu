// Whole-tour ACO construction and the directed deposit matrix for Hopper
// (sm_90a).
//
// dsa_aco_tours_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/aco_fused.py:
//   fused_construct_tours (body _make_kernel);
// dsa_aco_deposit_f32 replaces
//   distributed_swarm_algorithm_tpu/ops/pallas/aco_fused.py:
//   fused_deposit_matrix (body _make_deposit_kernel).
//
// Tours.  Every ant a starts at start[a]; at each step s = 0 .. C - 2 it
// scores every city i by the column `cur` of the log-space scores, as the
// TPU kernel's row select logits @ onehot(cur) does,
//
//   sampled: open_i ? logits[i, cur] + g_i : -1e30,
//            g = -LN2 log2_fast(-LN2 log2_fast(clip(1 - u, 1e-7, 0.9999999)))
//   greedy:  open_i ? logits[i, cur] : -1e30,
//
// takes the argmax (the lowest city among equal maxima), marks it visited
// and adds dist[next, cur] to its length; the closing edge dist[start, last]
// comes last.  q0 picks the rule, a static choice as in the TPU kernel: mode 0
// (q0 <= 0) samples only, mode 2 (q0 >= 1) is greedy only, mode 1 takes the
// greedy city where the exploit uniform u_q < q0.  Random numbers:
// Philox4x32-10 (philox.cuh) keyed by the seed, u for cities 4b .. 4b + 3 the
// four words of the call with counter (ant, b, s, 0), u_q word 0 of (ant, 0,
// s, 1): what the plain version (ops/cuda/aco_fused.py) draws with
// pso_fused.philox_uniforms.  With u [C - 1, C, A] and u_q [C - 1, A] given
// as operands the kernel reads them instead.
//
// Deposit.  D[i, j] = sum over ants a (ascending) and steps t (ascending) of
// amount[a] where tour_a[t] = i and tour_a[(t + 1) mod C] = j; an entry
// outside [0, C) adds nothing, as a one-hot row of the TPU kernel.  The sum
// runs in that fixed order from 0, so D does not change from run to run and
// equals the plain version's bit for bit (no atomics).
//
// Arithmetic: IEEE intrinsics in the plain version's order, log2_fast from
// fast_math.cuh; tours and lengths equal the plain version's under
// torch.equal.
//
// Bound on this card at C = 256, A = 1,024 (chip_smoke.py: ACO_OPS counts the
// operations from this source).  Tours: logits and dist read, tours and
// lengths written, about 1.6 MB; a Philox call per block of four cities
// that still holds an open city, and per open city and step its uniform, the
// Gumbel transform (two log2s) and the score: about 3e9 operations, 0.045 ms
// at 67 TFLOP/s.  The kernel cannot come near it: each ant's 255 steps are a
// chain of dependent argmaxes, each a pass over the row and a 5-round
// shuffle reduction, so latency bounds it.
// Deposit: the tours and amounts read, D written, about 1.3 MB: 0.4 us.
//
// Design (first, simple version).  Tours: one warp per ant, no block
// barrier.  Lane l holds the city blocks b = l + 32 k of four cities each, so
// one Philox call feeds its four cities and a warp reads a row's 4 x 32
// consecutive floats at once; its visited bits live in a 64-bit register
// (C <= 2,048).  The scores are read from transposed copies of logits and
// dist (the wrapper makes them), so the column select reads a row.  A lane
// scans its cities in ascending order keeping the first strict maximum; the
// lanes then reduce (value, city) pairs by shuffles, the lower city winning a
// tie.  Deposit: one block of 256 threads per row i, the ants in chunks of
// 256, a thread per ant; each counts its matches (t with tour[t] = i), a
// block scan gives each ant its place, the matches (next city and amount)
// go in (ant, t) order into a shared list, in windows of 2,048 where a chunk
// holds more, and each thread adds the list's entries of its own columns, in
// order, into the row kept in shared memory.  Not done yet: several ants a
// warp to hide the chain's latency, and a deposit that reads the tours once
// instead of once per row.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/aco_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxCities = 2048;   // 64 cities a lane: one 64-bit mask
constexpr int kWarpsPerBlock = 4;
constexpr int kDepositThreads = 256;
constexpr int kWindow = 2048;      // shared match list of the deposit
constexpr float kNeg = -1e30f;
constexpr float kLn2 = static_cast<float>(0.6931471805599453);

using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

struct Best {
  float v;
  int i;
};

// The larger value, the lower city among equal values.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_argmax(Best b) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(0xffffffffu, b.v, s);
    o.i = __shfl_xor_sync(0xffffffffu, b.i, s);
    b = better(b, o);
  }
  return b;
}

__device__ __forceinline__ float gumbel(float u) {
  const float v = dsa::fast::clip(sub(1.0f, u), 1e-7f, 0.9999999f);
  const float inner = -mul(kLn2, dsa::fast::log2_fast(v));
  return -mul(kLn2, dsa::fast::log2_fast(inner));
}

struct TourArgs {
  const float* logits_t;  // [C, C]: row c is column c of the scores
  const float* dist_t;    // [C, C]: row c is column c of dist
  const int* start;       // [A]
  const float* u;         // [C - 1, C, A] or null: draw in the kernel
  const float* uq;        // [C - 1, A] or null
  const int* seed;        // [1]
  int* tours;             // [A, C]
  float* lengths;         // [A]
  int c;
  int a;
  float q0;
  int mode;               // 0 sampled, 1 mixed, 2 greedy
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tours_kernel(TourArgs p) {
  const int lane = threadIdx.x & 31;
  const int ant = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ant >= p.a) return;  // the whole warp leaves together
  const int c = p.c;
  const int n_blocks = (c + 3) / 4;
  const uint32_t seed = static_cast<uint32_t>(p.seed[0]);
  const int start = p.start[ant];
  int* tour = p.tours + static_cast<size_t>(ant) * c;
  if (start < 0 || start >= c) {  // not a city: no tour
    for (int t = lane; t < c; t += 32) tour[t] = -1;
    if (lane == 0) p.lengths[ant] = NAN;
    return;
  }

  uint64_t visited = 0;
  {
    const int b = start >> 2;
    if ((b & 31) == lane) visited |= 1ull << (4 * (b >> 5) + (start & 3));
  }
  if (lane == 0) tour[0] = start;
  int cur = start;
  float len = 0.0f;

  for (int t = 1; t < c; ++t) {
    const uint32_t step = static_cast<uint32_t>(t - 1);
    const float* row = p.logits_t + static_cast<size_t>(cur) * c;
    Best bs{-INFINITY, kMaxCities};
    Best bg{-INFINITY, kMaxCities};
    for (int b = lane, k = 0; b < n_blocks; b += 32, ++k) {
      float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (p.mode != 2 && p.u == nullptr) {
        const dsa::Philox4 w = dsa::philox4x32_10(
            static_cast<uint32_t>(ant), static_cast<uint32_t>(b), step, 0u,
            seed, 0u);
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = dsa::uniform_from_bits(w.v[r]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int city = 4 * b + r;
        if (city >= c) break;
        const bool open = !((visited >> (4 * k + r)) & 1ull);
        const float x = row[city];
        if (p.mode != 2) {
          float v = kNeg;
          if (open) {
            const float ur =
                p.u == nullptr
                    ? u[r]
                    : p.u[(static_cast<size_t>(step) * c + city) * p.a + ant];
            v = add(x, gumbel(ur));
          }
          if (v > bs.v) bs = Best{v, city};
        }
        if (p.mode != 0) {
          const float v = open ? x : kNeg;
          if (v > bg.v) bg = Best{v, city};
        }
      }
    }
    int nxt;
    if (p.mode == 0) {
      nxt = warp_argmax(bs).i;
    } else if (p.mode == 2) {
      nxt = warp_argmax(bg).i;
    } else {
      const int s_idx = warp_argmax(bs).i;
      const int g_idx = warp_argmax(bg).i;
      float uq;
      if (p.uq == nullptr) {
        uq = dsa::uniform_from_bits(
            dsa::philox4x32_10(static_cast<uint32_t>(ant), 0u, step, 1u,
                               seed, 0u).v[0]);
      } else {
        uq = p.uq[static_cast<size_t>(step) * p.a + ant];
      }
      nxt = uq < p.q0 ? g_idx : s_idx;
    }
    {
      const int b = nxt >> 2;
      if ((b & 31) == lane) visited |= 1ull << (4 * (b >> 5) + (nxt & 3));
    }
    len = add(len, p.dist_t[static_cast<size_t>(cur) * c + nxt]);
    if (lane == 0) tour[t] = nxt;
    cur = nxt;
  }
  len = add(len, p.dist_t[static_cast<size_t>(cur) * c + start]);
  if (lane == 0) p.lengths[ant] = len;
}

// Exclusive prefix sum over the block's 256 counts; returns the total.
__device__ int block_scan(int* s_scan, int v, int& excl) {
  const int tid = threadIdx.x;
  s_scan[tid] = v;
  __syncthreads();
  for (int off = 1; off < kDepositThreads; off <<= 1) {
    const int add_v = tid >= off ? s_scan[tid - off] : 0;
    __syncthreads();
    s_scan[tid] += add_v;
    __syncthreads();
  }
  excl = s_scan[tid] - v;
  const int total = s_scan[kDepositThreads - 1];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kDepositThreads)
deposit_kernel(const int* __restrict__ tours_t, const float* __restrict__ amount,
               float* __restrict__ d, int c, int a) {
  __shared__ float s_row[kMaxCities];
  __shared__ int s_nxt[kWindow];
  __shared__ float s_amt[kWindow];
  __shared__ int s_scan[kDepositThreads];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  for (int col = tid; col < c; col += kDepositThreads) s_row[col] = 0.0f;

  for (int chunk = 0; chunk < a; chunk += kDepositThreads) {
    const int ant = chunk + tid;
    const bool real = ant < a;
    int count = 0;
    if (real) {
      int here = tours_t[ant];
      for (int t = 0; t < c; ++t) {
        const int nxt = tours_t[static_cast<size_t>(t + 1 < c ? t + 1 : 0) * a
                                + ant];
        if (here == i && nxt >= 0 && nxt < c) ++count;
        here = nxt;
      }
    }
    int offset;
    const int total = block_scan(s_scan, count, offset);
    const float amt = real ? amount[ant] : 0.0f;
    for (int wbase = 0; wbase < total; wbase += kWindow) {
      if (real && count > 0 && offset < wbase + kWindow
          && offset + count > wbase) {
        int o = offset;
        int here = tours_t[ant];
        for (int t = 0; t < c && o < wbase + kWindow; ++t) {
          const int nxt = tours_t[static_cast<size_t>(t + 1 < c ? t + 1 : 0)
                                  * a + ant];
          if (here == i && nxt >= 0 && nxt < c) {
            if (o >= wbase) {
              s_nxt[o - wbase] = nxt;
              s_amt[o - wbase] = amt;
            }
            ++o;
          }
          here = nxt;
        }
      }
      __syncthreads();
      const int m = min(kWindow, total - wbase);
      for (int e = 0; e < m; ++e) {
        const int col = s_nxt[e];
        if (col % kDepositThreads == tid) s_row[col] = add(s_row[col], s_amt[e]);
      }
      __syncthreads();
    }
  }
  for (int col = tid; col < c; col += kDepositThreads) {
    d[static_cast<size_t>(i) * c + col] = s_row[col];
  }
}

}  // namespace

extern "C" int dsa_aco_max_cities() { return kMaxCities; }

// logits_t, dist_t [c, c] f32 (transposed scores and distances), start [a]
// i32, u [c - 1, c, a] and uq [c - 1, a] f32 or null, seed [1] i32 in; tours
// [a, c] i32 and lengths [a] f32 out; all contiguous on `device`, launched
// on `stream` without synchronising.  Returns the CUDA error of the launch.
extern "C" int dsa_aco_tours_f32(const float* logits_t, const float* dist_t,
                                 const int* start, const float* u,
                                 const float* uq, const int* seed, int* tours,
                                 float* lengths, int c, int a, float q0,
                                 int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || c > kMaxCities || a < 1 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TourArgs p{logits_t, dist_t, start, u, uq, seed, tours, lengths,
                   c, a, q0, mode};
  const dim3 grid((a + kWarpsPerBlock - 1) / kWarpsPerBlock);
  tours_kernel<<<grid, kWarpsPerBlock * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// tours_t [c, a] i32 (the tours transposed) and amount [a] f32 in, d [c, c]
// f32 out, contiguous on `device`; launched on `stream` without
// synchronising.  Returns the CUDA error of the launch.
extern "C" int dsa_aco_deposit_f32(const int* tours_t, const float* amount,
                                   float* d, int c, int a, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || c > kMaxCities || a < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  deposit_kernel<<<c, kDepositThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tours_t, amount, d, c, a);
  return static_cast<int>(cudaGetLastError());
}
