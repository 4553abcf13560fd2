// NSGA-II's non-dominated ranks, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package ranks with a lax.while_loop of
// front peeling (distributed_swarm_algorithm_tpu/ops/nsga2.py:
// nondominated_ranks, the loop at :113), whose trip count is the number of
// fronts, which only the device knows.  In PyTorch that loop would read a
// flag on the host every round (a wait a front) or run P bounded rounds of
// small launches; this kernel runs the whole peel on the card.  It computes
// the same function:
//
//   j dominates i  = all_k objs[j, k] <= objs[i, k] and any_k objs[j, k] < objs[i, k]
//   constrained    = (f_j & !f_i) | (!f_j & !f_i & viol_j < viol_i) | (f_j & f_i & pareto)
//                    with f = viol <= feas_tol
//   rank[i]        = the round in which no unassigned j dominates i
//
// Bound on this card: operations, P^2 M comparisons, about 30 ns at P =
// 1,024, M = 2; the bytes are a few KB.  Neither bounds it in practice: the
// peel is a chain of one round a front, each a barrier on one SM, so its
// cost is a fixed part and a cost a front.
//
// Design (two kernels a call, both on the caller's stream):
// 1. pack: the domination as bits, word w of column i holding the j of
//    32w..32w+31 that dominate i, at bits[w * p_pad + i] (neighbouring i on
//    neighbouring words, so a warp's loads of one word are coalesced).  A
//    block takes one word w and 256 i: it stages the objectives (64 at a
//    time) and the violations of its 32 j in shared memory once, and a
//    thread reads its i's M objectives once from objs as the caller holds
//    it ([P, M]), then builds the word as 32-bit masks: all <= and any <
//    over k, then the feasibility rules.  P^2 / 8 bytes: 128 KB at P = 1,024.
// 2. peel, one block.  Up to P = 1,024 (the register peel, p_pad threads):
//    thread i holds its column's W <= 32 words in registers, loaded once.
//    The unassigned set is W words in shared memory, in two buffers (read
//    one, write the other).  A round reads the set as eight 16-byte
//    broadcasts and ORs the 32 ANDs of the column against it, with no early
//    exit; an unassigned i with no hit joins the front.  A warp's 32 i are
//    one word: its ballot of the joiners clears them in the next buffer (no
//    atomics), and __syncthreads_or of "someone is left" ends the round and
//    the loop.  One column a thread beat two or four (fewer warps, longer
//    chains of ANDs each).  Past P = 1,024 (the staged peel, the first
//    version): a thread owns i = tid, tid + 1,024, ... and scans its column
//    from shared memory while the bits fit (p_pad * W * 4 bytes, up to P ~
//    1,300), else from global memory (L2).  Either loop stops after P rounds
//    at the most (a strict order has at most P fronts).
//    The peel is an ordinary launch after the pack.  As a programmatic
//    dependent (griddepcontrol.wait before its loads) it gained nothing
//    without a trigger in the pack, and with the pack's trigger at its
//    start it gave wrong ranks once captured into a CUDA graph, which is
//    where NSGA-II's generation runs.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/nsga2_ranks.py).
// Comparisons only, so the kernel equals its plain version exactly (NaN
// compares false, -0 equals +0, as in PyTorch and XLA).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kPeelThreads = 1024;
constexpr int kRegisterWords = 32;        // the register peel: P <= 1,024
constexpr int kMaxSharedBytes = 232448;   // a block's dynamic shared memory
constexpr int kPackChunk = 64;            // objectives the pack stages at once

// The mask of the valid bits of word w of P points.
__device__ __forceinline__ uint32_t valid_bits(int p, int w) {
  const int valid = p - 32 * w;
  return valid >= 32 ? 0xffffffffu : valid > 0 ? (1u << valid) - 1u : 0u;
}

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ objs, const float* __restrict__ viol,
            uint32_t* __restrict__ bits, int p, int p_pad, int m,
            float feas_tol) {
  __shared__ float sj[kPackChunk * 32];   // [k][32]: the block's j, a chunk
  __shared__ float sv[32];                // the violations of the block's j
  const int w = blockIdx.y;
  const int j0 = w * 32;
  const int jn = min(32, p - j0);
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  if (viol != nullptr && threadIdx.x < 32) {
    sv[threadIdx.x] = threadIdx.x < jn ? viol[j0 + threadIdx.x] : 0.0f;
  }
  uint32_t all_le = 0xffffffffu;
  uint32_t any_lt = 0u;
  for (int k0 = 0; k0 < m; k0 += kPackChunk) {
    const int kn = min(kPackChunk, m - k0);
    __syncthreads();   // the last chunk is read
    for (int e = threadIdx.x; e < 32 * kn; e += kPackThreads) {
      const int b = e / kn;
      const int k = e - b * kn;
      sj[k * 32 + b] =
          b < jn ? objs[static_cast<size_t>(j0 + b) * m + k0 + k] : 0.0f;
    }
    __syncthreads();
    if (i < p) {
      for (int k = 0; k < kn; ++k) {
        const float b = objs[static_cast<size_t>(i) * m + k0 + k];
        const float* a = sj + k * 32;
        uint32_t le = 0u;
        uint32_t lt = 0u;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          le |= static_cast<uint32_t>(a[q] <= b) << q;
          lt |= static_cast<uint32_t>(a[q] < b) << q;
        }
        all_le &= le;
        any_lt |= lt;
      }
    }
  }
  if (i >= p_pad) return;
  uint32_t word = 0;
  if (i < p) {
    word = all_le & any_lt;
    if (viol != nullptr) {
      const float vi = viol[i];
      uint32_t feas = 0u;
      uint32_t less = 0u;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        feas |= static_cast<uint32_t>(sv[q] <= feas_tol) << q;
        less |= static_cast<uint32_t>(sv[q] < vi) << q;
      }
      word = vi <= feas_tol ? (feas & word) : (feas | less);
    }
    word &= valid_bits(p, w);
  }
  bits[static_cast<size_t>(w) * p_pad + i] = word;
}

// P <= 1,024: one block of p_pad threads, thread i holding column i.
__global__ void __launch_bounds__(kPeelThreads)
peel_registers_kernel(const uint32_t* __restrict__ bits, int p, int p_pad,
                      int* __restrict__ rank, int* __restrict__ fronts) {
  __shared__ __align__(16) uint32_t left[2][kRegisterWords];
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int wi = i >> 5;
  const int n_words = p_pad / 32;
  if (i < kRegisterWords) {
    left[0][i] = valid_bits(p, i);   // 0 past the last word
    left[1][i] = 0u;
  }
  uint32_t col[kRegisterWords];
#pragma unroll
  for (int w = 0; w < kRegisterWords; ++w) {
    col[w] = w < n_words ? bits[static_cast<size_t>(w) * p_pad + i] : 0u;
  }
  __syncthreads();

  int my_rank = -1;
  int cur = 0;
  int front = 0;
  bool more = true;
  while (more && front < p) {
    const uint32_t mine = left[cur][wi];
    bool joins = false;
    if ((mine >> lane) & 1u) {
      const uint4* set = reinterpret_cast<const uint4*>(left[cur]);
      uint32_t hit = 0u;
#pragma unroll
      for (int q = 0; q < kRegisterWords / 4; ++q) {
        const uint4 s = set[q];
        hit |= (col[4 * q] & s.x) | (col[4 * q + 1] & s.y) |
               (col[4 * q + 2] & s.z) | (col[4 * q + 3] & s.w);
      }
      joins = hit == 0u;
      if (joins) my_rank = front;
    }
    const uint32_t next = mine & ~__ballot_sync(0xffffffffu, joins);
    if (lane == 0) left[cur ^ 1][wi] = next;
    more = __syncthreads_or(lane == 0 && next != 0u);
    cur ^= 1;
    ++front;
  }
  if (i < p) rank[i] = my_rank;
  if (i == 0) *fronts = front;
}

// P > 1,024: the first version's peel, the bits staged in shared memory
// while they fit, else read from global memory.
template <bool kShared>
__global__ void __launch_bounds__(kPeelThreads)
peel_staged_kernel(const uint32_t* __restrict__ bits, int p, int p_pad,
                   int* __restrict__ rank, int* __restrict__ fronts) {
  extern __shared__ uint32_t smem[];
  const int n_words = p_pad / 32;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    smem[w] = valid_bits(p, w);
  }
  const uint32_t* dom = bits;
  if constexpr (kShared) {
    uint32_t* staged = smem + 2 * n_words;
    const size_t total = static_cast<size_t>(n_words) * p_pad;
    for (size_t e = threadIdx.x; e < total; e += blockDim.x) {
      staged[e] = bits[e];
    }
    dom = staged;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp_base = threadIdx.x & ~31;
  int cur = 0;
  int front = 0;
  bool more = true;
  while (more && front < p) {
    const uint32_t* left = smem + cur * n_words;
    uint32_t* next_left = smem + (cur ^ 1) * n_words;
    bool remaining = false;
    for (int base = 0; base + warp_base < p_pad; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const int wi = i >> 5;
      const uint32_t mine = left[wi];
      bool joins = false;
      if ((mine >> lane) & 1u) {
        uint32_t hit = 0;
        for (int w = 0; w < n_words && hit == 0; ++w) {
          hit = dom[static_cast<size_t>(w) * p_pad + i] & left[w];
        }
        joins = hit == 0;
        if (joins) rank[i] = front;
      }
      const uint32_t joined = __ballot_sync(0xffffffffu, joins);
      if (lane == 0) {
        const uint32_t next = mine & ~joined;
        next_left[wi] = next;
        remaining = remaining || next != 0;
      }
    }
    more = __syncthreads_or(remaining);
    cur ^= 1;
    ++front;
  }
  if (threadIdx.x == 0) *fronts = front;
}

}  // namespace

// rank [p] int32 and fronts [1] int32 from objs [p, m] and viol [p] (or
// null); bits is scratch of ceil(p / 32) * p_pad words.
extern "C" int dsa_nsga2_ranks_f32(const float* objs, const float* viol,
                                   int* rank, int* fronts, uint32_t* bits,
                                   int p, int m, float feas_tol, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int p_pad = (p + 31) / 32 * 32;
  const int n_words = p_pad / 32;
  if (n_words > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((p_pad + kPackThreads - 1) / kPackThreads, n_words);
  pack_kernel<<<grid, kPackThreads, 0, s>>>(objs, viol, bits, p, p_pad, m,
                                            feas_tol);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (n_words <= kRegisterWords) {
    peel_registers_kernel<<<1, p_pad, 0, s>>>(bits, p, p_pad, rank, fronts);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t flags = 2 * sizeof(uint32_t) * n_words;
  const size_t staged = sizeof(uint32_t) * static_cast<size_t>(n_words) *
                        p_pad;
  const bool on_chip = flags + staged <= static_cast<size_t>(kMaxSharedBytes);
  if (flags > static_cast<size_t>(kMaxSharedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = on_chip ? flags + staged : flags;
  const void* peel = on_chip ? (const void*)peel_staged_kernel<true>
                             : (const void*)peel_staged_kernel<false>;
  err = cudaFuncSetAttribute(peel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (on_chip) {
    peel_staged_kernel<true><<<1, kPeelThreads, bytes, s>>>(bits, p, p_pad,
                                                            rank, fronts);
  } else {
    peel_staged_kernel<false><<<1, kPeelThreads, bytes, s>>>(bits, p, p_pad,
                                                             rank, fronts);
  }
  return static_cast<int>(cudaGetLastError());
}
