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
// peel is a chain of one round a front, each a barrier on one SM.
//
// Design (two kernels a call, both on the caller's stream):
// 1. pack: the domination as bits, word w of column i holding the j of
//    32w..32w+31 that dominate i, at bits[w * p_pad + i] (neighbouring i on
//    neighbouring words, so the peel's reads of one word by a warp hit 32
//    banks).  A thread computes one word: its i from objs (read in [M, P]
//    layout, coalesced) against the 32 j of its block's word, read as
//    broadcasts.  P^2 / 8 bytes: 128 KB at P = 1,024.
// 2. peel: one block of up to 1,024 threads.  The unassigned set is W =
//    p_pad / 32 words in shared memory, in two buffers (read one, write the
//    other).  A thread owns i = tid, tid + blockDim, ...; an owned
//    unassigned i joins the front when no word of bits[., i] & unassigned
//    is non-zero.  A warp's 32 i are one word: its ballot of the joiners
//    clears them in the next buffer (no atomics), and __syncthreads_or of
//    "someone is left" ends each round and the loop.  The bits are copied
//    into shared memory while they fit (p_pad * W * 4 bytes, up to P ~
//    1,300); past that the peel reads them from global memory (L2).  The
//    loop stops after P rounds at the most (a strict order has at most P
//    fronts).
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
constexpr int kMaxSharedBytes = 232448;   // a block's dynamic shared memory

// 1 iff j dominates i.  objs is [m, p]; viol null means unconstrained.
__device__ __forceinline__ bool dominates(const float* __restrict__ objs,
                                          const float* __restrict__ viol,
                                          int p, int m, int j, int i,
                                          float feas_tol) {
  bool all_le = true;
  bool any_lt = false;
  for (int k = 0; k < m; ++k) {
    const float a = objs[static_cast<size_t>(k) * p + j];
    const float b = objs[static_cast<size_t>(k) * p + i];
    all_le = all_le && (a <= b);
    any_lt = any_lt || (a < b);
  }
  const bool pareto = all_le && any_lt;
  if (viol == nullptr) return pareto;
  const float vj = viol[j];
  const float vi = viol[i];
  const bool fj = vj <= feas_tol;
  const bool fi = vi <= feas_tol;
  return (fj && !fi) || (!fj && !fi && vj < vi) || (fj && fi && pareto);
}

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ objs, const float* __restrict__ viol,
            uint32_t* __restrict__ bits, int p, int p_pad, int m,
            float feas_tol) {
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  const int w = blockIdx.y;
  if (i >= p_pad) return;
  uint32_t word = 0;
  if (i < p) {
    const int j0 = w * 32;
    const int jn = min(32, p - j0);
    for (int b = 0; b < jn; ++b) {
      if (dominates(objs, viol, p, m, j0 + b, i, feas_tol)) word |= 1u << b;
    }
  }
  bits[static_cast<size_t>(w) * p_pad + i] = word;
}

template <bool kShared>
__global__ void __launch_bounds__(kPeelThreads)
peel_kernel(const uint32_t* __restrict__ bits, int p, int p_pad,
            int* __restrict__ rank, int* __restrict__ fronts) {
  extern __shared__ uint32_t smem[];
  const int n_words = p_pad / 32;
  const uint32_t* dom = bits;
  if constexpr (kShared) {
    uint32_t* staged = smem + 2 * n_words;
    const size_t total = static_cast<size_t>(n_words) * p_pad;
    for (size_t e = threadIdx.x; e < total; e += blockDim.x) {
      staged[e] = bits[e];
    }
    dom = staged;
  }
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    const int valid = min(32, p - 32 * w);
    smem[w] = valid >= 32 ? 0xffffffffu : ((1u << valid) - 1u);
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

// rank [p] int32 and fronts [1] int32 from objs [m, p] and viol [p] (or
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

  const int threads = p_pad < kPeelThreads ? p_pad : kPeelThreads;
  const size_t flags = 2 * sizeof(uint32_t) * n_words;
  const size_t staged = sizeof(uint32_t) * static_cast<size_t>(n_words) *
                        p_pad;
  const bool on_chip = flags + staged <= static_cast<size_t>(kMaxSharedBytes);
  if (flags > static_cast<size_t>(kMaxSharedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = static_cast<int>(on_chip ? flags + staged : flags);
  const void* peel = on_chip ? (const void*)peel_kernel<true>
                             : (const void*)peel_kernel<false>;
  err = cudaFuncSetAttribute(peel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (on_chip) {
    peel_kernel<true><<<1, threads, bytes, s>>>(bits, p, p_pad, rank, fronts);
  } else {
    peel_kernel<false><<<1, threads, bytes, s>>>(bits, p, p_pad, rank,
                                                 fronts);
  }
  return static_cast<int>(cudaGetLastError());
}
