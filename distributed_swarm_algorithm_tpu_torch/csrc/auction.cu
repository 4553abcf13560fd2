// The auction's bidding loop (kernel N2), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs Bertsekas' forward auction
// as a lax.while_loop of Jacobi bidding rounds
// (distributed_swarm_algorithm_tpu/ops/auction.py: _auction_square, the
// loop at :148 around _auction_round :89-129), whose trip count (the
// rounds until every agent is seated, or max_rounds) only the device
// knows.  In PyTorch that loop would read a flag on the host every round
// (hundreds of waits a solve) and could not be captured into the CUDA
// graphs the swarm's rollouts replay; this kernel runs the whole loop on
// the card in one launch.  It computes the JAX round exactly:
//
//   v[i, j]    = values[i, j] - prices[j]
//   w1, j1     = max_j v[i, j] and its lowest index;  w2 = max_{j != j1}
//                (w1 where no second column exists, S = 1)
//   bid[i]     = (prices[j1] + (w1 - w2)) + eps, for unseated agents only
//   task t     takes its highest bid, ties to the lowest agent id, evicts
//              its previous owner, and its price becomes that bid
//   rounds     + 1 a round, while an agent is unseated and rounds < max
//
// Only additions, subtractions and maxima: the kernel equals its plain
// version (ops/cuda/auction.py: auction_square_plain) bit for bit, prices
// included.
//
// Bound on this card: the bytes of the value rows the bidders read, S * 4
// bytes a bidder a round (from HBM, or L2 where [S, S] fits its 50 MB);
// the rest (prices, seats) is a few KB a round.
//
// Design (one block of up to 1,024 threads, one launch a solve):
// - the per-task state lives in shared memory while it fits (24 bytes a
//   task: a 64-bit bid key, the price, both seat maps and the bidder list;
//   S <= ~9,680), else in a global scratch of the same layout (L2);
// - a round: each warp takes bidders k, k + warps, ... from the list; its
//   lanes read the row in float4 loads, four in flight, each lane keeping
//   (best, its index, second best); a butterfly of shuffles merges them
//   (the lowest index among equal maxima, the second best excluding only
//   that column: JAX's argmax and masked max); lane 0 packs (bid, agent)
//   into a 64-bit key, the bid's order-preserving bits above INT_MAX - id,
//   and takes its task's atomicMax in shared memory.  A maximum is the
//   same in any order, so the result is deterministic (the only atomics of
//   the port's kernels; none sums);
// - a barrier; each task with a key seats its winner and evicts its
//   previous owner (disjoint agents: a winner bid, so it was unseated);
// - a barrier; the unseated agents are listed again in agent order (a
//   ballot count a warp, a prefix across the warps, a ballot write), and
//   the loop stops when the list is empty or the round cap is reached.
// The `run` flag (a bool on the device) skips the loop: zero rounds, every
// agent unseated, the prices as given.  This lets the swarm's tick launch
// N2 every tick and decide on the device whether to re-solve.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/auction.py).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSharedBytes = 232448;   // a block's dynamic shared memory
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving bits of a float (-0 taken as +0, so equal bids tie).
__device__ __forceinline__ uint32_t order_bits(float f) {
  uint32_t b = __float_as_uint(f);
  if ((b & 0x7fffffffu) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The best value of a set, its lowest index, and the best of the rest.
struct Top2 {
  float m1;
  int i1;
  float m2;
};

// Add element (v, j); a lane adds its elements in increasing j, so an
// equal value never displaces the earlier index.
__device__ __forceinline__ void push(Top2& t, float v, int j) {
  if (v > t.m1) {
    t.m2 = fmaxf(t.m2, t.m1);
    t.m1 = v;
    t.i1 = j;
  } else {
    t.m2 = fmaxf(t.m2, v);
  }
}

// The union of two disjoint sets (symmetric, so a butterfly leaves every
// lane with the same result).
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_first = a.m1 > b.m1 || (a.m1 == b.m1 && a.i1 < b.i1);
  Top2 r;
  r.m1 = a_first ? a.m1 : b.m1;
  r.i1 = a_first ? a.i1 : b.i1;
  r.m2 = a_first ? fmaxf(a.m2, b.m1) : fmaxf(b.m2, a.m1);
  return r;
}

__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.m1 = __shfl_xor_sync(kFull, t.m1, off);
    o.i1 = __shfl_xor_sync(kFull, t.i1, off);
    o.m2 = __shfl_xor_sync(kFull, t.m2, off);
    t = merge(t, o);
  }
  return t;
}

// The per-task state, 24 bytes a slot: key (8), price, agent_task,
// task_agent, bidder list (4 each), then one count a warp.
__host__ __device__ __forceinline__ int pad4(int s) { return (s + 3) & ~3; }

__host__ __device__ __forceinline__ size_t state_bytes(int s) {
  return static_cast<size_t>(pad4(s)) * 24 + kMaxThreads / 32 * 4;
}

// One row's (w1, j1, w2) by one warp: float4 loads, four in flight.
template <bool kVec>
__device__ __forceinline__ Top2 row_top2(const float* __restrict__ row,
                                         const float* prices, int s,
                                         int lane) {
  Top2 t{-INFINITY, kIntMax, -INFINITY};
  if constexpr (kVec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(prices);
    const int n4 = s >> 2;
    int j4 = lane;
    for (; j4 + 96 < n4; j4 += 128) {
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = __ldg(r4 + j4 + 32 * u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 p = p4[j4 + 32 * u];
        const int j = 4 * (j4 + 32 * u);
        push(t, __fsub_rn(a[u].x, p.x), j);
        push(t, __fsub_rn(a[u].y, p.y), j + 1);
        push(t, __fsub_rn(a[u].z, p.z), j + 2);
        push(t, __fsub_rn(a[u].w, p.w), j + 3);
      }
    }
    for (; j4 < n4; j4 += 32) {
      const float4 a = __ldg(r4 + j4);
      const float4 p = p4[j4];
      const int j = 4 * j4;
      push(t, __fsub_rn(a.x, p.x), j);
      push(t, __fsub_rn(a.y, p.y), j + 1);
      push(t, __fsub_rn(a.z, p.z), j + 2);
      push(t, __fsub_rn(a.w, p.w), j + 3);
    }
  } else {
    for (int j = lane; j < s; j += 32) {
      push(t, __fsub_rn(__ldg(row + j), prices[j]), j);
    }
  }
  return warp_top2(t);
}

template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
auction_kernel(const float* __restrict__ values,
               const float* __restrict__ prices_in,
               const float* __restrict__ eps_ptr,
               const uint8_t* __restrict__ run_ptr,
               int* __restrict__ agent_task_out,
               int* __restrict__ task_agent_out,
               float* __restrict__ prices_out, int* __restrict__ rounds_out,
               unsigned char* __restrict__ scratch, int s, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = kShared ? smem : scratch;
  const int sp = pad4(s);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(base);
  float* prices = reinterpret_cast<float*>(base + 8 * static_cast<size_t>(sp));
  int* agent_task = reinterpret_cast<int*>(prices + sp);
  int* task_agent = agent_task + sp;
  int* bidders = task_agent + sp;
  int* warp_count = bidders + sp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool run = *run_ptr != 0;
  const float eps = *eps_ptr;

  for (int i = tid; i < sp; i += blockDim.x) {
    key[i] = 0ull;
    prices[i] = i < s ? prices_in[i] : 0.0f;
    agent_task[i] = -1;
    task_agent[i] = -1;
    bidders[i] = i;
  }
  __syncthreads();

  int n_bidders = run ? s : 0;
  int rounds = 0;
  while (n_bidders > 0 && rounds < max_rounds) {
    // 1. bids: a warp a bidder, lane 0 takes the task's maximum key.
    for (int k = warp; k < n_bidders; k += n_warps) {
      const int i = bidders[k];
      const Top2 t = row_top2<kVec>(values + static_cast<size_t>(i) * s,
                                    prices, s, lane);
      if (lane == 0) {
        const float w2 = isfinite(t.m2) ? t.m2 : t.m1;   // S == 1
        const float bid =
            __fadd_rn(__fadd_rn(prices[t.i1], __fsub_rn(t.m1, w2)), eps);
        const unsigned long long packed =
            (static_cast<unsigned long long>(order_bits(bid)) << 32) |
            static_cast<uint32_t>(kIntMax - i);
        atomicMax(key + t.i1, packed);
      }
    }
    __syncthreads();
    // 2. each task with a bid seats its winner and evicts its owner.
    for (int j = tid; j < s; j += blockDim.x) {
      const unsigned long long k = key[j];
      if (k != 0ull) {
        const int winner = kIntMax - static_cast<int>(
                                         static_cast<uint32_t>(k));
        const int prev = task_agent[j];
        if (prev >= 0) agent_task[prev] = -1;
        agent_task[winner] = j;
        task_agent[j] = winner;
        prices[j] = from_order_bits(static_cast<uint32_t>(k >> 32));
        key[j] = 0ull;
      }
    }
    __syncthreads();
    ++rounds;
    // 3. the unseated agents, listed in agent order: warp w owns the
    //    pieces of 32 agents w, w + warps, ...
    int count = 0;
    for (int p = warp; p * 32 < s; p += n_warps) {
      const int i = p * 32 + lane;
      count += __popc(__ballot_sync(kFull, i < s && agent_task[i] < 0));
    }
    if (lane == 0) warp_count[warp] = count;
    __syncthreads();
    const int c = lane < n_warps ? warp_count[lane] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    n_bidders = __shfl_sync(kFull, incl, 31);
    int offset = __shfl_sync(kFull, incl - c, warp);
    for (int p = warp; p * 32 < s; p += n_warps) {
      const int i = p * 32 + lane;
      const unsigned ballot =
          __ballot_sync(kFull, i < s && agent_task[i] < 0);
      if ((ballot >> lane) & 1u) {
        bidders[offset + __popc(ballot & ((1u << lane) - 1u))] = i;
      }
      offset += __popc(ballot);
    }
    __syncthreads();
  }

  for (int i = tid; i < s; i += blockDim.x) {
    agent_task_out[i] = agent_task[i];
    task_agent_out[i] = task_agent[i];
    prices_out[i] = prices[i];
  }
  if (tid == 0) *rounds_out = rounds;
}

template <bool kShared>
cudaError_t launch(bool vec, int threads, size_t bytes, cudaStream_t st,
                   const float* values, const float* prices_in,
                   const float* eps, const uint8_t* run, int* agent_task,
                   int* task_agent, float* prices_out, int* rounds,
                   unsigned char* scratch, int s, int max_rounds) {
  const void* fn = vec ? (const void*)auction_kernel<kShared, true>
                       : (const void*)auction_kernel<kShared, false>;
  const int dyn = kShared ? static_cast<int>(bytes) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  if (vec) {
    auction_kernel<kShared, true><<<1, threads, dyn, st>>>(
        values, prices_in, eps, run, agent_task, task_agent, prices_out,
        rounds, scratch, s, max_rounds);
  } else {
    auction_kernel<kShared, false><<<1, threads, dyn, st>>>(
        values, prices_in, eps, run, agent_task, task_agent, prices_out,
        rounds, scratch, s, max_rounds);
  }
  return cudaGetLastError();
}

}  // namespace

// Bytes of the per-task state for S tasks: in shared memory up to the
// block's budget, else the global scratch the caller passes.
extern "C" long long dsa_auction_state_bytes(int s) {
  return static_cast<long long>(state_bytes(s));
}

extern "C" int dsa_auction_state_in_shared(int s) {
  return state_bytes(s) <= static_cast<size_t>(kMaxSharedBytes) ? 1 : 0;
}

// agent_task, task_agent [S] int32, prices_out [S] float32 and rounds [1]
// int32 from values [S, S] float32 (row i: agent i), prices_in [S], eps
// and run (one float32, one bool on the device).  scratch: the state's
// bytes where they do not fit in shared memory, else unused.
extern "C" int dsa_auction_f32(const float* values, const float* prices_in,
                               const float* eps, const uint8_t* run,
                               int* agent_task, int* task_agent,
                               float* prices_out, int* rounds, void* scratch,
                               int s, int max_rounds, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = state_bytes(s);
  const bool in_shared = bytes <= static_cast<size_t>(kMaxSharedBytes);
  if (!in_shared && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = s >= kMaxThreads ? kMaxThreads : (s + 31) / 32 * 32;
  const bool vec = (s & 3) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* scr = static_cast<unsigned char*>(scratch);
  err = in_shared
            ? launch<true>(vec, threads, bytes, st, values, prices_in, eps,
                           run, agent_task, task_agent, prices_out, rounds,
                           scr, s, max_rounds)
            : launch<false>(vec, threads, bytes, st, values, prices_in, eps,
                            run, agent_task, task_agent, prices_out, rounds,
                            scr, s, max_rounds);
  return static_cast<int>(err);
}
