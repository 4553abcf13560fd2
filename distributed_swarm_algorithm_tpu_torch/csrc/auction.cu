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
// Bound on this card: the bytes the function needs, every value row once
// (round 1), then the rows of the unseated agents whose row is not all zero,
// and one price vector a round; at the protocol tick's shape the chain of
// dependent rounds (1,321 at 4,096 x 4,096) sets the floor, not the bytes.
//
// Design (the redesign of the first version, which ran every unseated
// agent's row every round on one block):
// - Zero rows bid once a round.  A row whose values are all +-0 (an agent
//   with no feasible task, or a virtual one) nets -prices[j]: every such
//   unseated agent bids the same amount for the same task, so only the
//   lowest of them can win it.  Round 1 reads every row and flags the zero
//   rows; after it, a round's bidders are the unseated agents with a real
//   row plus the lowest unseated zero-row agent, which bids from the prices
//   alone (no row read): the top two of 0 - prices, merged from the 16
//   warps' price segments, each recomputed only where a seat changed a
//   price in it.  The bids, prices, rounds and seats are JAX's: the other
//   zero-row bids would lose to that one under the same tie rule.
// - A round's bidders spread over a thread-block cluster of C = 16 blocks
//   of 512 threads (kCluster: of clusters of 1, 2, 4, 8 and 16 blocks, 16
//   was the fastest on the H100 at the protocol tick's re-solve and at
//   bench_auction.py's instances; 1,024 threads held 64 registers each and
//   spilled).  Every block keeps a replica of the prices, both seat maps,
//   the zero rows as S/32-word bitmasks and the list of real bidders;
//   bidder k (in agent order, the zero-row one last) goes to block k mod
//   C.  A block splits each of its bidders' rows over the warps its share
//   leaves idle, as many as read the row in one
//   wave of loads (4 at S = 4,096; a warp a row where fewer than two
//   remain), the partial top-twos merged by warp maxima, and finds its k-th
//   bidder in the bidder list the warps rebuild with the words (a slot
//   range a warp, found by a ballot over the warps' counts).
// - A bid packs (the bid's order-preserving bits, INT_MAX - agent) into 64
//   bits; a task takes the maximum key, an atomicMax in shared memory: a
//   maximum is the same in any order, so the result is deterministic (the
//   only atomics of the port's kernels; none sums).  The bid whose atomicMax
//   found the key empty lists the task, so only those tasks are seated.
// - Each block writes its bids into its own list (two, by round parity);
//   one cluster barrier a round, then every block reads every bid of the
//   round (through distributed shared memory) and takes each key's
//   atomicMax in its own shared memory, so every replica seats the same
//   winners and the replicas stay equal.  (A 64-bit atomicMax in shared
//   memory compiles to a compare-and-swap loop on this card: on another
//   block's shared memory, beside that block's own atomics on the same key,
//   it lost updates.)  Then three block barriers: the keys taken, the
//   seats, and the rebuild of the unseated (below).  A round's bookkeeping
//   runs only where a seat changed: the unseated words and the bidder list
//   of a warp's agents, the top two of a warp's prices.
// - The per-block state lives in shared memory while it fits (S <= 7,792
//   at 16 blocks); past that the entry launches one block (C = 1) with the
//   state in a global scratch of the same layout (L2).  The entry chooses
//   between the two (dsa_auction_cluster); the caller chooses nothing.
// The `run` flag (a bool on the device) skips the loop: zero rounds, every
// agent unseated, the prices as given.  This lets the swarm's tick launch
// N2 every tick and decide on the device whether to re-solve.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/auction.py).
// The entry launches with cudaLaunchKernelEx and a cluster dimension,
// after cudaOccupancyMaxActiveClusters has shown that the cluster can be
// resident; a refusal is returned, never bypassed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;    // 128 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448 - 1024;   // beside the static arrays
constexpr int kCluster = 16;      // the blocks of a cluster (see below)
constexpr int kDevices = 16;   // devices whose residency checks are kept
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving bits of a float (-0 taken as +0, so equal values tie).
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

// The union of the lanes' disjoint sets, in every lane, by three warp
// maxima of order-preserving bits: the best value; among the lanes holding
// it, the lowest index (the largest ~index); and the best of every lane's
// second and the other lanes' best.  A zero comes back as +0, which
// changes no bid: a margin or price of +-0 is followed by + eps.
__device__ __forceinline__ Top2 warp_top2(const Top2& t) {
  const uint32_t h = order_bits(t.m1);
  const uint32_t h_max = __reduce_max_sync(kFull, h);
  const uint32_t lo = h == h_max ? ~static_cast<uint32_t>(t.i1) : 0u;
  const uint32_t lo_max = __reduce_max_sync(kFull, lo);
  const uint32_t h2 = order_bits(t.m2);
  const bool best = h == h_max && lo == lo_max;
  const uint32_t second =
      __reduce_max_sync(kFull, best ? h2 : (h2 > h ? h2 : h));
  return Top2{from_order_bits(h_max), static_cast<int>(~lo_max),
              from_order_bits(second)};
}

__device__ __forceinline__ uint32_t mag(float f) {
  return __float_as_uint(f) & 0x7fffffffu;
}

// Four elements j .. j + 3 of a row (a: the values, p: the prices); nz
// gathers whether any value is non-zero.
__device__ __forceinline__ void push4(Top2& t, uint32_t& nz, const float4 a,
                                      const float4 p, int j) {
  nz |= mag(a.x) | mag(a.y) | mag(a.z) | mag(a.w);
  push(t, __fsub_rn(a.x, p.x), j);
  push(t, __fsub_rn(a.y, p.y), j + 1);
  push(t, __fsub_rn(a.z, p.z), j + 2);
  push(t, __fsub_rn(a.w, p.w), j + 3);
}

// A lane's share of one row's (w1, j1, w2): its elements start, start +
// stride, ... (float4 elements where kVec), kFlight float4 loads (or four
// floats) in flight.
template <bool kVec, int kFlight>
__device__ __forceinline__ void row_part(const float* __restrict__ row,
                                         const float* prices, int s,
                                         int start, int stride, Top2& t,
                                         uint32_t& nz) {
  if constexpr (kVec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(prices);
    const int n4 = s >> 2;
    int j4 = start;
    for (; j4 + (kFlight - 1) * stride < n4; j4 += kFlight * stride) {
      float4 a[kFlight];
#pragma unroll
      for (int u = 0; u < kFlight; ++u) a[u] = __ldg(r4 + j4 + u * stride);
#pragma unroll
      for (int u = 0; u < kFlight; ++u) {
        push4(t, nz, a[u], p4[j4 + u * stride], 4 * (j4 + u * stride));
      }
    }
    for (; j4 < n4; j4 += stride) {
      push4(t, nz, __ldg(r4 + j4), p4[j4], 4 * j4);
    }
  } else {
#pragma unroll 4
    for (int j = start; j < s; j += stride) {
      const float a = __ldg(row + j);
      nz |= mag(a);
      push(t, __fsub_rn(a, prices[j]), j);
    }
  }
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// The agent of real bidder k (the k-th unseated agent with a real row, in
// agent order), by the whole warp.  Lane l holds warp l's count of real
// bidders (seg_count) and their exclusive prefix (seg_excl); warp l lists
// its bidders in order from slot l * seg * 32 of blist.
__device__ __forceinline__ int kth_real(int k, int seg_excl, int seg_count,
                                        const int* blist, int seg) {
  const unsigned hit = __ballot_sync(
      kFull, seg_excl <= k && k < seg_excl + seg_count);
  const int ws = __ffs(hit) - 1;
  return blist[ws * seg * 32 + k - __shfl_sync(kFull, seg_excl, ws)];
}

__host__ __device__ __forceinline__ int pad4(int s) { return (s + 3) & ~3; }

// The per-block state, byte offsets: a key a task, the replicas (prices,
// agent_task, task_agent), the task each bid of the round found without a
// key (or -1), two lists by round parity of this block's bids (their keys
// and tasks), the list of real bidders, the zero-row words, and round 1's
// zero-row flags of this block's bidders.
struct Layout {
  int sp;   // S padded to 4
  int kc;   // ceil(S / C) padded to 4: a block's bidders in a round
  int w4;   // S / 32 words padded to 4
  size_t keys, prices, agent_task, task_agent, listed, bid_key, bid_task;
  size_t blist, zero_w, zflag, total;
};

__host__ __device__ __forceinline__ Layout layout(int s, int c) {
  Layout l;
  l.sp = pad4(s);
  l.kc = pad4((s + c - 1) / c);
  l.w4 = pad4((s + 31) / 32);
  const size_t n_bids = 2 * static_cast<size_t>(l.kc);
  size_t o = 0;
  l.keys = o;
  o += 8 * static_cast<size_t>(l.sp);
  l.bid_key = o;
  o += 8 * n_bids;
  l.prices = o;
  o += 4 * static_cast<size_t>(l.sp);
  l.agent_task = o;
  o += 4 * static_cast<size_t>(l.sp);
  l.task_agent = o;
  o += 4 * static_cast<size_t>(l.sp);
  l.listed = o;
  o += 4 * static_cast<size_t>(l.sp);
  l.bid_task = o;
  o += 4 * n_bids;
  l.blist = o;
  o += 4 * static_cast<size_t>(l.sp);
  l.zero_w = o;
  o += 4 * static_cast<size_t>(l.w4);
  l.zflag = o;
  o += static_cast<size_t>(l.kc);
  l.total = (o + 15) & ~static_cast<size_t>(15);
  return l;
}

struct Args {
  const float* values;       // [S, S], row i: agent i
  const float* prices_in;    // [S]
  const float* eps;          // one float
  const uint8_t* run;        // one bool
  int* agent_task_out;       // [S]
  int* task_agent_out;       // [S]
  float* prices_out;         // [S]
  int* rounds_out;           // one int
  unsigned char* scratch;    // the state where it is not in shared memory
  int s;
  int max_rounds;
};

// Pointer p of this block's state, in block `rank` of the cluster.
template <bool kShared, typename T>
__device__ __forceinline__ T* at_rank(cg::cluster_group& cluster, T* p,
                                      int rank, int own) {
  if constexpr (kShared) {
    return rank == own ? p : cluster.map_shared_rank(p, rank);
  } else {
    return p;   // one block
  }
}

// Bid m of this block, from agent `agent`'s top two, into the block's list
// of the round: its key (the bid's order-preserving bits above INT_MAX -
// agent) and its task j1.
__device__ __forceinline__ void post_bid(const Top2& t, int agent, float eps,
                                         const float* prices, int m,
                                         unsigned long long* bid_key,
                                         int* bid_task) {
  const float w2 = isfinite(t.m2) ? t.m2 : t.m1;   // S == 1: no margin
  const float bid =
      __fadd_rn(__fadd_rn(prices[t.i1], __fsub_rn(t.m1, w2)), eps);
  const unsigned long long packed =
      (static_cast<unsigned long long>(order_bits(bid)) << 32) |
      static_cast<uint32_t>(kIntMax - agent);
  bid_key[m] = packed;
  bid_task[m] = t.i1;
}

template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
auction_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part_m1[kWarps];
  __shared__ float part_m2[kWarps];
  __shared__ int part_i1[kWarps];
  __shared__ int part_nz[kWarps];
  __shared__ int part_agent[kWarps];
  __shared__ int warp_count[kWarps];
  __shared__ int warp_zmin[kWarps];
  // The top two of 0 - prices over warp w's price segment (tasks w tseg
  // ...), recomputed where a seat changed a price: the zero rows' bid.
  __shared__ float seg_m1[kWarps];
  __shared__ float seg_m2[kWarps];
  __shared__ int seg_i1[kWarps];
  __shared__ int seg_dirty[kWarps];
  // Whether warp w's agents (words w seg ...) hold one whose seat changed.
  __shared__ int agents_dirty[kWarps];

  // Eight float4 row loads in flight a lane; four where the state is in
  // global memory, whose addresses take more registers.
  constexpr int kFlight = kShared ? 8 : 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = a.s;
  const Layout L = layout(s, csize);
  unsigned char* base = kShared ? smem : a.scratch;
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(base + L.keys);
  float* prices = reinterpret_cast<float*>(base + L.prices);
  int* agent_task = reinterpret_cast<int*>(base + L.agent_task);
  int* task_agent = reinterpret_cast<int*>(base + L.task_agent);
  int* listed = reinterpret_cast<int*>(base + L.listed);
  unsigned long long* bid_key =
      reinterpret_cast<unsigned long long*>(base + L.bid_key);
  int* bid_task = reinterpret_cast<int*>(base + L.bid_task);
  uint32_t* zero_w = reinterpret_cast<uint32_t*>(base + L.zero_w);
  int* blist = reinterpret_cast<int*>(base + L.blist);
  unsigned char* zflag = base + L.zflag;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_words = (s + 31) >> 5;
  const int seg = (n_words + kWarps - 1) / kWarps;   // words a warp rebuilds
  const int tseg = pad4((s + kWarps - 1) / kWarps);  // its price segment
  const bool run = *a.run != 0;
  const float eps = *a.eps;

  for (int i = tid; i < L.sp; i += kThreads) {
    keys[i] = 0ull;
    prices[i] = i < s ? a.prices_in[i] : 0.0f;
    agent_task[i] = -1;
    task_agent[i] = -1;
  }
  if (tid < kWarps) seg_dirty[tid] = 1;
  cluster.sync();   // every block's state is set before a remote access

  // The census of the unseated, the same in every warp of the cluster.
  int seg_count = 0, seg_excl = 0, n_real = 0, zrep = -1;
  int rounds = 0;
  bool more = run && a.max_rounds > 0;
  while (more) {
    const bool round1 = rounds == 0;
    unsigned long long* my_key = bid_key + (rounds & 1) * L.kc;
    int* my_task = bid_task + (rounds & 1) * L.kc;
    // Bidders: every agent in round 1; then the real unseated ones in agent
    // order and the lowest unseated zero-row agent last.
    const int n_bid = round1 ? s : n_real + (zrep >= 0 ? 1 : 0);
    const int n_mine = n_bid > rank ? (n_bid - 1 - rank) / csize + 1 : 0;
    // The zero-row bidder (bidder n_real, after round 1) is its block's
    // last bid; the others read their rows.
    const bool has_z = !round1 && zrep >= 0 && n_real % csize == rank;
    const int n_rows = n_mine - (has_z ? 1 : 0);
    // Warps a row: enough to read it in one wave of loads, at most those
    // the round leaves idle (the last warp bids for the zero rows); below
    // two, a warp a row.
    const int wave = kVec ? (s / 4 + 32 * kFlight - 1) / (32 * kFlight)
                          : (s + 127) / 128;
    const int wpr = n_rows > 0 ? min(wave, (kWarps - 1) / n_rows) : 0;

    // 1. bids.  Bid m of this block is bidder k = rank + m C.
    if (has_z && warp == kWarps - 1) {
      // The zero rows' bid: the top two of 0 - prices, merged from the
      // warps' price segments (step 4 keeps them).
      const Top2 t =
          warp_top2(lane < kWarps
                        ? Top2{seg_m1[lane], seg_i1[lane], seg_m2[lane]}
                        : Top2{-INFINITY, kIntMax, -INFINITY});
      if (lane == 0) {
        post_bid(t, zrep, eps, prices, n_mine - 1, my_key, my_task);
      }
    }
    if (wpr >= 2) {
      // wpr warps a row, each a strided share; warp g merges bidder g's
      // partial top-twos and posts its bid.
      const int g = warp / wpr;
      const int wi = warp - g * wpr;
      if (g < n_rows) {
        const int k = rank + g * csize;
        const int agent = round1 ? k
                                 : kth_real(k, seg_excl, seg_count, blist,
                                            seg);
        Top2 t{-INFINITY, kIntMax, -INFINITY};
        uint32_t nz = 0u;
        row_part<kVec, kFlight>(a.values + static_cast<size_t>(agent) * s,
                                prices, s, wi * 32 + lane, 32 * wpr, t, nz);
        t = warp_top2(t);
        const bool any_nz = __any_sync(kFull, nz != 0u);
        if (lane == 0) {
          part_m1[warp] = t.m1;
          part_i1[warp] = t.i1;
          part_m2[warp] = t.m2;
          part_nz[warp] = any_nz ? 1 : 0;
          if (wi == 0) part_agent[g] = agent;
        }
      }
      __syncthreads();
      if (warp < n_rows) {
        Top2 t{-INFINITY, kIntMax, -INFINITY};
        int nz = 0;
        if (lane < wpr) {
          const int w = warp * wpr + lane;
          t = Top2{part_m1[w], part_i1[w], part_m2[w]};
          nz = part_nz[w];
        }
        t = warp_top2(t);
        const bool any_nz = __any_sync(kFull, nz != 0);
        if (lane == 0) {
          post_bid(t, part_agent[warp], eps, prices, warp, my_key, my_task);
          if (round1) zflag[warp] = any_nz ? 0 : 1;
        }
      }
    } else {
      // A warp a row.
      for (int m = warp; m < n_rows; m += kWarps) {
        const int k = rank + m * csize;
        const int agent = round1 ? k
                                 : kth_real(k, seg_excl, seg_count, blist,
                                            seg);
        Top2 t{-INFINITY, kIntMax, -INFINITY};
        uint32_t nz = 0u;
        row_part<kVec, kFlight>(a.values + static_cast<size_t>(agent) * s,
                                prices, s, lane, 32, t, nz);
        t = warp_top2(t);
        const bool any_nz = __any_sync(kFull, nz != 0u);
        if (lane == 0) {
          post_bid(t, agent, eps, prices, m, my_key, my_task);
          if (round1) zflag[m] = any_nz ? 0 : 1;
        }
      }
    }
    if (csize > 1) {
      cluster.sync();   // every block's bids are in its lists
    } else {
      __syncthreads();
    }
    // 2. every block takes every bid of the round into its own keys (bid k
    //    is in block k mod C's list); a block's keys see only its own
    //    atomics.  The bid that found its task's key empty lists the task.
    for (int k = tid; k < n_bid; k += kThreads) {
      const int src = k % csize;
      const int m = (rounds & 1) * L.kc + k / csize;
      const int j = *at_rank<kShared>(cluster, bid_task + m, src, rank);
      const unsigned long long key =
          *at_rank<kShared>(cluster, bid_key + m, src, rank);
      listed[k] = atomicMax(keys + j, key) == 0ull ? j : -1;
    }
    __syncthreads();

    // 3. each listed task seats its winner in the replica and evicts its
    //    previous owner (disjoint agents: a winner bid, so it was
    //    unseated); its key is cleared for the next round.
    for (int k = tid; k < n_bid; k += kThreads) {
      const int j = listed[k];
      if (j >= 0) {
        const unsigned long long key = keys[j];
        const int winner =
            kIntMax - static_cast<int>(static_cast<uint32_t>(key));
        const int prev = task_agent[j];
        if (prev >= 0) {
          agent_task[prev] = -1;
          agents_dirty[prev / (32 * seg)] = 1;
        }
        agents_dirty[winner / (32 * seg)] = 1;
        agent_task[winner] = j;
        task_agent[j] = winner;
        prices[j] = from_order_bits(static_cast<uint32_t>(key >> 32));
        seg_dirty[j / tseg] = 1;
        keys[j] = 0ull;
      }
    }
    __syncthreads();

    // 4. where a seat in them changed (every warp in round 1), warp w's
    //    agents by ballots over words w seg ... (round 1 also the zero-row
    //    words, from the flags of the blocks that read the rows): its real
    //    bidders listed in agent order from slot w seg 32, their count and
    //    its lowest unseated zero-row agent; and where a price in it
    //    changed, the top two of its price segment.
    if (round1 || agents_dirty[warp] != 0) {
      int count = 0;
      int zmin = kIntMax;
      const int q1 = min(n_words, (warp + 1) * seg);
      for (int q = warp * seg; q < q1; ++q) {
        const int i = 32 * q + lane;
        uint32_t zw;
        if (round1) {
          const bool zf =
              i < s && *(at_rank<kShared>(cluster, zflag, i % csize, rank) +
                         i / csize) != 0;
          zw = __ballot_sync(kFull, zf);
          if (lane == 0) zero_w[q] = zw;
        } else {
          zw = zero_w[q];
        }
        const uint32_t un = __ballot_sync(kFull, i < s && agent_task[i] < 0);
        const uint32_t real = un & ~zw;
        if ((real >> lane) & 1u) {
          blist[warp * seg * 32 + count + __popc(real & ((1u << lane) - 1u))] =
              i;
        }
        count += __popc(real);
        const uint32_t zu = un & zw;
        if (zmin == kIntMax && zu != 0u) zmin = 32 * q + __ffs(zu) - 1;
      }
      if (lane == 0) {
        warp_count[warp] = count;
        warp_zmin[warp] = zmin;
        agents_dirty[warp] = 0;
      }
    }
    if (seg_dirty[warp] != 0) {
      Top2 t{-INFINITY, kIntMax, -INFINITY};
      const int j1 = min(s, (warp + 1) * tseg);
      for (int j = warp * tseg + lane; j < j1; j += 32) {
        push(t, __fsub_rn(0.0f, prices[j]), j);
      }
      t = warp_top2(t);
      if (lane == 0) {
        seg_m1[warp] = t.m1;
        seg_i1[warp] = t.i1;
        seg_m2[warp] = t.m2;
        seg_dirty[warp] = 0;
      }
    }
    __syncthreads();
    ++rounds;
    seg_count = lane < kWarps ? warp_count[lane] : 0;
    const int incl = warp_inclusive_sum(seg_count, lane);
    seg_excl = incl - seg_count;
    n_real = __shfl_sync(kFull, incl, 31);
    const int zm =
        __reduce_min_sync(kFull, lane < kWarps ? warp_zmin[lane] : kIntMax);
    zrep = zm == kIntMax ? -1 : zm;
    more = (n_real > 0 || zrep >= 0) && rounds < a.max_rounds;
  }
  if (csize > 1) cluster.sync();   // no block leaves while another reads it

  if (rank == 0) {
    for (int i = tid; i < s; i += kThreads) {
      a.agent_task_out[i] = agent_task[i];
      a.task_agent_out[i] = task_agent[i];
      a.prices_out[i] = prices[i];
    }
    if (tid == 0) *a.rounds_out = rounds;
  }
}

template <bool kShared, bool kVec>
cudaError_t launch(const Args& a, int cluster, size_t bytes,
                   cudaStream_t st) {
  auto* kernel = auction_kernel<kShared, kVec>;
  const size_t dyn = kShared ? bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(cluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = dyn;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  // The residency check once a device and size (also while a stream
  // captures a CUDA graph, the launch's host time stays small).
  static size_t resident_bytes[kDevices] = {};   // checked bytes + 1
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices || resident_bytes[device] < dyn + 1) {
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorLaunchOutOfResources;
    if (device < kDevices && resident_bytes[device] < dyn + 1) {
      resident_bytes[device] = dyn + 1;
    }
  }
  err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool fits_shared(int s, int cluster) {
  return layout(s, cluster).total <= static_cast<size_t>(kMaxSharedBytes);
}

// The one schedule: a cluster of kCluster blocks where a block's replica
// of the state fits its shared memory, else one block on the scratch.
int cluster_for(int s) { return fits_shared(s, kCluster) ? kCluster : 1; }

}  // namespace

// Blocks of the cluster the entry launches for S tasks.
extern "C" int dsa_auction_cluster(int s) { return cluster_for(s); }

// Whether the state for S tasks lives in shared memory; where it does not,
// the caller passes a global scratch of dsa_auction_state_bytes(S) bytes.
extern "C" int dsa_auction_state_in_shared(int s) {
  return fits_shared(s, cluster_for(s)) ? 1 : 0;
}

extern "C" long long dsa_auction_state_bytes(int s) {
  return static_cast<long long>(layout(s, cluster_for(s)).total);
}

// agent_task, task_agent [S] int32, prices_out [S] float32 and rounds [1]
// int32 from values [S, S] float32 (row i: agent i), prices_in [S], eps
// and run (one float32, one bool on the device), on the cluster
// dsa_auction_cluster(S) names.  scratch: the state's bytes where they do
// not fit in shared memory, else unused.
extern "C" int dsa_auction_f32(const float* values, const float* prices_in,
                               const float* eps, const uint8_t* run,
                               int* agent_task, int* task_agent,
                               float* prices_out, int* rounds, void* scratch,
                               int s, int max_rounds, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cluster = cluster_for(s);
  const Layout l = layout(s, cluster);
  const bool in_shared = fits_shared(s, cluster);
  if (!in_shared && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (s & 3) == 0;
  Args a{values,     prices_in, eps,
         run,        agent_task, task_agent,
         prices_out, rounds,    static_cast<unsigned char*>(scratch),
         s,          max_rounds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_shared) {
    err = vec ? launch<true, true>(a, cluster, l.total, st)
              : launch<true, false>(a, cluster, l.total, st);
  } else {
    err = vec ? launch<false, true>(a, cluster, l.total, st)
              : launch<false, false>(a, cluster, l.total, st);
  }
  return static_cast<int>(err);
}
