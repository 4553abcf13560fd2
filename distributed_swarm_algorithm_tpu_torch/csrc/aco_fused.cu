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
// Design.  Tours (first, simple version): one warp per ant, no block
// barrier.  Lane l holds the city blocks b = l + 32 k of four cities each, so
// one Philox call feeds its four cities and a warp reads a row's 4 x 32
// consecutive floats at once; its visited bits live in a 64-bit register
// (C <= 2,048).  The scores are read from transposed copies of logits and
// dist (the wrapper makes them), so the column select reads a row.  A lane
// scans its cities in ascending order keeping the first strict maximum; the
// lanes then reduce (value, city) pairs by shuffles, the lower city winning a
// tie.  Left to a later redesign: several ants a warp to hide the chain's
// latency.
//
// Deposit: a stable bucketing of the edges by row, then an ordered sum a
// row, two kernels a call.  A block a row that walked every tour would
// reread all A C tours (1 MB at C = 256) once a row, some 256 MB through L2
// a call; here the tours [A, C] are read once, where the model holds
// them, and no atomics touch D.  Both kernels
// rest on one block-level stable counting sort (stable_bucket): a
// histogram a warp, a scan over (key, warp), then each warp places its
// positions in order, so no atomics decide an order.  The bucketing kernel
// takes the flat edge sequence (ant, t) in chunks of deposit_chunk(C)
// edges, a block a chunk (256 blocks at C = 256, A = 1,024), stages the
// chunk's (cur, nxt) in shared memory with kBatch unconditional loads a
// thread in flight (loads behind a branch went out one at a time), sorts
// it by row, and writes each edge (nxt, amount) to its row's place in the
// chunk's region, with the chunk's row starts.  The fold kernel gives each
// row a block that gathers the row's edges chunk by chunk in chunk order
// (a block scan of the chunks' counts places them) into shared memory,
// kFoldWindow at a time, sorts them by column, and adds each column's
// amounts in that order, a thread a column.  So every cell sums its edges'
// amounts from 0 in (ant, t) order and equals the plain version bit for
// bit.  A column that takes most of a row's edges (a converged colony) is
// one thread's serial sum, as the order requires; ranking each edge among
// its column's edges instead would cost that column's count squared.
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
constexpr int kSortWarps = 4;      // a bucketing block
constexpr int kBatch = 8;          // edges a bucketing thread loads at once
constexpr int kFoldWarps = 8;      // a fold block
constexpr int kFoldWindow = 2048;  // edges staged a pass of the fold
constexpr int kCopyBatch = 4;      // edges a fold thread loads at once
constexpr int kSumBatch = 8;       // amounts a column's sum loads at once
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

// Edge e = ant * c + t of the flat [A, C] tours: (cur, nxt) = (tour[t],
// tour[(t + 1) mod c]) and the ant, read at min(e, last) so that every lane
// loads unconditionally (the loads of a batch then go out together); true
// where e <= last and both are cities.
__device__ __forceinline__ bool load_edge(const int* __restrict__ tours,
                                          unsigned c, unsigned e,
                                          unsigned last, int& cur, int& nxt,
                                          unsigned& ant) {
  const unsigned ec = min(e, last);
  ant = ec / c;
  const unsigned t = ec - ant * c;
  cur = __ldg(tours + ec);
  nxt = __ldg(tours + (t + 1 < c ? ec + 1 : ec + 1 - c));
  return (e <= last) & (static_cast<unsigned>(cur) < c)
         & (static_cast<unsigned>(nxt) < c);
}

// Exclusive prefix sum over a block of kWarps warps; returns the total.
template <int kWarps>
__device__ int block_scan(int* s_warp, int v, int& excl) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  int before = 0;
  int total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int x = s_warp[k];
    if (k < w) before += x;
    total += x;
  }
  excl = before + incl - v;
  __syncthreads();  // s_warp is reused by the next call
  return total;
}

// Stable counting sort of positions 0 .. m - 1 by key(p) in [0, n_keys)
// (-1: left out), by a block of kWarps warps: warp w takes the positions
// [w span, (w + 1) span) and counts its keys in its own histogram (hist:
// kWarps * n_keys ints of shared memory; shared atomics, since a count has
// no order); a scan over (key, warp) gives each warp its first slot a key
// (first: n_keys + 1 ints, a key's first slot, and the count of kept
// positions last); the warps then walk their positions again in steps of
// 32, in order, and call emit(p, slot), slot the rank of p among the
// positions of its key (the lanes of one step that share a key by
// __match_any_sync, lower lanes first).  Every thread of the block calls
// it.
template <int kWarps, class Key, class Emit>
__device__ void stable_bucket(int m, int n_keys, int* hist, int* first,
                              int* s_warp, Key key, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int span = (m + 32 * kWarps - 1) / (32 * kWarps) * 32;
  const int p0 = w * span;
  const int p1 = min(m, p0 + span);
  int* h = hist + w * n_keys;
  for (int i = threadIdx.x; i < kWarps * n_keys; i += 32 * kWarps) {
    hist[i] = 0;
  }
  __syncthreads();
  for (int p = p0 + lane; p < p1; p += 32) {
    const int k = key(p);
    if (k >= 0) atomicAdd(&h[k], 1);
  }
  __syncthreads();
  const int per = (n_keys + 32 * kWarps - 1) / (32 * kWarps);
  const int lo = min(n_keys, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n_keys, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) {
    for (int v = 0; v < kWarps; ++v) sum += hist[v * n_keys + k];
  }
  int base;
  const int total = block_scan<kWarps>(s_warp, sum, base);
  for (int k = lo; k < hi; ++k) {
    first[k] = base;
    for (int v = 0; v < kWarps; ++v) {
      const int n = hist[v * n_keys + k];
      hist[v * n_keys + k] = base;
      base += n;
    }
  }
  if (threadIdx.x == 0) first[n_keys] = total;
  __syncthreads();
  for (int pb = p0; pb < p0 + span; pb += 32) {
    const int p = pb + lane;
    const int k = p < p1 ? key(p) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0) emit(p, h[k] + __popc(peers & below));
    __syncwarp();
    if (k >= 0 && (peers & below) == 0) h[k] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

// Bucketing: a block of kSortWarps warps per chunk k of edges [k L,
// (k + 1) L) in (ant, t) order.  It stages the chunk's (cur, nxt) in shared
// memory with its amounts, kBatch loads a thread in flight at once, sorts
// the edges stably by row (stable_bucket), writes each edge (nxt, amount)
// to its row's place
// in the chunk's region of `edges` and the row starts to starts[k]
// [c + 1], the last the chunk's count of edges.
__global__ void __launch_bounds__(kSortWarps * 32)
deposit_bucket_kernel(const int* __restrict__ tours,
                      const float* __restrict__ amount,
                      int* __restrict__ starts, int2* __restrict__ edges,
                      int c, unsigned n_edges, int chunk) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  int2* s_edge = reinterpret_cast<int2*>(s_raw);          // [chunk]
  int* s_row_of = reinterpret_cast<int*>(s_edge + chunk);  // [chunk]
  int* s_hist = s_row_of + chunk;                         // [kSortWarps c]
  int* s_first = s_hist + kSortWarps * c;                 // [c + 1]
  __shared__ int s_warp[kSortWarps];
  const unsigned e0 = static_cast<unsigned>(blockIdx.x) * chunk;
  const unsigned last = min(n_edges, e0 + chunk) - 1;
  const int m = static_cast<int>(last - e0) + 1;
  for (int b = 0; b < m; b += kSortWarps * 32 * kBatch) {
    int cur[kBatch];
    int nxt[kBatch];
    float amt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned p = b + u * kSortWarps * 32 + threadIdx.x;
      unsigned ant;
      if (!load_edge(tours, c, e0 + p, last, cur[u], nxt[u], ant)) {
        cur[u] = -1;
      }
      amt[u] = __ldg(amount + ant);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = b + u * kSortWarps * 32 + threadIdx.x;
      if (p < m) {
        s_row_of[p] = cur[u];
        s_edge[p] = make_int2(nxt[u], __float_as_int(amt[u]));
      }
    }
  }
  int2* out = edges + e0;
  stable_bucket<kSortWarps>(
      m, c, s_hist, s_first, s_warp, [&](int p) { return s_row_of[p]; },
      [&](int p, int slot) { out[slot] = s_edge[p]; });
  int* st = starts + static_cast<size_t>(blockIdx.x) * (c + 1);
  for (int r = threadIdx.x; r <= c; r += kSortWarps * 32) st[r] = s_first[r];
}

// Dynamic shared memory of the two kernels.
__host__ __device__ inline int bucket_shared_bytes(int c, int chunk) {
  return chunk * (8 + 4) + (kSortWarps * c + c + 1) * 4;
}
__host__ __device__ inline int fold_shared_bytes(int c) {
  return kFoldWindow * (8 + 4) + (kFoldWarps * c + c + 1 + c) * 4;
}

// Fold: block `row` gathers the row's edges chunk by chunk (a block scan
// of the chunks' counts places them) into shared memory, kFoldWindow at a
// time, in (ant, t) order; sorts their amounts stably by column
// (stable_bucket), so that a column's lie together in order; and a thread
// a column adds them into the row.  The row is written once.
__global__ void __launch_bounds__(kFoldWarps * 32)
deposit_fold_kernel(const int* __restrict__ starts,
                    const int2* __restrict__ edges, float* __restrict__ d,
                    int c, int chunk, int n_chunks) {
  constexpr int kThreads = kFoldWarps * 32;
  extern __shared__ __align__(16) unsigned char s_raw[];
  int2* s_buf = reinterpret_cast<int2*>(s_raw);                  // [window]
  float* s_amt = reinterpret_cast<float*>(s_buf + kFoldWindow);  // [window]
  int* s_hist = reinterpret_cast<int*>(s_amt + kFoldWindow);     // [8 c]
  int* s_first = s_hist + kFoldWarps * c;                        // [c + 1]
  float* s_row = reinterpret_cast<float*>(s_first + c + 1);      // [c]
  __shared__ int s_warp[kFoldWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int col = tid; col < c; col += kThreads) s_row[col] = 0.0f;
  for (int k0 = 0; k0 < n_chunks; k0 += kThreads) {
    const int k = k0 + tid;
    int beg = 0;
    int cnt = 0;
    if (k < n_chunks) {
      const int* st = starts + static_cast<size_t>(k) * (c + 1) + row;
      beg = st[0];
      cnt = st[1] - beg;
    }
    int excl;
    const int total = block_scan<kFoldWarps>(s_warp, cnt, excl);
    const int2* src = edges + static_cast<size_t>(k) * chunk + beg - excl;
    for (int w0 = 0; w0 < total; w0 += kFoldWindow) {
      const int m = min(kFoldWindow, total - w0);
      const int top = min(excl + cnt, w0 + kFoldWindow);
      for (int p0 = max(excl, w0); p0 < top; p0 += kCopyBatch) {
        int2 v[kCopyBatch];
#pragma unroll
        for (int u = 0; u < kCopyBatch; ++u) v[u] = src[min(p0 + u, top - 1)];
#pragma unroll
        for (int u = 0; u < kCopyBatch; ++u) {
          if (p0 + u < top) s_buf[p0 + u - w0] = v[u];
        }
      }
      stable_bucket<kFoldWarps>(
          m, c, s_hist, s_first, s_warp, [&](int p) { return s_buf[p].x; },
          [&](int p, int slot) { s_amt[slot] = __int_as_float(s_buf[p].y); });
      for (int col = tid; col < c; col += kThreads) {
        float acc = s_row[col];
        const int end = s_first[col + 1];
        for (int x = s_first[col]; x < end; x += kSumBatch) {
          float a[kSumBatch];
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) a[u] = s_amt[min(x + u, end - 1)];
#pragma unroll
          for (int u = 0; u < kSumBatch; ++u) {
            if (x + u < end) acc = add(acc, a[u]);
          }
        }
        s_row[col] = acc;
      }
      __syncthreads();
    }
  }
  for (int col = tid; col < c; col += kThreads) {
    d[static_cast<size_t>(row) * c + col] = s_row[col];
  }
}

// Edges a bucketing chunk: four a city, at least 1,024, a multiple of 32.
__host__ __device__ inline int deposit_chunk(int c) {
  const int edges = (4 * c + 31) / 32 * 32;
  return edges > 1024 ? edges : 1024;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// be asked for).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024 - 64) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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

// The int32 scratch the deposit takes: every chunk's row starts, then
// every edge as (nxt, amount) (8-byte aligned).
extern "C" long long dsa_aco_deposit_scratch_ints(int c, int a) {
  const long long n_edges = static_cast<long long>(a) * c;
  const long long chunk = deposit_chunk(c);
  const long long starts = (n_edges + chunk - 1) / chunk * (c + 1);
  return starts + (starts & 1) + 2 * n_edges;
}

// tours [a, c] i32 and amount [a] f32 in, d [c, c] f32 out, scratch of
// dsa_aco_deposit_scratch_ints(c, a) int32, all contiguous on `device`;
// two kernels launched on `stream` without synchronising.  Returns the
// CUDA error of the launches.
extern "C" int dsa_aco_deposit_f32(const int* tours, const float* amount,
                                   float* d, int* scratch,
                                   long long scratch_ints, int c, int a,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || c > kMaxCities || a < 1
      || static_cast<long long>(a) * c >= (1ll << 31)
      || scratch_ints < dsa_aco_deposit_scratch_ints(c, a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned n_edges = static_cast<unsigned>(a) * c;
  const int chunk = deposit_chunk(c);
  const int n_chunks = static_cast<int>((n_edges + chunk - 1) / chunk);
  const long long n_starts = static_cast<long long>(n_chunks) * (c + 1);
  int2* edges = reinterpret_cast<int2*>(scratch + n_starts + (n_starts & 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bucket_bytes = bucket_shared_bytes(c, chunk);
  err = allow_shared(deposit_bucket_kernel, bucket_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  deposit_bucket_kernel<<<n_chunks, kSortWarps * 32, bucket_bytes, s>>>(
      tours, amount, scratch, edges, c, n_edges, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fold_bytes = fold_shared_bytes(c);
  err = allow_shared(deposit_fold_kernel, fold_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  deposit_fold_kernel<<<c, kFoldWarps * 32, fold_bytes, s>>>(
      scratch, edges, d, c, chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
