// Plan-native candidate sweep for the hashgrid protocol tick, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// candidate_sweep.py:candidate_sweep_pallas.  The operands are the plan's
// own tables: cand [C, W] (per cell, every live agent of its 3x3 stencil
// neighbourhood, padded with n) and recv [C, RK] (per cell, its own live
// agents, padded with n).  For each cell c and receiver a = recv[c, r] < n:
//
//   f_a = sum_w near * k / max(d, eps)^3 * (p_a - p_b),  b = cand[c, w]
//   near = b < n, b != a, d < ps,  d = sqrt(dx^2 + dy^2)
//
// with the select-form minimum image, at the current positions (a stale
// Verlet plan stays exact), written straight to the receiver's row of the
// output: an agent sits in at most one receiver slot, so no atomics.
//
// The plan builds every row as a prefix of valid entries followed by
// padding (hashgrid_plan._union_rows, _receiver_rows, and the partial
// refresh's rows alike), and the kernel relies on it: it reads a row's
// first chunks and counts the valid prefix with a ballot, reading further
// only past a full chunk, so a station swarm's rows (about 3 receivers of
// 48 and 28 candidates of 128 at g = 146) cost a chunk of receivers and
// two of candidates instead of the whole padded rows.
//
// Design: a block of one warp owns G consecutive cells (G = 6 at W = 128,
// fewer for wider rows so that its staging stays within 12 KB; the
// wrapper passes G, at most 6).  Round 1 loads the first chunk of each
// owned cell's receiver row and the first two chunks of its candidate
// row, 3G loads in flight a lane; round 2 the positions of those
// receivers and candidates, the candidates staged (index and position) in
// shared memory at cell * (W + 1) in row order.  Longer rows (past 32
// receivers or 64 candidates) are read on in further chunks.  Then each
// lane takes one (cell, receiver) pair of the warp's flattened receiver
// list (about 18 of 32 lanes at the fast movers' density, where the first
// version kept one warp on one cell's 3 receivers), its receiver's index
// and position shuffled from the lane that read them, and sums its cell's
// candidates in row order: it tests a segment of 64 candidates into a
// bitmask of the near ones (no square root and no branch a test), then
// takes the near ones in order.  Shared memory: G * (W + 1) * 12 bytes a
// block, 9.3 KB at W = 128.  The odd stride keeps the cells' lanes on
// distinct banks (a stride of 128 put them all on one: G-way conflicts on
// 3 loads a test).
//
// Rounding: every operation is an IEEE intrinsic in the plain version's
// order (ops/cuda/candidate_sweep.py: the union sweep of ops/neighbors.py
// with its terms summed column after column): d^2 = fma(dy, dy, dx * dx)
// as XLA rounds jnp.linalg.norm and the plain version emulates; the cut
// sqrt_rn(d^2) < ps taken as d^2 < cut2 (exact: sqrt_rn is monotone, the
// window kernel's threshold, ops/cuda/window_separation.py:
// cut_threshold), so a test needs no square root; then, for a near pair,
// the correctly rounded square root, k / ((dc * dc) * dc), the product by
// the displacement and the sum in row order.  A far pair adds +0 in the
// plain version, which changes no sum that starts at +0.  So kernel and
// plain version agree bit for bit.
//
// Bound on this card: bytes.  The function reads each table's valid
// entries and the positions and writes the force; the bound charged in
// PERF.md is the first version's, the whole tables once (cand 10.9 MB,
// recv 4.1 MB at g = 146, W = 128, RK = 48), the positions and the force:
// 16 MB, 5 us.  Its operations are a distance test per (receiver,
// candidate) pair (two differences, two wraps, a product, a multiply-add,
// the square root, the cut) and about eight more with a division per near
// pair, under 0.3 us at a station swarm's density.  What limits the kernel
// is the issue of the receivers' loops (an IEEE square root a test, an
// IEEE division a near pair) and the two rounds of loads before them.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/candidate_sweep.py).

#include <cuda_runtime.h>

namespace {

// Cells a warp owns, at most (candidate_sweep.MAX_CELLS_PER_WARP).
constexpr int kMaxCells = 6;
constexpr unsigned kFull = 0xffffffffu;

// The select-form minimum image, both shifts computed and then selected:
// written as a choice between the shifts, the compiler branched, and the
// branches serialized the independent tests of a group.
__device__ __forceinline__ float wrap(float v, float hw, float two_hw) {
  const float down = __fsub_rn(v, two_hw), up = __fadd_rn(v, two_hw);
  return v >= hw ? down : (v < -hw ? up : v);
}

__device__ __forceinline__ bool valid(int b, int n) { return b >= 0 && b < n; }

// The valid-prefix length of row `row` of `table` [C, w] past its first
// `done` entries, which were all valid: chunks of 32 until one holds
// padding (only for rows longer than the first round's read).
__device__ __forceinline__ int rest_of_prefix(const int* __restrict__ table,
                                              long long row, int w, int n,
                                              int done, int lane) {
  int len = 0;
  for (int base = done; base < w; base += 32) {
    const int col = base + lane;
    const int b = col < w ? __ldg(table + row * w + col) : n;
    const unsigned m = __ballot_sync(kFull, valid(b, n));
    len += __popc(m);
    if (m != kFull) break;
  }
  return len;
}

// The candidates of row `row` from column `from` to `to`, staged (index,
// position) at s_* + column.
__device__ __forceinline__ void stage_rest(const float2* __restrict__ pos,
                                           const int* __restrict__ cand,
                                           long long row, int W, int from,
                                           int to, int lane, int* s_idx,
                                           float* s_x, float* s_y) {
  for (int col = from + lane; col < to; col += 32) {
    const int b = __ldg(cand + row * W + col);
    const float2 o = __ldg(pos + b);
    s_idx[col] = b;
    s_x[col] = o.x;
    s_y[col] = o.y;
  }
}

__global__ void __launch_bounds__(32)
candidate_sweep_kernel(const float2* __restrict__ pos,
                       const int* __restrict__ cand,
                       const int* __restrict__ recv, float2* __restrict__ out,
                       int n, int n_cells, int W, int RK, int G, float k_sep,
                       float cut2, float eps, float hw) {
  extern __shared__ unsigned char smem[];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * G;
  const int cells = min(G, n_cells - c0);

  // Round 1: each owned cell's first chunk of receivers and first two
  // chunks of candidates, 24 loads in flight a lane.
  int rv[kMaxCells], cv0[kMaxCells], cv1[kMaxCells];
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i) {
    const bool own = i < cells;
    const long long c = c0 + i;
    rv[i] = own && lane < RK ? __ldg(recv + c * RK + lane) : n;
    cv0[i] = own && lane < W ? __ldg(cand + c * W + lane) : n;
    cv1[i] = own && lane + 32 < W ? __ldg(cand + c * W + lane + 32) : n;
  }
  int nrecv[kMaxCells], ncand[kMaxCells];
  int total = 0;
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i) {
    const unsigned mr = __ballot_sync(kFull, valid(rv[i], n));
    nrecv[i] = __popc(mr);
    if (mr == kFull && RK > 32)
      nrecv[i] += rest_of_prefix(recv, c0 + i, RK, n, 32, lane);
    const unsigned m0 = __ballot_sync(kFull, valid(cv0[i], n));
    const unsigned m1 = __ballot_sync(kFull, valid(cv1[i], n));
    ncand[i] = nrecv[i] == 0 ? 0 : __popc(m0) + __popc(m1);
    if (nrecv[i] > 0 && m1 == kFull && W > 64)
      ncand[i] += rest_of_prefix(cand, c0 + i, W, n, 64, lane);
    total += nrecv[i];
  }
  if (total == 0) return;

  // Round 2: the positions of the receivers' first chunk and of the
  // candidates, the candidates staged at cell * (W + 1) in row order (an
  // odd stride, so the lanes of a warp's cells read distinct banks).
  const int S = W + 1;
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_x = reinterpret_cast<float*>(smem) + G * S;
  float* s_y = reinterpret_cast<float*>(smem) + 2 * G * S;
  float rx[kMaxCells], ry[kMaxCells];
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i) {
    const float2 r = lane < nrecv[i] ? __ldg(pos + rv[i]) : make_float2(0, 0);
    rx[i] = r.x;
    ry[i] = r.y;
    if (lane < ncand[i]) {
      const float2 o = __ldg(pos + cv0[i]);
      s_idx[i * S + lane] = cv0[i];
      s_x[i * S + lane] = o.x;
      s_y[i * S + lane] = o.y;
    }
    if (lane + 32 < ncand[i]) {
      const float2 o = __ldg(pos + cv1[i]);
      s_idx[i * S + lane + 32] = cv1[i];
      s_x[i * S + lane + 32] = o.x;
      s_y[i * S + lane + 32] = o.y;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i)   // rows longer than 64 candidates
    if (ncand[i] > 64)
      stage_rest(pos, cand, c0 + i, W, 64, ncand[i], lane, s_idx + i * S,
                 s_x + i * S, s_y + i * S);
  __syncwarp();

  // One lane a (cell, receiver) pair of the flattened receiver list; a
  // receiver of the first chunk comes from its reader by a shuffle.
  const float two_hw = 2.0f * hw;
  for (int base = 0; base < total; base += 32) {
    const int k = base + lane;
    int i = 0, r = k;
#pragma unroll
    for (int j = 0; j < kMaxCells - 1; ++j)
      if (i == j && r >= nrecv[j]) { r -= nrecv[j]; i = j + 1; }
    int a = n, m = 0;
    float ax = 0.0f, ay = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxCells; ++j) {
      const int src = r & 31;
      const int aj = __shfl_sync(kFull, rv[j], src);
      const float xj = __shfl_sync(kFull, rx[j], src);
      const float yj = __shfl_sync(kFull, ry[j], src);
      if (j == i) { a = aj; ax = xj; ay = yj; m = ncand[j]; }
    }
    if (k >= total) continue;
    if (r >= 32) {                      // past the first chunk of receivers
      a = __ldg(recv + (long long)(c0 + i) * RK + r);
      const float2 o = __ldg(pos + a);
      ax = o.x;
      ay = o.y;
    }
    const int* ci = s_idx + i * S;
    const float* xi = s_x + i * S;
    const float* yi = s_y + i * S;
    // Segments of 64 candidates: the tests four at a time, without a
    // branch, into a mask of the near ones; then the near ones' terms in
    // row order, so a warp pays the square root and the division only as
    // often as its lane with the most near pairs, not at every candidate.
    float fx = 0.0f, fy = 0.0f;
    for (int seg = 0; seg < m; seg += 64) {
      const int top = min(m, seg + 64);
      unsigned long long near = 0ull;
      for (int q = seg; q < top; q += 4) {
        unsigned nibble = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = min(q + j, top - 1);
          const float dx = wrap(__fsub_rn(ax, xi[e]), hw, two_hw);
          const float dy = wrap(__fsub_rn(ay, yi[e]), hw, two_hw);
          const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
          nibble |= (q + j < top && ci[e] != a && d2 < cut2) ? 1u << j : 0u;
        }
        near |= static_cast<unsigned long long>(nibble) << (q - seg);
      }
      while (near != 0ull) {
        const int q = seg + __ffsll(static_cast<long long>(near)) - 1;
        near &= near - 1ull;
        const float dx = wrap(__fsub_rn(ax, xi[q]), hw, two_hw);
        const float dy = wrap(__fsub_rn(ay, yi[q]), hw, two_hw);
        const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
        const float dc = fmaxf(__fsqrt_rn(d2), eps);
        const float scale =
            __fdiv_rn(k_sep, __fmul_rn(__fmul_rn(dc, dc), dc));
        fx = __fadd_rn(fx, __fmul_rn(scale, dx));
        fy = __fadd_rn(fy, __fmul_rn(scale, dy));
      }
    }
    out[a] = make_float2(fx, fy);
  }
}

}  // namespace

// pos [n, 2] f32, cand [cells, W] and recv [cells, RK] i32 (each row a
// valid prefix padded with n), out [n, 2] f32 zeroed by the caller, all
// contiguous on `device`; cut2 the least float whose correctly rounded
// square root reaches the personal space (a pair is near where d^2 <
// cut2); G cells a block of one warp, 1 <= G <= 6 and G * (W + 1) * 12 <=
// 48 KB.  Launched on `stream` without synchronising.  Returns the CUDA
// error of the launch (0 when accepted).
extern "C" int dsa_candidate_sweep_f32(const float* pos, const int* cand,
                                       const int* recv, float* out, int n,
                                       int cells, int W, int RK, int G,
                                       float k_sep, float cut2, float eps,
                                       float hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(G) * (W + 1) * 12;
  if (n <= 0 || cells <= 0 || W < 1 || RK < 1 || G < 1 || G > kMaxCells ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cells + G - 1) / G);
  candidate_sweep_kernel<<<grid, 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(pos), cand, recv,
      reinterpret_cast<float2*>(out), n, cells, W, RK, G, k_sep, cut2, eps,
      hw);
  return static_cast<int>(cudaGetLastError());
}
