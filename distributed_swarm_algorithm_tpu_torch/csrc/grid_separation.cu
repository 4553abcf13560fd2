// Hashgrid separation for the protocol tick, overflow rescue included, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_swarm_algorithm_tpu/ops/pallas/
// grid_separation.py:separation_hashgrid_pallas: both of its pallas_call
// sites (the whole-row slot-plane sweep and the lane-tiled one, a TPU VMEM
// workaround) and the LOCAL overflow rescue that function runs after them
// (_overflow_rescue_local, scatter-adds in XLA).  The TPU kernel sweeps
// g*g*K sentinel-filled slot planes; here the kernel reads the plan's cell
// sort directly:
//
//   spos [n] float2  current positions in the plan's sort order
//   skey, rank [n]   each sorted agent's cell (g*g when dead) and rank in it
//   order [n]        sorted index -> agent, so the force lands in agent order
//   bounds [g*g + 1] first sorted index of each cell (a searchsorted of skey)
//   ovf_before [g*g] capped-out live agents in the cells before each cell
//
// A cell's agents are one run of the sort, [bounds[c], bounds[c + 1]).  Its
// first K are in the grid; the rest are capped out, and of those the first
// `budget` of the whole swarm (in sort order: ovf_before[c] + rank - K <
// budget) are rescued.  Every other agent (dead, or capped out past the
// budget) gets zero force and is seen by no one, as in the reference.
//
// For each in-grid or rescued agent p, with the (2R+1)^2 stencil cells
// (cx + dr, cy + dc) mod g, |dr|, |dc| <= R, visited in ascending key order:
//
//   pass 1: f_p += near * k * rsqrt(max(d2, eps^2))^3 * wrap(p - q)
//           over the in-grid agents q != p of each cell;
//   pass 2: over the rescued agents v != p of each cell, in the same order
//           (which is the rescue's own order, ascending sort index):
//           f_p += the same term if p is rescued (the rescued-vs-rescued
//           pairs), and f_p -= k ... * wrap(v - p) if p is in the grid (the
//           reaction the reference scatters onto the partner's slot,
//           computed from the rescued agent's end: the select-form wrap is
//           not odd at exactly +-hw).
//
// near = d2 < ps^2 with the select-form minimum image on both axes.  The
// rescued-vs-rescued pairs are taken over the stencil, not over all
// rescued pairs as the reference does: the stencil covers personal_space
// (plus the plan's skin), the same bound the in-grid sweep relies on, so a
// near pair is always in it.  With nothing capped out, pass 2 only tests
// each stencil cell's count against K: no read of the device decides it.
//
// Design: one thread per sorted agent.  A warp's 32 receivers are
// consecutive in the sort, so they sit in neighbouring cells of one grid
// row, and their stencils' bounds and positions are the same few cache
// lines (read through L1).  Each stencil cell costs one pair of bounds
// loads and its live agents' positions: at a station swarm's density (one
// agent a cell) about 9 cells and 9 partners a receiver, where the first
// version walked all 144 slots of the 3x3 stencil, mostly sentinels.  Each
// pair is computed from both ends, in a fixed order, with no atomics and no
// scatter.  R is a template parameter, so the stencil loop unrolls; each
// cell's bounds are loaded before the previous cell's partners, and a
// cell's partners four at a time: a warp's walk of a cell is as long as
// its most crowded lane's, so a load a partner would make it a chain of
// dependent round trips.
//
// Rounding: d2 = fma(dx, dx, dy * dy), as XLA rounds the TPU kernel's
// dx*dx + dy*dy and as the plain version (ops/cuda/grid_separation.py)
// computes it; rsqrtf, the function torch.rsqrt computes on the card; the
// products k*inv*inv*inv and scale*d and the sums in the plain version's
// order (pass 1's terms, then pass 2's, one after another).
//
// Bound on this card: bytes.  The kernel reads the sorted positions, keys,
// ranks, order and the two cell tables once and writes the force once
// (about 2.3 MB at n = 65,536, g = 256): under 1 us.  The operations, a
// distance test per pair in a stencil and about eight more per near pair,
// take under 0.1 us at a station swarm's density.  What limits the kernel
// is the latency of the two dependent loads (a cell's bounds, then its
// partners) at 16 warps an SM, and, where the rescue is engaged, the
// rescued agents' threads, which each walk the stencil's rescued run.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes
// (ops/cuda/grid_separation.py).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// The select-form minimum image, both shifts computed and then selected:
// written as a choice between the shifts, the compiler branched, and the
// branches serialized the independent tests of a group.
__device__ __forceinline__ float wrap(float v, float hw, float two_hw) {
  const float down = __fsub_rn(v, two_hw), up = __fadd_rn(v, two_hw);
  return v >= hw ? down : (v < -hw ? up : v);
}

// The scale k * rsqrt(max(d2, eps^2))^3 of a pair inside the cut.
__device__ __forceinline__ float pair_scale(float d2, float k_sep,
                                            float eps2) {
  const float inv = rsqrtf(fmaxf(d2, eps2));
  return __fmul_rn(__fmul_rn(__fmul_rn(k_sep, inv), inv), inv);
}

// The stencil's rows (or columns) around `c` in ascending order: the
// offset index (0 .. 2R) at which the wrapped sequence is smallest.
template <int R>
__device__ __forceinline__ int first_ascending(int c, int g) {
  if (c - R < 0) return R - c;
  if (c + R >= g) return g - (c - R);
  return 0;
}

template <int R>
__device__ __forceinline__ int stencil_line(int c, int g, int first, int t) {
  int i = first + t;
  if (i > 2 * R) i -= 2 * R + 1;
  int v = c - R + i;
  if (v < 0) v += g;
  else if (v >= g) v -= g;
  return v;
}

// Adds the terms of partners q in [first, end), q != p, to (ax, ay) in
// order, four at a time: the four positions loaded together and the four
// terms computed without a branch (+0 where a partner is out of the run,
// the receiver itself or outside the cut: adding +0 leaves a sum that
// started at +0 unchanged, so the sum is the plain version's).  `sub`
// subtracts each term (an in-grid receiver's reactions), `from_partner`
// computes the displacement from the partner's end.
__device__ __forceinline__ void add_run(
    const float2* __restrict__ spos, int p, int first, int end, float2 me,
    bool from_partner, bool sub, float k_sep, float ps2, float eps2,
    float hw, float two_hw, float& ax, float& ay) {
  for (int q = first; q < end; q += 4) {
    float2 o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = q + j < end ? __ldg(spos + q + j) : me;
    float tx[4], ty[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sx = from_partner ? __fsub_rn(o[j].x, me.x)
                                    : __fsub_rn(me.x, o[j].x);
      const float sy = from_partner ? __fsub_rn(o[j].y, me.y)
                                    : __fsub_rn(me.y, o[j].y);
      const float dx = wrap(sx, hw, two_hw);
      const float dy = wrap(sy, hw, two_hw);
      const float d2 = __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
      const bool near = q + j < end && q + j != p && d2 < ps2;
      const float s = pair_scale(d2, k_sep, eps2);
      tx[j] = near ? __fmul_rn(s, dx) : 0.0f;
      ty[j] = near ? __fmul_rn(s, dy) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ax = sub ? __fsub_rn(ax, tx[j]) : __fadd_rn(ax, tx[j]);
      ay = sub ? __fsub_rn(ay, ty[j]) : __fadd_rn(ay, ty[j]);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kBlock)
grid_sweep_kernel(const float2* __restrict__ spos,
                  const int* __restrict__ skey, const int* __restrict__ rank,
                  const int* __restrict__ order,
                  const int* __restrict__ bounds,
                  const int* __restrict__ ovf_before, float2* __restrict__ out,
                  int n, int g, int K, int budget, float k_sep, float ps2,
                  float eps2, float hw) {
  constexpr int kW = 2 * R + 1;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= n) return;
  const int g2 = g * g;
  const int cell = skey[p];
  const int agent = order[p];
  const float2 me = spos[p];
  bool in_grid = false, rescued = false;
  if (cell < g2) {
    const int rk = rank[p];
    in_grid = rk < K;
    rescued = !in_grid && __ldg(ovf_before + cell) + (rk - K) < budget;
  }
  if (!in_grid && !rescued) {
    out[agent] = make_float2(0.0f, 0.0f);
    return;
  }
  const int cx = cell / g;
  const int cy = cell - cx * g;
  const int row0 = first_ascending<R>(cx, g);
  const int col0 = first_ascending<R>(cy, g);
  const float two_hw = 2.0f * hw;
  float ax = 0.0f, ay = 0.0f;
  unsigned crowded = 0u;  // stencil cells holding capped-out agents

  // Pass 1: the in-grid agents of each stencil cell, the next cell's
  // bounds loaded before the current cell's partners.
  const int c0 = stencil_line<R>(cx, g, row0, 0) * g +
                 stencil_line<R>(cy, g, col0, 0);
  int lo = __ldg(bounds + c0), hi = __ldg(bounds + c0 + 1);
#pragma unroll
  for (int t = 0; t < kW * kW; ++t) {
    int nlo = 0, nhi = 0;
    if (t + 1 < kW * kW) {
      const int nc = stencil_line<R>(cx, g, row0, (t + 1) / kW) * g +
                     stencil_line<R>(cy, g, col0, (t + 1) % kW);
      nlo = __ldg(bounds + nc);
      nhi = __ldg(bounds + nc + 1);
    }
    if (hi - lo > K) crowded |= 1u << t;
    add_run(spos, p, lo, lo + min(hi - lo, K), me, false, false, k_sep, ps2,
            eps2, hw, two_hw, ax, ay);
    lo = nlo;
    hi = nhi;
  }

  // Pass 2: the rescued agents of the crowded stencil cells, from the
  // receiver's end if it is rescued, else from the rescued partner's end,
  // subtracted (the reference's reaction).
  while (crowded != 0u) {
    const int bit = __ffs(crowded) - 1;
    crowded &= crowded - 1u;
    const int tr = bit / kW, tc = bit - tr * kW;
    const int cc = stencil_line<R>(cx, g, row0, tr) * g +
                   stencil_line<R>(cy, g, col0, tc);
    const int first = __ldg(bounds + cc) + K;
    const int cnt = __ldg(bounds + cc + 1) - first;
    const int end = first + min(cnt, budget - __ldg(ovf_before + cc));
    add_run(spos, p, first, end, me, in_grid, in_grid, k_sep, ps2, eps2, hw,
            two_hw, ax, ay);
  }
  out[agent] = make_float2(ax, ay);
}

}  // namespace

// spos [n, 2] f32; skey, rank, order [n] i32; bounds [g*g + 1] and
// ovf_before [g*g] i32; out [n, 2] f32, every row written; all contiguous
// on `device`.  Launched on `stream` without synchronising.  Returns the
// CUDA error of the launch (0 when accepted).
extern "C" int dsa_grid_sweep_f32(const float* spos, const int* skey,
                                  const int* rank, const int* order,
                                  const int* bounds, const int* ovf_before,
                                  float* out, int n, int g, int K, int R,
                                  int budget, float k_sep, float ps2,
                                  float eps2, float hw, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || g < 2 * R + 1 || K < 1 || budget < 0 || R < 1 || R > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p2 = reinterpret_cast<const float2*>(spos);
  auto* o2 = reinterpret_cast<float2*>(out);
  if (R == 1)
    grid_sweep_kernel<1><<<grid, kBlock, 0, s>>>(
        p2, skey, rank, order, bounds, ovf_before, o2, n, g, K, budget, k_sep,
        ps2, eps2, hw);
  else
    grid_sweep_kernel<2><<<grid, kBlock, 0, s>>>(
        p2, skey, rank, order, bounds, ovf_before, o2, n, g, K, budget, k_sep,
        ps2, eps2, hw);
  return static_cast<int>(cudaGetLastError());
}
