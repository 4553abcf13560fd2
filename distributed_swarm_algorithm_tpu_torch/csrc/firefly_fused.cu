// All-pairs firefly attraction for Hopper (sm_90a).
//
// dsa_firefly_attraction_f32 replaces the TPU kernel
//   distributed_swarm_algorithm_tpu/ops/pallas/firefly_fused.py:
//   firefly_attraction_pallas (body _make_kernel).
//
// What one call computes, for rows x_i of pos_i [N, D] and sources x_j of
// pos_j [Nj, D] (the same swarm in the square case, another one in the
// rectangular case the sharded driver uses):
//
//   r2_ij  = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)     (the Gram identity)
//   W_ij   = beta0 exp_fast(-gamma r2_ij)  where f_j < f_i, else 0
//   move_i = sum_j W_ij x_j - (sum_j W_ij) x_i
//
// Arithmetic.  The dimensions split into groups of 32; each group's dot
// product (and squared norm) is a sequential sum of IEEE products from 0,
// and the groups combine as a pairwise tree ((g0 + g1) + (g2 + g3)).  The
// plain version (ops/cuda/firefly_fused.py) sums in the same order and
// evaluates exp_fast (fast_math.cuh) step for step, so W is the same bit for
// bit.  Each group is padded with zeros to a multiple of 4 dimensions on
// both sides: a running sum that starts at +0 is never -0, so adding the
// padding's +0 products leaves it unchanged.  The sums over j differ: each
// row block adds a tile of 64 sources into a partial (in source order, one
// multiply-add a term) and the partial into its total; the totals of the
// splits of a row block (below) add in split order.  An element of tile t
// of split s passes through at most 64 adds in its tile and T_s + S - 1 <=
// ceil(Nj / 64) adds after it (T_s tiles in its split, S splits that hold
// a tile), so the error stays within (64 + ceil(Nj / 64)) ulps of
// sum_j |W_ij x_j|: the band of the comparison
// (firefly_fused.attraction_band), unchanged.  No atomics: a call repeats
// its bits.  Equal fitness gives no attraction (the strict <); a NaN
// fitness fails every comparison.
//
// Bound on this card, at N = Nj = 65,536, D = 30 (chip_smoke.py: FF_OPS
// counts the operations from this source).  Bytes: the positions and fitness
// read once and the move written once, about 16 MB, 5 us.  Operations: the
// function needs every pair's brightness test, a brighter pair's dot product
// (2 D), distance and fast exponential (about 27), and a pair with W != 0
// its accumulation (2 D + 1): with about half the pairs brighter, some 1.9e11
// operations, 2.9 ms at 67 TFLOP/s.  Operations bound it.  Measured there
// (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700 W): 8.65 ms a call, from
// 46.2 ms for the first version: 2.15e9 visited pairs in 119-135 lane
// issue slots each (at 1.75-1.98 GHz), where the code counts about 100
// instructions a pair (the IEEE dot product alone 64, D padded to 32).
// Registers: 118, 103 and 72 for G = 1, 2 and 4 groups, no spills: 4
// blocks an SM at G = 1, as its 47.6 KB of shared memory allows.
//
// Design (rule 2's redesign; the first version computed every pair's dot
// product and read one float of shared memory a product).
//   1. Triangle schedule.  The wrapper sorts rows and sources by fitness on
//      the device (a stable sort of the fitness with NaN as +inf) and gives
//      each row block of BR sorted rows its tile count: the tiles of 64
//      sorted sources up to the last one that holds a source brighter than
//      the block's dimmest non-NaN row.  No pair past it can be brighter, so
//      the cut is exact; mixed tiles keep the per-pair test.  A square call
//      visits about half the pairs.  The prep kernel gathers the sorted rows
//      into a padded [., 32 G] buffer with their fitness and squared norms;
//      the combine kernel writes each move to its row's original index.
//   2. Register tiling.  A block of 128 threads holds BR rows and streams
//      the sources in tiles of 64.  Phase (a): each thread computes an R x 8
//      micro-tile of dot products from 16-byte shared loads (R + 8 loads a
//      4 dimensions for 32 R products and sums), then r2, exp_fast and the
//      mask, and writes W for the tile to shared memory.  Phase (b) runs
//      only if some W of the tile is nonzero (__syncthreads_or, exact; at
//      the bench's spread almost no pair attracts): each thread owns R2 rows
//      x Q dimensions and adds W x_j over the tile in source order.
//   3. Staging: cp.async into a double-buffered ring of source tiles (with
//      their squared norms and fitness); tile t + 1 is copied while tile t
//      is computed; two barriers a tile; no division.
//   4. Filling the card: the source range of a row block splits into S
//      chunks of tiles, S from the card's SM count and the row blocks
//      (8 x 132 blocks of work asked for: S = 5 at N = 16,384, which leaves
//      some 760 non-empty blocks; S = 2 at 65,536).  A split writes its
//      partial sums; the combine kernel adds them in split order.  Blocks
//      start with the dimmest rows, the longest, so the grid's tail is
//      short.
// The products run on CUDA cores in full f32 (no tensor cores, no TF32);
// the dot products stay IEEE products and sums, never multiply-adds, which
// would change W's bits.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// (ops/cuda/_build.py) and called through ctypes (ops/cuda/firefly_fused.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 32;     // dimensions a group sums in order
constexpr int kTileJ = 64;     // sources a shared tile holds
constexpr int kMaxDim = 128;   // 4 groups
constexpr int kWStride = 72;   // floats a row of the W tile takes
constexpr int kSrcCols = 8;    // threads along the sources in phase (a)
constexpr int kSrcPer = kTileJ / kSrcCols;   // sources a thread holds

using dsa::obj::add;
using dsa::obj::mul;
using dsa::obj::sub;

// The shape of a block for G groups (G = 1, 2, 4).  Phase (a): R rows x 8
// sources a thread; phase (b): R2 rows x Q dimensions a thread.
template <int G> struct Shape;
template <> struct Shape<1> { static constexpr int R = 4, R2 = 2, Q = 8; };
template <> struct Shape<2> { static constexpr int R = 2, R2 = 1, Q = 16; };
template <> struct Shape<4> { static constexpr int R = 1, R2 = 1, Q = 16; };

template <int G> struct Dims {
  static constexpr int R = Shape<G>::R, R2 = Shape<G>::R2, Q = Shape<G>::Q;
  static constexpr int BR = 16 * R;          // rows a block
  static constexpr int W = kGroup * G;       // floats a staged row
  static constexpr int SS = W + 4;           // its shared stride
  static constexpr int DG = W / Q;           // threads along the dims, (b)
  static constexpr int RG = kThreads / DG;   // threads along the rows, (b)
  static_assert(RG * R2 == BR, "phase (b) must cover the row block");
  static constexpr int kSharedFloats =
      BR * SS + 2 * kTileJ * SS + BR * kWStride + 2 * BR + 4 * kTileJ;
};

struct Args {
  const float* pos_i;       // [n, dim]
  const int64_t* order_i;   // [n] row at each sorted position
  const int* tiles;         // [row blocks] source tiles each block visits
  const float* xs_i;        // [np_i, W] sorted rows, zero-padded
  const float* sq_i;        // [np_i]
  const float* fs_i;        // [np_i] (NaN past n)
  const float* xs_j;        // [np_j, W] sorted sources
  const float* sq_j;        // [np_j]
  const float* fs_j;        // [np_j]
  float* pacc;              // [splits, np_i, W] partial sums
  float* pw;                // [splits, np_i] partial weight sums
  float* out;               // [n, dim]
  int n, dim, np_i, chunk;
  float beta0, neg_gamma;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `rows` staged rows of W floats (at stride SS in shared memory) and
// their squared norms and fitness, 16 bytes a copy.
template <int G>
__device__ __forceinline__ void stage(float* s_x, float* s_sq, float* s_f,
                                      const float* xs, const float* sq,
                                      const float* fs, int p0, int rows) {
  using S = Dims<G>;
  constexpr int kC = S::W / 4;   // 16-byte copies a row
  const int tid = threadIdx.x;
  const float* src = xs + static_cast<size_t>(p0) * S::W;
  for (int e = tid; e < rows * kC; e += kThreads) {
    const int r = e / kC;   // kC is a power of two: a shift
    const int c = e - r * kC;
    cp_async16(s_x + r * S::SS + 4 * c, src + static_cast<size_t>(e) * 4);
  }
  const int q = rows / 4;
  if (tid < q) {
    cp_async16(s_sq + 4 * tid, sq + p0 + 4 * tid);
  } else if (tid < 2 * q) {
    cp_async16(s_f + 4 * (tid - q), fs + p0 + 4 * (tid - q));
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Row block gridDim.x - 1 - blockIdx.x (the dimmest first), split
// blockIdx.y: its tiles [y chunk, min((y + 1) chunk, tiles)).
template <int G>
__global__ void __launch_bounds__(kThreads)
attract_kernel(const Args a) {
  using S = Dims<G>;
  constexpr int R = S::R, R2 = S::R2, Q = S::Q, BR = S::BR, SS = S::SS;
  extern __shared__ __align__(16) float smem[];
  float* s_row = smem;                          // [BR][SS]
  float* s_src = s_row + BR * SS;               // [2][64][SS]
  float* s_w = s_src + 2 * kTileJ * SS;         // [BR][kWStride]
  float* s_sqr = s_w + BR * kWStride;           // [BR]
  float* s_fr = s_sqr + BR;                     // [BR]
  float* s_sqs = s_fr + BR;                     // [2][64]
  float* s_fs = s_sqs + 2 * kTileJ;             // [2][64]

  const int blk = gridDim.x - 1 - blockIdx.x;
  const int t_begin = blockIdx.y * a.chunk;
  const int t_end = min(t_begin + a.chunk, a.tiles[blk]);
  if (t_begin >= t_end) return;   // the whole block, before any barrier
  const int tid = threadIdx.x;
  const int row0 = blk * BR;

  stage<G>(s_row, s_sqr, s_fr, a.xs_i, a.sq_i, a.fs_i, row0, BR);
  stage<G>(s_src, s_sqs, s_fs, a.xs_j, a.sq_j, a.fs_j, t_begin * kTileJ,
           kTileJ);
  cp_async_commit();

  // Chunks of 4 dimensions in each group (the last padded with zeros).
  int nck[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    nck[g] = (min(kGroup, max(0, a.dim - g * kGroup)) + 3) >> 2;
  }

  // Phase (a): rows tr + 16 r, sources ts + 8 m.  Phase (b): rows
  // rg + RG k, dimensions dg Q ... dg Q + Q - 1.
  const int ts = tid % kSrcCols, tr = tid / kSrcCols;
  const int dg = tid % S::DG, rg = tid / S::DG;
  float acc[R2][Q], wsum[R2];
#pragma unroll
  for (int k = 0; k < R2; ++k) {
    wsum[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[k][q] = 0.0f;
  }

  int buf = 0;
  for (int t = t_begin; t < t_end; ++t, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // tile t has landed; tile t - 1 is no longer read
    if (t + 1 < t_end) {
      stage<G>(s_src + (buf ^ 1) * kTileJ * SS, s_sqs + (buf ^ 1) * kTileJ,
               s_fs + (buf ^ 1) * kTileJ, a.xs_j, a.sq_j, a.fs_j,
               (t + 1) * kTileJ, kTileJ);
    }
    cp_async_commit();
    const float* src = s_src + buf * kTileJ * SS;

    // Phase (a): the dot products, each group from 0 in order, the groups
    // as the pairwise tree.
    float dot[R][kSrcPer];
    float t0[R][kSrcPer], t1[R][kSrcPer];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float c[R][kSrcPer];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int m = 0; m < kSrcPer; ++m) c[r][m] = 0.0f;
      }
      for (int ck = 0; ck < nck[g]; ++ck) {
        const int off = g * kGroup + 4 * ck;
        float4 xr[R], xj[kSrcPer];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          xr[r] = *reinterpret_cast<const float4*>(
              s_row + (tr + 16 * r) * SS + off);
        }
#pragma unroll
        for (int m = 0; m < kSrcPer; ++m) {
          xj[m] = *reinterpret_cast<const float4*>(
              src + (ts + kSrcCols * m) * SS + off);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int m = 0; m < kSrcPer; ++m) {
            float v = c[r][m];
            v = add(v, mul(xr[r].x, xj[m].x));
            v = add(v, mul(xr[r].y, xj[m].y));
            v = add(v, mul(xr[r].z, xj[m].z));
            v = add(v, mul(xr[r].w, xj[m].w));
            c[r][m] = v;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int m = 0; m < kSrcPer; ++m) {
          if (G == 1) {
            dot[r][m] = c[r][m];
          } else if (G == 2) {
            if (g == 0) t0[r][m] = c[r][m];
            else dot[r][m] = add(t0[r][m], c[r][m]);
          } else {
            if (g == 0) t0[r][m] = c[r][m];
            else if (g == 1) t0[r][m] = add(t0[r][m], c[r][m]);
            else if (g == 2) t1[r][m] = c[r][m];
            else dot[r][m] = add(t0[r][m], add(t1[r][m], c[r][m]));
          }
        }
      }
    }

    int any = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = tr + 16 * r;
      const float sqr = s_sqr[row], fr = s_fr[row];
#pragma unroll
      for (int m = 0; m < kSrcPer; ++m) {
        const int j = ts + kSrcCols * m;
        const float fj = s_fs[buf * kTileJ + j];
        const float r2 = fmaxf(
            sub(add(sqr, s_sqs[buf * kTileJ + j]), mul(2.0f, dot[r][m])),
            0.0f);
        const float e =
            mul(a.beta0, dsa::fast::exp_fast(mul(a.neg_gamma, r2)));
        const float w = fj < fr ? e : 0.0f;
        s_w[row * kWStride + j] = w;
        any |= w != 0.0f;
      }
    }

    // Phase (b), only where some pair of the tile attracts.
    if (__syncthreads_or(any)) {
      float part[R2][Q], wp[R2];
#pragma unroll
      for (int k = 0; k < R2; ++k) {
        wp[k] = 0.0f;
#pragma unroll
        for (int q = 0; q < Q; ++q) part[k][q] = 0.0f;
      }
#pragma unroll 2
      for (int j4 = 0; j4 < kTileJ / 4; ++j4) {
        float4 wv[R2];
#pragma unroll
        for (int k = 0; k < R2; ++k) {
          wv[k] = *reinterpret_cast<const float4*>(
              s_w + (rg + S::RG * k) * kWStride + 4 * j4);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* xj = src + (4 * j4 + jj) * SS + dg * Q;
          float4 xv[Q / 4];
#pragma unroll
          for (int q = 0; q < Q / 4; ++q) {
            xv[q] = *reinterpret_cast<const float4*>(xj + 4 * q);
          }
#pragma unroll
          for (int k = 0; k < R2; ++k) {
            const float w = lane_of(wv[k], jj);
            wp[k] = add(wp[k], w);
#pragma unroll
            for (int q = 0; q < Q / 4; ++q) {
              part[k][4 * q] = __fmaf_rn(w, xv[q].x, part[k][4 * q]);
              part[k][4 * q + 1] = __fmaf_rn(w, xv[q].y, part[k][4 * q + 1]);
              part[k][4 * q + 2] = __fmaf_rn(w, xv[q].z, part[k][4 * q + 2]);
              part[k][4 * q + 3] = __fmaf_rn(w, xv[q].w, part[k][4 * q + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R2; ++k) {
        wsum[k] = add(wsum[k], wp[k]);
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[k][q] = add(acc[k][q], part[k][q]);
      }
    }
  }

  // This split's partial sums of its rows.
#pragma unroll
  for (int k = 0; k < R2; ++k) {
    const size_t p = static_cast<size_t>(blockIdx.y) * a.np_i + row0 + rg +
                     S::RG * k;
    float4* dst = reinterpret_cast<float4*>(a.pacc + p * S::W + dg * Q);
#pragma unroll
    for (int q = 0; q < Q / 4; ++q) {
      dst[q] = make_float4(acc[k][4 * q], acc[k][4 * q + 1],
                           acc[k][4 * q + 2], acc[k][4 * q + 3]);
    }
    if (dg == 0) a.pw[p] = wsum[k];
  }
}

// Sorted position p: the padded row, its fitness (NaN past n) and its
// squared norm in the plain version's order.
template <int G>
__global__ void prep_kernel(const float* __restrict__ pos,
                            const float* __restrict__ fit,
                            const int64_t* __restrict__ order, float* xs,
                            float* sq, float* fs, int n, int np, int dim) {
  constexpr int W = kGroup * G;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np) return;
  const bool valid = p < n;
  const float* row =
      pos + (valid ? static_cast<size_t>(order[p]) * dim : 0);
  float* dst = xs + static_cast<size_t>(p) * W;
  float part[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    part[g] = 0.0f;
#pragma unroll 8
    for (int d = g * kGroup; d < (g + 1) * kGroup; ++d) {
      const float v = valid && d < dim ? row[d] : 0.0f;
      dst[d] = v;
      if (d < dim) part[g] = add(part[g], mul(v, v));
    }
  }
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
#pragma unroll
    for (int g = 0; g < G; g += 2 * s) part[g] = add(part[g], part[g + s]);
  }
  sq[p] = part[0];
  fs[p] = valid ? fit[order[p]] : __int_as_float(0x7fc00000);
}

// move_i = (sum of the splits' partials, in split order) - (sum of their
// weight sums) x_i, written at the row's original index.
template <int G>
__global__ void combine_kernel(const Args a) {
  using S = Dims<G>;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(a.n) * a.dim) return;
  const int p = static_cast<int>(e / a.dim);
  const int d = static_cast<int>(e - static_cast<long long>(p) * a.dim);
  const int used = (a.tiles[p / S::BR] + a.chunk - 1) / a.chunk;
  float acc = 0.0f, ws = 0.0f;
  for (int s = 0; s < used; ++s) {
    const size_t q = static_cast<size_t>(s) * a.np_i + p;
    acc = add(acc, a.pacc[q * S::W + d]);
    ws = add(ws, a.pw[q]);
  }
  const size_t at = static_cast<size_t>(a.order_i[p]) * a.dim + d;
  a.out[at] = sub(acc, mul(ws, a.pos_i[at]));
}

int groups_of(int dim) {
  if (dim < 1 || dim > kMaxDim) return 0;
  const int groups = (dim + kGroup - 1) / kGroup;
  return groups == 1 ? 1 : groups == 2 ? 2 : 4;
}

int padded(int n) { return (n + kTileJ - 1) / kTileJ * kTileJ; }

template <int G>
cudaError_t launch(const float* pos_i, const float* fit_i,
                   const int64_t* order_i, const float* pos_j,
                   const float* fit_j, const int64_t* order_j,
                   const int* tiles, float* work, float* out, int n, int nj,
                   int dim, int splits, int chunk, float beta0,
                   float neg_gamma, cudaStream_t s) {
  using S = Dims<G>;
  const bool square = pos_i == pos_j && order_i == order_j;
  const int np_i = padded(n), np_j = padded(nj);
  // The workspace: sorted rows, their norms and fitness; the sources' (not
  // in the square case); the splits' partial sums and weight sums.
  float* xs_i = work;
  float* sq_i = xs_i + static_cast<size_t>(np_i) * S::W;
  float* fs_i = sq_i + np_i;
  float* next = fs_i + np_i;
  float *xs_j = xs_i, *sq_j = sq_i, *fs_j = fs_i;
  prep_kernel<G><<<(np_i + 127) / 128, 128, 0, s>>>(
      pos_i, fit_i, order_i, xs_i, sq_i, fs_i, n, np_i, dim);
  if (!square) {
    xs_j = next;
    sq_j = xs_j + static_cast<size_t>(np_j) * S::W;
    fs_j = sq_j + np_j;
    next = fs_j + np_j;
    prep_kernel<G><<<(np_j + 127) / 128, 128, 0, s>>>(
        pos_j, fit_j, order_j, xs_j, sq_j, fs_j, nj, np_j, dim);
  }
  float* pacc = next;
  float* pw = pacc + static_cast<size_t>(splits) * np_i * S::W;
  const Args a{pos_i, order_i, tiles, xs_i, sq_i, fs_i, xs_j, sq_j, fs_j,
               pacc, pw, out, n, dim, np_i, chunk, beta0, neg_gamma};
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int shared = S::kSharedFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(attract_kernel<G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shared);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + S::BR - 1) / S::BR, splits);
  attract_kernel<G><<<grid, kThreads, shared, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(n) * dim;
  combine_kernel<G><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Groups of 32 dimensions a row is summed in at dimension `dim`, rounded up
// to a power of two (0 outside 1..128): the plain version's grouping,
// exported so that a test can hold the two together.
extern "C" int dsa_firefly_lanes(int dim) { return groups_of(dim); }

// Rows a block holds at dimension `dim` (0 outside the envelope).
extern "C" int dsa_firefly_rows_per_block(int dim) {
  switch (groups_of(dim)) {
    case 1: return Dims<1>::BR;
    case 2: return Dims<2>::BR;
    case 4: return Dims<4>::BR;
    default: return 0;
  }
}

// Floats of the workspace a call takes: the sorted, padded rows (and
// sources, unless square) with their norms and fitness, then the splits'
// partial sums.
extern "C" long long dsa_firefly_workspace_floats(int n, int nj, int dim,
                                                  int splits, int square) {
  const int g = groups_of(dim);
  if (g == 0) return 0;
  const long long w = kGroup * g, np_i = padded(n), np_j = padded(nj);
  return np_i * (w + 2) + (square ? 0 : np_j * (w + 2)) +
         static_cast<long long>(splits) * np_i * (w + 1);
}

// pos_i [n, dim], fit_i [n], pos_j [nj, dim], fit_j [nj] f32; order_i [n]
// and order_j [nj] int64, the rows and sources in ascending fitness (the
// same pointers in the square case); tiles [ceil(n / rows a block)] int32;
// work the workspace above; out [n, dim] f32.  All contiguous on `device`;
// launched on `stream` without synchronising.  Returns the CUDA error of
// the launches (0 when accepted).
extern "C" int dsa_firefly_attraction_f32(
    const float* pos_i, const float* fit_i, const int64_t* order_i,
    const float* pos_j, const float* fit_j, const int64_t* order_j,
    const int* tiles, float* work, float* out, int n, int nj, int dim,
    int splits, int chunk, float beta0, float neg_gamma, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || nj <= 0 || splits <= 0 || chunk <= 0 ||
      static_cast<long long>(splits) * chunk * kTileJ < nj) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (groups_of(dim)) {
    case 1:
      err = launch<1>(pos_i, fit_i, order_i, pos_j, fit_j, order_j, tiles,
                      work, out, n, nj, dim, splits, chunk, beta0, neg_gamma,
                      s);
      break;
    case 2:
      err = launch<2>(pos_i, fit_i, order_i, pos_j, fit_j, order_j, tiles,
                      work, out, n, nj, dim, splits, chunk, beta0, neg_gamma,
                      s);
      break;
    case 4:
      err = launch<4>(pos_i, fit_i, order_i, pos_j, fit_j, order_j, tiles,
                      work, out, n, nj, dim, splits, chunk, beta0, neg_gamma,
                      s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
