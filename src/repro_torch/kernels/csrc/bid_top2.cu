// Fused auction bidding reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bid_kernel` behind `bid_top2_pallas` in
// src/repro/kernels/bid_top2.py.  Per row i of group g it returns the best
// value v1, its column j1 and the second-best value v2 of
//
//     value[i, j] = -2 x_i . c_j + ||c_j||^2 - p_j
//
// over the k columns j, without ever writing the (m, k) value matrix.
//
// What bounds it on this card: at the auction's shape (m = k = 256,
// d = 22..32) one call is at most 4.2 MFLOP and moves about 70 KB, which
// the H100 does in well under a microsecond.  The launch itself costs more,
// so the kernel is launch-bound and the design aims only at being right,
// deterministic and short: fp32 FMA on the CUDA cores (no tensor cores, so
// no TF32 rounding can flip an argmax), one pass, no atomics.
//
// Design:
//   * grid = (ceil(m / 16), G): the stacked (G, m, d) x (G, k, d) form is a
//     grid axis, so a group's result never depends on G.
//   * A CTA of 8 warps owns 16 rows (2 per warp).  Column tiles of 128 c rows
//     are staged in shared memory feature-major (padded by one word, so the
//     staging stores and the per-lane reads are free of bank conflicts),
//     together with ||c_j||^2 - p_j.  d is walked in tiles of 32, so any d
//     is taken.
//   * Each lane owns 4 columns of a tile (lane, lane + 32, ...), keeps a
//     running (v1, j1, v2) per row in registers and sees its columns in
//     increasing order, so a tie keeps the earlier column.  The 32 lane
//     results are merged with shuffles under the same rule (larger value,
//     then lower column), so the lowest column wins every tie and a maximum
//     that occurs twice gives v2 == v1, as in `_bid_kernel`'s merge and in
//     `bid_top2_ref`.
//   * Columns past k are masked inside the kernel and never win.
//   * ||c_j||^2 is computed from the staged tile, as the JAX wrapper computes
//     it from c (`bid_top2.py:113`); the caller's prices are used as given.
//   * j1 is written as int64, the index type PyTorch's gather and scatter
//     take, so the auction loop needs no conversion.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kColsPerLane = 4;
constexpr int kTileK = 32 * kColsPerLane;
constexpr int kTileD = 32;
constexpr float kNeg = -1e30f;  // the reference's "minus infinity"

struct Top2 {
  float v1;
  int j1;
  float v2;
};

// Candidates reach a lane in increasing column order: a tie keeps the
// earlier column and lifts v2 to v1.
__device__ __forceinline__ void push(Top2& t, float v, int j) {
  if (v > t.v1) {
    t.v2 = t.v1;
    t.v1 = v;
    t.j1 = j;
  } else if (v > t.v2) {
    t.v2 = v;
  }
}

// Top-2 of the union of two disjoint column sets; the lower column wins a
// tie of the best values.
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = a.v1 > b.v1 || (a.v1 == b.v1 && a.j1 < b.j1);
  Top2 w = a_wins ? a : b;
  const float lv1 = a_wins ? b.v1 : a.v1;
  w.v2 = fmaxf(w.v2, lv1);
  return w;
}

__global__ void __launch_bounds__(kThreads)
bid_top2_kernel(const float* __restrict__ x, const float* __restrict__ c,
                const float* __restrict__ p, float* __restrict__ v1_out,
                int64_t* __restrict__ j1_out, float* __restrict__ v2_out,
                int m, int k, int d) {
  __shared__ float cs[kTileD][kTileK + 1];
  __shared__ float xs[kRowsPerCta][kTileD];
  __shared__ float bias[kTileK];

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* xg = x + static_cast<size_t>(g) * m * d;
  const float* cg = c + static_cast<size_t>(g) * k * d;
  const float* pg = p + static_cast<size_t>(g) * k;

  Top2 best[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) best[i] = {-INFINITY, INT32_MAX, -INFINITY};

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < kColsPerLane; ++t) acc[i][t] = 0.f;
    float cn = 0.f;  // ||c_{k0 + threadIdx.x}||^2, threads < kTileK

    for (int d0 = 0; d0 < d; d0 += kTileD) {
      const int dt = min(kTileD, d - d0);
      __syncthreads();  // the previous tile's readers are done
      for (int e = threadIdx.x; e < kTileK * kTileD; e += kThreads) {
        const int jj = e / kTileD, dd = e % kTileD;
        const int col = k0 + jj;
        cs[dd][jj] = (col < k && dd < dt)
                         ? cg[static_cast<size_t>(col) * d + d0 + dd] : 0.f;
      }
      for (int e = threadIdx.x; e < kRowsPerCta * kTileD; e += kThreads) {
        const int r = e / kTileD, dd = e % kTileD;
        const int row = row0 + r;
        xs[r][dd] = (row < m && dd < dt)
                        ? xg[static_cast<size_t>(row) * d + d0 + dd] : 0.f;
      }
      __syncthreads();
      if (threadIdx.x < kTileK) {
        for (int dd = 0; dd < dt; ++dd) {
          const float v = cs[dd][threadIdx.x];
          cn = fmaf(v, v, cn);
        }
      }
      for (int dd = 0; dd < dt; ++dd) {
        float xv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) xv[i] = xs[warp * kRowsPerWarp + i][dd];
#pragma unroll
        for (int t = 0; t < kColsPerLane; ++t) {
          const float cv = cs[dd][lane + 32 * t];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][t] = fmaf(xv[i], cv, acc[i][t]);
        }
      }
    }
    if (threadIdx.x < kTileK) {
      const int col = k0 + threadIdx.x;
      bias[threadIdx.x] = col < k ? cn - pg[col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int jj = lane + 32 * t;
      const int col = k0 + jj;
      if (col < k) {
        const float b = bias[jj];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) push(best[i], -2.f * acc[i][t] + b, col);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    Top2 t = best[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o;
      o.v1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
      o.j1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
      o.v2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
      t = merge(t, o);
    }
    const int row = row0 + warp * kRowsPerWarp + i;
    if (lane == 0 && row < m) {
      const size_t o = static_cast<size_t>(g) * m + row;
      v1_out[o] = t.v1;
      j1_out[o] = t.j1;
      v2_out[o] = fmaxf(t.v2, kNeg);  // k == 1: the reference's sentinel
    }
  }
}

}  // namespace

// x (G, m, d), c (G, k, d), p (G, k) float32, contiguous, on one device;
// v1, v2 (G, m) float32 and j1 (G, m) int64 are written.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int bid_top2_f32(const float* x, const float* c, const float* p,
                            float* v1, int64_t* j1, float* v2, int G, int m,
                            int k, int d, void* stream) {
  if (G <= 0 || m <= 0) return 0;
  const dim3 grid((m + kRowsPerCta - 1) / kRowsPerCta, G);
  bid_top2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, c, p, v1, j1, v2, m, k, d);
  return static_cast<int>(cudaGetLastError());
}
