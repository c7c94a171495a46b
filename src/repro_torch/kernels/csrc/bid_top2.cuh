// The fused auction bidding reduction shared by bid_top2.cu (rows read in
// place) and bid_top2_gather.cu (rows read through a clipped index).  See
// bid_top2.cu for what it replaces, what bounds it and its design.
//
// Per row i of group g it returns the best value v1, its column j1 and the
// second-best value v2 of
//
//     value[i, j] = -2 x_i . c_j + ||c_j||^2 - p_j
//
// over the k columns j.  The two instantiations differ only in where a
// CTA's rows start in x (`row_offset`); the arithmetic is one code path.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace bid {

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
// earlier column and lifts v2 to v1.  Written as selects, not branches: a
// kernel whose lone warp pushes a chain of columns pays for every branch.
__device__ __forceinline__ void push(Top2& t, float v, int j) {
  const bool first = v > t.v1;
  t.v2 = first ? t.v1 : (v > t.v2 ? v : t.v2);
  t.j1 = first ? j : t.j1;
  t.v1 = first ? v : t.v1;
}

// A value from its dot-product chain acc = x_i . c_j (sequential fmaf over d
// from 0) and b = ||c_j||^2 - p_j.  Every kernel forms values here, so the
// compiler rounds the expression the same way in all of them.
__device__ __forceinline__ float value(float acc, float b) { return -2.f * acc + b; }

// Top-2 of the union of two disjoint column sets; the lower column wins a
// tie of the best values.
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  // `|` and `&`, not `||` and `&&`: no short-circuit branch
  const bool a_wins = (a.v1 > b.v1) | ((a.v1 == b.v1) & (a.j1 < b.j1));
  Top2 w = a_wins ? a : b;
  const float lv1 = a_wins ? b.v1 : a.v1;
  w.v2 = fmaxf(w.v2, lv1);
  return w;
}

// Element offset in x of row `row` of group g: (g * m + row) * d in place
// (Idx = void), or clip(idx[row], 0, n - 1) * d through the index.
template <typename Idx>
__device__ __forceinline__ int64_t row_offset(const Idx* idx, int64_t n,
                                              int g, int m, int row, int d) {
  if constexpr (std::is_void_v<Idx>) {
    return (static_cast<int64_t>(g) * m + row) * d;
  } else {
    int64_t s = static_cast<int64_t>(idx[row]);
    s = s < 0 ? 0 : (s >= n ? n - 1 : s);
    return s * d;
  }
}

// x: the rows (G, m, d) in place, or the (n, d) table read through idx
// (G == 1); c (G, k, d); p (G, k).
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
bid_top2_kernel(const float* __restrict__ x, const Idx* __restrict__ idx,
                int64_t n, const float* __restrict__ c,
                const float* __restrict__ p, float* __restrict__ v1_out,
                int64_t* __restrict__ j1_out, float* __restrict__ v2_out,
                int m, int k, int d) {
  __shared__ float cs[kTileD][kTileK + 1];
  __shared__ float xs[kRowsPerCta][kTileD];
  __shared__ float bias[kTileK];
  __shared__ int64_t xoff[kRowsPerCta];  // -1 past the last row

  const int g = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerCta;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* cg = c + static_cast<size_t>(g) * k * d;
  const float* pg = p + static_cast<size_t>(g) * k;

  if (threadIdx.x < kRowsPerCta) {  // read by the staging after a barrier
    const int row = row0 + threadIdx.x;
    xoff[threadIdx.x] = row < m ? row_offset(idx, n, g, m, row, d) : -1;
  }

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
        const int64_t off = xoff[r];
        xs[r][dd] = (off >= 0 && dd < dt) ? x[off + d0 + dd] : 0.f;
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
        for (int i = 0; i < kRowsPerWarp; ++i) push(best[i], value(acc[i][t], b), col);
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

template <typename Idx>
cudaError_t launch(const float* x, const Idx* idx, int64_t n, const float* c,
                   const float* p, float* v1, int64_t* j1, float* v2, int G,
                   int m, int k, int d, cudaStream_t stream) {
  if (G <= 0 || m <= 0) return cudaSuccess;
  const dim3 grid((m + kRowsPerCta - 1) / kRowsPerCta, G);
  bid_top2_kernel<Idx><<<grid, kThreads, 0, stream>>>(x, idx, n, c, p, v1, j1,
                                                       v2, m, k, d);
  return cudaGetLastError();
}

}  // namespace bid
