// The squared-distance tile kernel shared by cdist.cu (rows read in place)
// and cdist_gather.cu (rows read through a clipped index).  See cdist.cu
// for what it replaces, what bounds it and its design.
//
//     out[i, j] = ||x_i||^2 - 2 x_i . c_j + ||c_j||^2
//
// The two instantiations differ only in where a CTA's rows start in x
// (`row_offset`); the arithmetic is one code path.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cdist {

constexpr int kThreads = 256;
constexpr int kPerM = 4;           // rows per thread: ty + 16 i
constexpr int kPerN = 8;           // columns per thread: tx + 16 j
constexpr int kTileM = 16 * kPerM; // rows of x per CTA
constexpr int kTileN = 16 * kPerN; // columns (rows of c) per CTA
constexpr int kTileD = 32;         // features per shared-memory stage
constexpr int kMaxGridY = 65535;

// Element offset in x of row `row`: row * d in place (Idx = void), or
// clip(idx[row], 0, n - 1) * d through the index.
template <typename Idx>
__device__ __forceinline__ int64_t row_offset(const Idx* idx, int64_t n,
                                              int64_t row, int d) {
  if constexpr (std::is_void_v<Idx>) {
    return row * d;
  } else {
    int64_t s = static_cast<int64_t>(idx[row]);
    s = s < 0 ? 0 : (s >= n ? n - 1 : s);
    return s * d;
  }
}

// x: (m, d) rows in place, or the (n, d) table read through idx (m,);
// c (nc, d); out (m, nc).  grid = (ceil(m / 64), ceil(nc / 128)).
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
cdist_kernel(const float* __restrict__ x, const Idx* __restrict__ idx,
             int64_t n, const float* __restrict__ c, float* __restrict__ out,
             int64_t m, int nc, int d) {
  // feature-major tiles, padded by one word: the staging stores (threads
  // walk the features of a row) and the inner-loop reads are free of bank
  // conflicts
  __shared__ float xs[kTileD][kTileM + 1];
  __shared__ float cs[kTileD][kTileN + 1];
  __shared__ float xn[kTileM];
  __shared__ float cn[kTileN];
  __shared__ int64_t xoff[kTileM];  // -1 past the last row

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int col0 = blockIdx.y * kTileN;
  const int tx = threadIdx.x % 16;  // columns tx + 16 j
  const int ty = threadIdx.x / 16;  // rows ty + 16 i

  if (threadIdx.x < kTileM) {  // read by the staging after a barrier
    const int64_t row = row0 + threadIdx.x;
    xoff[threadIdx.x] = row < m ? row_offset(idx, n, row, d) : -1;
  }
  float norm = 0.f;  // ||x||^2 (threads < 64) or ||c||^2 (threads 64..191)
  float acc[kPerM][kPerN];
#pragma unroll
  for (int i = 0; i < kPerM; ++i)
#pragma unroll
    for (int j = 0; j < kPerN; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kTileD) {
    const int dt = min(kTileD, d - d0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kTileM * kTileD; e += kThreads) {
      const int r = e / kTileD, dd = e % kTileD;
      const int64_t off = xoff[r];
      xs[dd][r] = (off >= 0 && dd < dt) ? x[off + d0 + dd] : 0.f;
    }
    for (int e = threadIdx.x; e < kTileN * kTileD; e += kThreads) {
      const int jj = e / kTileD, dd = e % kTileD;
      const int col = col0 + jj;
      cs[dd][jj] = (col < nc && dd < dt)
                       ? c[static_cast<int64_t>(col) * d + d0 + dd] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < kTileM) {
      for (int dd = 0; dd < dt; ++dd) {
        const float v = xs[dd][threadIdx.x];
        norm = fmaf(v, v, norm);
      }
    } else if (threadIdx.x < kTileM + kTileN) {
      for (int dd = 0; dd < dt; ++dd) {
        const float v = cs[dd][threadIdx.x - kTileM];
        norm = fmaf(v, v, norm);
      }
    }
    for (int dd = 0; dd < dt; ++dd) {
      float xv[kPerM], cv[kPerN];
#pragma unroll
      for (int i = 0; i < kPerM; ++i) xv[i] = xs[dd][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kPerN; ++j) cv[j] = cs[dd][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPerM; ++i)
#pragma unroll
        for (int j = 0; j < kPerN; ++j) acc[i][j] = fmaf(xv[i], cv[j], acc[i][j]);
    }
  }
  if (threadIdx.x < kTileM) {
    xn[threadIdx.x] = norm;
  } else if (threadIdx.x < kTileM + kTileN) {
    cn[threadIdx.x - kTileM] = norm;
  }
  __syncthreads();

  // 16 neighbouring threads write 16 neighbouring columns of a row
#pragma unroll
  for (int i = 0; i < kPerM; ++i) {
    const int r = ty + 16 * i;
    const int64_t row = row0 + r;
    if (row >= m) continue;
    float* orow = out + row * nc;
#pragma unroll
    for (int j = 0; j < kPerN; ++j) {
      const int jj = tx + 16 * j;
      const int col = col0 + jj;
      if (col < nc) orow[col] = (xn[r] - 2.f * acc[i][j]) + cn[jj];
    }
  }
}

template <typename Idx>
cudaError_t launch(const float* x, const Idx* idx, int64_t n, const float* c,
                   float* out, int64_t m, int nc, int d, cudaStream_t stream) {
  if (m <= 0 || nc <= 0) return cudaSuccess;
  const int64_t gx = (m + kTileM - 1) / kTileM;
  const int64_t gy = (nc + kTileN - 1) / kTileN;
  if (gx > INT32_MAX || gy > kMaxGridY) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cdist_kernel<Idx><<<grid, kThreads, 0, stream>>>(x, idx, n, c, out, m, nc, d);
  return cudaGetLastError();
}

}  // namespace cdist
