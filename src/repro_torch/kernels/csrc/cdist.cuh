// The squared-distance tile kernel shared by cdist.cu (rows read in place)
// and cdist_gather.cu (rows read through a clipped index).  See cdist.cu
// for what it replaces and what bounds it.
//
//     out[i, j] = ||x_i||^2 - 2 x_i . c_j + ||c_j||^2
//
// The two instantiations differ only in where a row starts in x
// (`row_offset`); the arithmetic is one code path.
//
// Design, for the H100 (the output is the whole bound: 260 MB at the
// diabetes shape, five times the L2):
//   * Persistent CTAs: a CTA of 128 threads owns 128 columns (grid y) and
//     walks the 32-row tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the
//     grid is as many CTAs as fit on the card at once (fewer if there are
//     fewer tiles).  So ||c||^2 is summed once per CTA, not per tile, and
//     c is staged once per CTA where d fits one stage.
//   * Rows and centroids are staged in stages of kTileD features by
//     cp.async (4-byte copies: a gathered row may start anywhere), double
//     buffered: the next stage's copies are in flight while this stage's
//     FMAs run and the previous tile's stores drain.  A warp copies whole
//     rows (a lane a feature): it loads the indices of its 8 rows first,
//     all in flight at once, then issues the rows' coalesced reads, with no
//     barrier between the two.
//   * Each thread keeps a 4 x 8 block of sums in registers: rows ty + 8 i,
//     columns 4 tx + 64 h + (0..3), so a feature step reads 4 row words
//     (two addresses a warp, broadcast) and 2 float4s of c for 32 FMA.
//     fp32 FMA on the CUDA cores: a TF32 product keeps ~3 decimal digits
//     and would break parity with the float32 reference.
//   * ||x_i||^2 is summed by each thread for its rows in the same loop
//     (4 FMA a step beside the 32), and ||c_j||^2 for its columns during
//     the CTA's first tile (8 more), from the staged stages.  Both are the
//     sequential fmaf chain over d from 0, and the value is
//     (||x||^2 - 2 x.c) + ||c||^2, the reference's order.
//   * Stores: a thread writes float4s (16 lanes cover 256 contiguous bytes
//     of a row) with the evict-first hint (st.global.cs), so the output
//     streams past L2 instead of evicting the inputs; scalar stores where
//     nc is not a multiple of 4.  Ragged edges are masked; no padded copy
//     of x or c is made.  One pass, no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cdist {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerM = 4;                   // rows per thread: ty + 8 i
constexpr int kVecs = 2;                   // float4s per thread: 4 tx + 64 h
constexpr int kTileM = 8 * kPerM;          // rows per tile
constexpr int kTileN = 16 * 4 * kVecs;     // columns per CTA
constexpr int kTileD = 24;                 // features per stage (<= 32)
constexpr int kLdc = kTileN + 8;           // c stage stride, float4-aligned
constexpr int kRowsPerWarp = kTileM / kWarps;  // rows a warp stages
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

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait for all but the newest `pending` (0 or 1) groups of copies.
__device__ __forceinline__ void wait_copies(bool pending) {
  if (pending) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

// One stage of FMAs: a thread's 4 x 8 sums over the stage's dt features,
// with ||x||^2 of its rows and, on a CTA's first tile (kNorms), ||c||^2 of
// its columns, each the sequential chain over the features.
template <bool kNorms>
__device__ __forceinline__ void stage_fma(const float* xb, const float* cb,
                                          int dt, float (&acc)[kPerM][4 * kVecs],
                                          float (&xn)[kPerM],
                                          float (&cn)[4 * kVecs]) {
#pragma unroll 4
  for (int dd = 0; dd < dt; ++dd) {
    float xv[kPerM];
    float4 cv[kVecs];
#pragma unroll
    for (int i = 0; i < kPerM; ++i) xv[i] = xb[8 * i * kTileD + dd];
#pragma unroll
    for (int h = 0; h < kVecs; ++h) {
      cv[h] = *reinterpret_cast<const float4*>(cb + dd * kLdc + 64 * h);
    }
    if constexpr (kNorms) {
#pragma unroll
      for (int h = 0; h < kVecs; ++h) {
        cn[4 * h + 0] = fmaf(cv[h].x, cv[h].x, cn[4 * h + 0]);
        cn[4 * h + 1] = fmaf(cv[h].y, cv[h].y, cn[4 * h + 1]);
        cn[4 * h + 2] = fmaf(cv[h].z, cv[h].z, cn[4 * h + 2]);
        cn[4 * h + 3] = fmaf(cv[h].w, cv[h].w, cn[4 * h + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerM; ++i) {
      xn[i] = fmaf(xv[i], xv[i], xn[i]);
#pragma unroll
      for (int h = 0; h < kVecs; ++h) {
        acc[i][4 * h + 0] = fmaf(xv[i], cv[h].x, acc[i][4 * h + 0]);
        acc[i][4 * h + 1] = fmaf(xv[i], cv[h].y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(xv[i], cv[h].z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(xv[i], cv[h].w, acc[i][4 * h + 3]);
      }
    }
  }
}

// x: (m, d) rows in place, or the (n, d) table read through idx (m,);
// c (nc, d); out (m, nc).  grid = (CTAs along the rows, ceil(nc / 128)).
// vec_out: nc is a multiple of 4 and out 16-byte aligned.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
cdist_kernel(const float* __restrict__ x, const Idx* __restrict__ idx,
             int64_t n, const float* __restrict__ c, float* __restrict__ out,
             int64_t m, int nc, int d, bool vec_out) {
  // rows row-major, a row's features at stride kTileD (two rows a warp
  // reads differ by kTileD words: other banks); c feature-major
  __shared__ __align__(16) float xs[2][kTileM * kTileD];
  __shared__ __align__(16) float cs[2][kTileD * kLdc];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;  // columns 4 tx + 64 h + (0..3)
  const int ty = tid >> 4;  // rows ty + 8 i
  const int col0 = blockIdx.y * kTileN;
  const int64_t n_tiles = (m + kTileM - 1) / kTileM;
  const int chunks = d > kTileD ? (d + kTileD - 1) / kTileD : 1;
  const bool c_resident = chunks == 1;  // c staged once, in cs[0]
  const int64_t my_tiles =
      (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t stages = my_tiles * chunks;

  // Issue the copies of stage s (tile, chunk) into buffer s & 1.
  auto issue = [&](int64_t s) {
    const int buf = static_cast<int>(s & 1);
    const int chunk = static_cast<int>(s % chunks);
    const int64_t row0 = (blockIdx.x + (s / chunks) * gridDim.x) * kTileM;
    const int d0 = chunk * kTileD;
    const int dt = min(kTileD, d - d0);
    if (lane < dt) {
      // the rows' offsets first (a gather's index loads all in flight at
      // once), then the rows' copies, the long pole, then c's
      int64_t off[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int64_t row = row0 + warp + kWarps * k;
        off[k] = row < m ? row_offset(idx, n, row, d) + d0 + lane : -1;
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        if (off[k] >= 0) {
          copy4(&xs[buf][(warp + kWarps * k) * kTileD + lane], x + off[k]);
        }
      }
      if (!c_resident || s == 0) {
        float* cb = cs[c_resident ? 0 : buf] + lane * kLdc;
        for (int jj = warp; jj < kTileN; jj += kWarps) {
          const int col = col0 + jj;
          if (col < nc) {
            copy4(cb + jj, c + static_cast<int64_t>(col) * d + d0 + lane);
          } else {
            cb[jj] = 0.f;
          }
        }
      }
    }
    commit();
  };

  if (stages > 0) issue(0);

  float acc[kPerM][4 * kVecs];
  float xn[kPerM];
  float cn[4 * kVecs];  // ||c||^2 of the thread's columns, from the first tile
#pragma unroll
  for (int j = 0; j < 4 * kVecs; ++j) cn[j] = 0.f;
#pragma unroll 1
  for (int64_t s = 0; s < stages; ++s) {
    const bool more = s + 1 < stages;
    if (more) issue(s + 1);
    wait_copies(more);
    __syncthreads();
    const int buf = static_cast<int>(s & 1);
    const int chunk = static_cast<int>(s % chunks);
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < kPerM; ++i) {
        xn[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4 * kVecs; ++j) acc[i][j] = 0.f;
      }
    }
    const int dt = min(kTileD, d - chunk * kTileD);
    const float* xb = xs[buf] + ty * kTileD;
    const float* cb = cs[c_resident ? 0 : buf] + 4 * tx;
    if (s < chunks) {
      stage_fma<true>(xb, cb, dt, acc, xn, cn);
    } else {
      stage_fma<false>(xb, cb, dt, acc, xn, cn);
    }
    if (chunk == chunks - 1) {
      const int64_t row0 = (blockIdx.x + (s / chunks) * gridDim.x) * kTileM;
#pragma unroll
      for (int i = 0; i < kPerM; ++i) {
        const int64_t row = row0 + ty + 8 * i;
        if (row >= m) continue;
        float* orow = out + row * nc;
#pragma unroll
        for (int h = 0; h < kVecs; ++h) {
          const int col = col0 + 4 * tx + 64 * h;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = (xn[i] - 2.f * acc[i][4 * h + q]) + cn[4 * h + q];
          }
          if (vec_out) {
            if (col < nc) {
              __stcs(reinterpret_cast<float4*>(orow + col),
                     make_float4(v[0], v[1], v[2], v[3]));
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (col + q < nc) __stcs(orow + col + q, v[q]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage's buffers are read: the next issue may refill
  }
}

template <typename Idx>
cudaError_t launch(const float* x, const Idx* idx, int64_t n, const float* c,
                   float* out, int64_t m, int nc, int d, cudaStream_t stream) {
  if (m <= 0 || nc <= 0) return cudaSuccess;
  const int64_t tiles = (m + kTileM - 1) / kTileM;
  const int64_t gy = (nc + kTileN - 1) / kTileN;
  if (gy > kMaxGridY) return cudaErrorInvalidConfiguration;
  // as many CTAs as fit on the card at once (per process: one card model)
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cdist_kernel<Idx>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  int64_t gx = resident / gy;
  gx = gx < 1 ? 1 : (gx > tiles ? tiles : gx);
  const bool vec_out = nc % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cdist_kernel<Idx><<<grid, kThreads, 0, stream>>>(x, idx, n, c, out, m, nc, d,
                                                  vec_out);
  return cudaGetLastError();
}

}  // namespace cdist
