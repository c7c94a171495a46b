// Row gather for Hopper (sm_90a): out[r, :] = x[clip(idx[r], 0, n - 1), :].
//
// Replaces the TPU kernel `_gather_kernel` (with the 2-slot DMA ring of
// per-row copies that its two helpers start and await) behind
// `gather_rows_pallas` in src/repro/kernels/gather.py.  The streaming ABA
// core calls it once per chunk to pull the chunk's rows in centrality
// order.
//
// What bounds it on this card: bytes.  At the main shape (m = 8192 rows,
// d = 22) it reads and writes 8192 * 22 * 4 bytes each, about 1.4 MB, which
// takes 0.43 us at 3.35 TB/s, so the launch dominates here too.  The TPU
// kernel's DMA ring exists to overlap row copies with compute on a core
// that runs its grid in order; on Hopper many CTAs in flight hide the
// latency of independent row reads instead, so the ring is dropped.
//
// Design: the output is walked flat, one element (or one float4) per
// thread, grid-stride.  Consecutive threads read consecutive words of a
// row, so a warp covers one row or, for small d, a few rows, and every
// read is coalesced within a row.  When d % 4 == 0 and both pointers are
// 16-byte aligned each thread moves a float4 (16-byte loads and stores);
// otherwise it moves single floats.  The index is clipped in the kernel and
// may be int32 or int64.  One pass, no atomics: the result is a bitwise
// copy of the source rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 CTAs per SM cover the card

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ x, const Idx* __restrict__ idx,
                   T* __restrict__ out, int64_t n, int64_t m, int64_t w) {
  const int64_t total = m * w;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += step) {
    const int64_t r = e / w;
    const int64_t col = e - r * w;
    int64_t s = static_cast<int64_t>(idx[r]);
    s = s < 0 ? 0 : (s >= n ? n - 1 : s);
    out[e] = x[s * w + col];
  }
}

template <typename Idx>
cudaError_t launch(const float* x, const Idx* idx, float* out, int64_t n,
                   int64_t m, int64_t d, cudaStream_t stream) {
  const bool vec = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t w = vec ? d / 4 : d;
  const int64_t blocks64 = (m * w + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks64 < kMaxBlocks ? blocks64 : kMaxBlocks);
  if (vec) {
    gather_rows_kernel<float4, Idx><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), idx, reinterpret_cast<float4*>(out),
        n, m, w);
  } else {
    gather_rows_kernel<float, Idx><<<blocks, kThreads, 0, stream>>>(
        x, idx, out, n, m, w);
  }
  return cudaGetLastError();
}

}  // namespace

// x (n, d) float32 contiguous, idx (m,) int32 (idx_is_64 == 0) or int64,
// out (m, d) float32 contiguous.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int gather_rows_f32(const float* x, const void* idx, int idx_is_64,
                               float* out, int64_t n, int64_t m, int64_t d,
                               void* stream) {
  if (m <= 0 || d <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = idx_is_64
      ? launch(x, static_cast<const int64_t*>(idx), out, n, m, d, s)
      : launch(x, static_cast<const int32_t*>(idx), out, n, m, d, s);
  return static_cast<int>(err);
}
