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
// takes 0.43 us at 3.35 TB/s, so a launch's fixed cost dominates; the design
// keeps the per-element work to a load and a store.  The TPU kernel's DMA
// ring exists to overlap row copies with compute on a core that runs its
// grid in order; on Hopper many warps in flight hide the latency of
// independent row reads instead, so the ring is dropped.
//
// Design: rows, not elements, are mapped to lanes.  A row is a team of
// L = 1, 2, ..., 32 consecutive lanes (the power of two that covers its
// words, at most 32), so a warp copies 32 / L rows at once and consecutive
// lanes touch consecutive words of a row: every access is coalesced within
// the row.  The team's first lane reads and clips idx[r] once and shuffles
// it to the team.  A word is 16 bytes when d % 4 == 0, 8 bytes when d is
// even, else 4, each where both pointers are aligned to it.  Offsets are
// 32-bit where n * d and m * d fit, and one wave of CTAs strides over the
// rows.  One pass, no atomics: the result is a bitwise copy of the source
// rows, for int32 or int64 indices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <typename V, typename Idx, typename Off>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ x, const Idx* __restrict__ idx,
                   V* __restrict__ out, Off n, Off m, int w, int team_shift) {
  const int lane = threadIdx.x & 31;
  const int team = 1 << team_shift;
  const int sub = lane & (team - 1);
  const int leader = lane & ~(team - 1);
  const Off rows_per_warp = 32 >> team_shift;
  const Off warp0 = (static_cast<Off>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const Off warps = (static_cast<Off>(gridDim.x) * kThreads) >> 5;
  for (Off r = warp0 * rows_per_warp + (lane >> team_shift); r - (lane >> team_shift) < m;
       r += warps * rows_per_warp) {
    Off s = 0;
    if (sub == 0 && r < m) {
      const int64_t v = static_cast<int64_t>(idx[r]);
      s = static_cast<Off>(v < 0 ? 0 : (v >= n ? n - 1 : v));
    }
    s = __shfl_sync(0xffffffffu, s, leader);
    if (r < m) {
      const V* src = x + s * w;
      V* dst = out + r * w;
      for (int col = sub; col < w; col += team) dst[col] = src[col];
    }
  }
}

int sm_count() {
  static int cache[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev >= kMaxDevices) dev = kMaxDevices - 1;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 132;
  }
  return cache[dev];
}

template <typename V, typename Idx>
cudaError_t launch(const float* x, const Idx* idx, float* out, int64_t n,
                   int64_t m, int64_t d, cudaStream_t stream) {
  const int w = static_cast<int>(d / (sizeof(V) / sizeof(float)));
  int team_shift = 0;
  while ((1 << team_shift) < w && team_shift < 5) ++team_shift;
  const int64_t rows_per_cta = (kThreads / 32) * (32 >> team_shift);
  const int64_t need = (m + rows_per_cta - 1) / rows_per_cta;
  const int64_t wave = static_cast<int64_t>(sm_count()) * (2048 / kThreads);
  const int blocks = static_cast<int>(need < wave ? need : wave);
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out);
  const int64_t lim = int64_t(1) << 31;  // r runs up to m + one stride
  if (n * d < lim && (m + static_cast<int64_t>(blocks) * kThreads) * d < lim) {
    gather_rows_kernel<V, Idx, int32_t><<<blocks, kThreads, 0, stream>>>(
        xv, idx, ov, static_cast<int32_t>(n), static_cast<int32_t>(m), w, team_shift);
  } else {
    gather_rows_kernel<V, Idx, int64_t><<<blocks, kThreads, 0, stream>>>(
        xv, idx, ov, n, m, w, team_shift);
  }
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t launch_any(const float* x, const Idx* idx, float* out, int64_t n,
                       int64_t m, int64_t d, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (d % 4 == 0 && align % 16 == 0) return launch<float4>(x, idx, out, n, m, d, stream);
  if (d % 2 == 0 && align % 8 == 0) return launch<float2>(x, idx, out, n, m, d, stream);
  return launch<float>(x, idx, out, n, m, d, stream);
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
      ? launch_any(x, static_cast<const int64_t*>(idx), out, n, m, d, s)
      : launch_any(x, static_cast<const int32_t*>(idx), out, n, m, d, s);
  return static_cast<int>(err);
}
