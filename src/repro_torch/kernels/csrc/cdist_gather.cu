// Fused row gather + squared-distance matrix for Hopper (sm_90a):
// cdist(x[clip(idx, 0, n - 1)], c) without writing x[idx].
//
// Replaces the TPU kernel `_cdist_gather_kernel` (with the 2-slot DMA ring
// of per-row copies that `_issue_block` / `_wait_block` drive) behind
// `cdist_gather_pallas` in src/repro/kernels/gather.py.  Reached through
// `repro_torch.kernels.cdist(x, c, idx=idx)` for d <= 512.
//
// What bounds it on this card: bytes.  At one streaming chunk (m = 8192
// indexed rows of a 253 680 x 22 table, nc = 256) the (m, nc) output is
// 8.4 MB of ~9.1 MB moved, 2.7 us at 3.35 TB/s, against 92 MFLOP, 1.4 us
// at 67 TFLOP/s.
//
// Design: the kernel of cdist.cu (cdist.cuh), with one difference.  The
// warp that stages a row loads its index, clips it to [0, n - 1] and
// copies the row's features by cp.async, with no barrier between the two;
// the gathered rows exist only in the CTA's shared-memory stage, never in
// global memory, and ||x_i||^2 is summed from those staged rows, as the TPU
// kernel sums it from its landed scratch rows.  The TPU kernel's DMA ring
// overlaps row copies on an in-order core; on Hopper the 32-row tiles make
// this shape 512 CTAs, all resident at once, whose short chains (index,
// row, 22 FMA steps, stores) overlap one another.  The arithmetic is
// cdist.cu's, so the result is bitwise cdist(gather_rows(x, idx), c).

#include "cdist.cuh"

// x (n, d), c (nc, d) float32 contiguous; idx (m,) int32 (idx_is_64 == 0)
// or int64; out (m, nc) float32 is written.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int cdist_gather_f32(const float* x, const void* idx,
                                int idx_is_64, const float* c, float* out,
                                int64_t n, int64_t m, int nc, int d,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = idx_is_64
      ? cdist::launch(x, static_cast<const int64_t*>(idx), n, c, out, m, nc,
                      d, s)
      : cdist::launch(x, static_cast<const int32_t*>(idx), n, c, out, m, nc,
                      d, s);
  return static_cast<int>(err);
}
