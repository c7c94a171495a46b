// Fused row gather + auction bidding reduction for Hopper (sm_90a):
// bid_top2(x[clip(idx, 0, n - 1)], c, p) without writing x[idx].
//
// Replaces the TPU kernel `_bid_gather_kernel` (with the 2-slot DMA ring
// of per-row copies that `_issue_block` / `_wait_block` drive) behind
// `bid_top2_gather_pallas` in src/repro/kernels/gather.py.  Reached through
// `repro_torch.kernels.ops.bid_top2(x, c, prices, idx=idx)` for d <= 512.
//
// What bounds it on this card: at the streaming chunk's shape (m = 8192
// indexed rows of a 253 680 x 22 table, k = 256) it does 92 MFLOP of fp32
// FMA and moves about 0.9 MB (the indexed rows, c, and three (m,) outputs):
// 1.4 us of operations at 67 TFLOP/s against 0.27 us of bytes, so fp32
// operations bound it.
//
// Design: the kernel of bid_top2.cu (bid_top2.cuh), with one difference:
// the CTA stages its rows through the index, each clipped to [0, n - 1],
// while the TMA brings c.  At 8192 rows the launch takes the wide tile (32
// rows a CTA, 4 rows by 8 columns a lane: 256 CTAs).  The gathered rows
// live only in the CTA's shared-memory tile, never in global memory.  The
// TPU kernel's DMA ring overlaps row copies on an in-order core; on Hopper
// many CTAs in flight hide the latency of the scattered row reads instead.
// The top-2 merge, the tie rule (lowest column; a doubled maximum gives
// v2 == v1), the masking of columns past k and the fp32 FMA order are those
// of bid_top2.cu, so the result is bitwise bid_top2(gather_rows(x, idx),
// ...).

#include "bid_top2.cuh"

// x (n, d), c (k, d), p (k,) float32 contiguous; idx (m,) int32
// (idx_is_64 == 0) or int64; v1, v2 (m,) float32 and j1 (m,) int64 are
// written.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int bid_top2_gather_f32(const float* x, const void* idx,
                                   int idx_is_64, const float* c,
                                   const float* p, float* v1, int64_t* j1,
                                   float* v2, int64_t n, int m, int k, int d,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = idx_is_64
      ? bid::launch(x, static_cast<const int64_t*>(idx), n, c, p, v1,
                    j1, v2, 1, 1, m, k, d, s)
      : bid::launch(x, static_cast<const int32_t*>(idx), n, c, p, v1,
                    j1, v2, 1, 1, m, k, d, s);
  return static_cast<int>(err);
}
