// Fused auction bidding reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bid_kernel` behind `bid_top2_pallas` in
// src/repro/kernels/bid_top2.py.  Per row i of group g it returns the best
// value v1, its column j1 and the second-best value v2 of
//
//     value[i, j] = -2 x_i . c_j + ||c_j||^2 - p_j
//
// over the k columns j, without ever writing the (m, k) value matrix.  The
// kernel lives in bid_top2.cuh, shared with bid_top2_gather.cu.
//
// What bounds it on this card: at the auction's shape (m = k = 256, d = 22)
// one call is 2.9 MFLOP and moves about 50 KB, well under a microsecond of
// either.  What it takes is latency: the launch, one trip to L2 for c, the
// dependent fmaf chains and the merge of the top-2s.  So the design covers
// the card with short CTAs, each making one trip for its data:
//   * The tile is chosen by the launch: while it takes at most 512 CTAs, a
//     CTA of 8 warps holds 4 rows and a lane one column (the 8 warps split
//     256 columns), so m = 256 is 64 CTAs; above that a CTA holds 32 rows
//     and a lane 4 rows by 8 columns (a streaming chunk's 8192 rows is 256
//     CTAs), so c is staged less often and a shuffle merges more columns.
//   * Where the CTA's whole k x d block of c fits (22.5 KB at the main
//     shape, 16-byte aligned), one thread fetches it with one TMA bulk copy
//     (cp.async.bulk, completing on an mbarrier) while the other threads
//     stage the CTA's rows; d is not padded, and even rows are read as
//     8-byte pairs, free of bank conflicts.  Otherwise the threads stage
//     passes of 256 columns by feature tiles, rows padded to an odd length:
//     3.4x the bulk copy's device time at the main shape on an H100 80GB
//     HBM3 at 700 W (0.0113 against 0.0033 ms, chip_smoke.py phase 2 with
//     c off the 16-byte grid; PERF.md), so the bulk copy stays beside it.
//   * Each lane forms ||c_j||^2 of its own columns, so the narrow tile forms
//     it once a column.
//   * The stacked (G, m, d) x (G, k, d) form is grid axis y, so a group's
//     result never depends on G; grid axis z is the slot of the span's pair
//     (`bid_top2_span_f32`): slot 1 bids with -x (negated as it is staged,
//     which is exact) at prices 2 ||c_j||^2, slot 0 with x at zero prices.
//     Slot 1 bids with the bias -||c_j||^2 of its own chain, which is
//     ||c_j||^2 - 2 ||c_j||^2 exactly, so the span takes one launch at any
//     G, reads no prices, and a group's span (and with it the LAP's eps
//     schedule) does not depend on G.
//   * The bits do not depend on the tile, the pass or the slot: every value
//     is bid::value of the sequential fmaf chain of x_i . c_j from 0 over d
//     in order and of ||c_j||^2 (the same chain) less p_j; a lane pushes its
//     columns in increasing order and lanes, warps and column groups are
//     merged by bid::merge, which is order-free (larger value, then lower
//     column; a maximum that occurs twice gives v2 == v1), as in
//     `_bid_kernel`'s merge and in `bid_top2_ref`.  fp32 FMA on the CUDA
//     cores: no TF32 rounding can flip an argmax; no atomics.
//   * Columns past k are masked inside the kernel and never win; j1 is
//     written as int64, the index type PyTorch's gather and scatter take.

#include "bid_top2.cuh"

// x (G, m, d), c (G, k, d), p (G, k) float32, contiguous, on one device;
// v1, v2 (G, m) float32 and j1 (G, m) int64 are written.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int bid_top2_f32(const float* x, const float* c, const float* p,
                            float* v1, int64_t* j1, float* v2, int G, int m,
                            int k, int d, void* stream) {
  return static_cast<int>(bid::launch<void>(
      x, nullptr, 0, c, p, v1, j1, v2, 1, G, m, k, d,
      static_cast<cudaStream_t>(stream)));
}

// The span of the factored auction in one launch: bid_top2(x, c, 0) into
// slot 0 and bid_top2(-x, c, 2 ||c||^2) into slot 1 of v1, v2 (2, G, m)
// float32 and j1 (2, G, m) int64, ||c_j||^2 the launch's own (the fmaf
// chain of every value); bitwise the two separate calls at those prices.
extern "C" int bid_top2_span_f32(const float* x, const float* c, float* v1,
                                 int64_t* j1, float* v2, int G, int m, int k,
                                 int d, void* stream) {
  return static_cast<int>(bid::launch<void>(
      x, nullptr, 0, c, nullptr, v1, j1, v2, 2, G, m, k, d,
      static_cast<cudaStream_t>(stream)));
}
