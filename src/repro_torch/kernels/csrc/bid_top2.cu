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

#include "bid_top2.cuh"

// x (G, m, d), c (G, k, d), p (G, k) float32, contiguous, on one device;
// v1, v2 (G, m) float32 and j1 (G, m) int64 are written.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int bid_top2_f32(const float* x, const float* c, const float* p,
                            float* v1, int64_t* j1, float* v2, int G, int m,
                            int k, int d, void* stream) {
  return static_cast<int>(bid::launch<void>(
      x, nullptr, 0, c, p, v1, j1, v2, G, m, k, d,
      static_cast<cudaStream_t>(stream)));
}
