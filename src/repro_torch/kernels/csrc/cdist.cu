// Squared-Euclidean cost matrix for Hopper (sm_90a):
// out[i, j] = ||x_i||^2 - 2 x_i . c_j + ||c_j||^2.
//
// Replaces the TPU kernel `_cdist_kernel` behind `cdist_pallas` in
// src/repro/kernels/cdist.py.  Reached through
// `repro_torch.kernels.cdist(x, c)` (leading chunk dims flattened into the
// rows, one launch).  The kernel lives in cdist.cuh, shared with
// cdist_gather.cu.
//
// What bounds it on this card: bytes.  At the diabetes shape against
// k = 256 centroids (x 253 680 x 22, c 256 x 22) the (m, n) float32 output
// alone is 260 MB and all bytes ~282 MB, 0.084 ms at 3.35 TB/s, against
// 2.9 GFLOP of fp32 FMA, 0.043 ms at 67 TFLOP/s.  So the output is written
// once, straight from registers, and nothing else of size m x n is read or
// written; the FMA work stays on the CUDA cores.
//
// Design:
//   * fp32 FMA, no tensor cores: a TF32 product keeps ~3 decimal digits and
//     would break parity with the float32 reference (the TPU kernel
//     accumulates in fp32 on the MXU).
//   * A CTA of 256 threads owns a 64 x 128 output tile; each thread keeps
//     a 4 x 8 block of sums in registers (rows ty + 16 i, columns
//     tx + 16 j), so each feature step reads 12 shared-memory words for 32
//     FMA.  Of the tiles tried on the H100 (32, 64 or 128 rows by 64 or 128
//     columns), this one ran fastest at the shape above.
//     The TPU kernel's sequential reduction grid axis over D becomes a loop
//     inside the CTA: x and c tiles of 32 features are staged in shared
//     memory, feature-major and padded, so any d is taken.
//   * ||x_i||^2 and ||c_j||^2 are summed in the kernel from the staged tiles
//     (the TPU wrapper computes them outside), and folded in once at the
//     end: (||x||^2 - 2 x.c) + ||c||^2, the reference's order.
//   * 16 neighbouring threads store 16 neighbouring columns of one row, so
//     every output write is coalesced.  Ragged edges are masked; no
//     padded copy of x or c is made.  One pass, no atomics.

#include "cdist.cuh"

// x (m, d), c (nc, d) float32 contiguous; out (m, nc) float32 is written.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int cdist_f32(const float* x, const float* c, float* out,
                         int64_t m, int nc, int d, void* stream) {
  return static_cast<int>(cdist::launch<void>(
      x, nullptr, 0, c, out, m, nc, d, static_cast<cudaStream_t>(stream)));
}
