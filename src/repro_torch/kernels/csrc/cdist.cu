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
// Design (in full in cdist.cuh): persistent CTAs of 128 threads walk
// 32-row tiles against 128 columns, rows and centroids staged by cp.async
// into double buffers, ||c||^2 summed once per CTA, and the output written
// as float4s with the evict-first hint, so the stores stream while the next
// tile's rows land and its FMAs run.

#include "cdist.cuh"

// x (m, d), c (nc, d) float32 contiguous; out (m, nc) float32 is written.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int cdist_f32(const float* x, const float* c, float* out,
                         int64_t m, int nc, int d, void* stream) {
  return static_cast<int>(cdist::launch<void>(
      x, nullptr, 0, c, out, m, nc, d, static_cast<cudaStream_t>(stream)));
}
