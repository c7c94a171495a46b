// Selective scan (the Mamba recurrence) for Hopper (sm_90a):
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ,   y_t = <h_t, C_t>
//
// per batch b and channel i, over the states s of h (d_state of them).
//
// Replaces the TPU kernel `_ssm_chunk_kernel` behind
// `ssm_scan_chunk_pallas` and, with its Python loop over chunks,
// `ssm_scan_pallas`, in src/repro/kernels/ssm_scan.py.  Reached through
// `repro_torch.kernels.ssm_scan` (the (B, S, .) layout, h0 = 0) and
// `repro_torch.kernels.ssm_scan.ssm_scan_chunk` (time-major (C, B, .), a
// given h0).
//
// What bounds it on this card: bytes.  At one layer of falcon-mamba-7b
// width (B = 2, S = 2048, d_inner = 8192, d_state = 16) it reads dt and x
// and writes y, 3 x 134 MB, plus small B, C, A and h: ~403 MB, 0.120 ms at
// 3.35 TB/s, against ~3.8 GFLOP (0.056 ms at 67 TFLOP/s).  The recurrence
// is sequential in t, so the time it can reach depends on how many loads
// are in flight while each channel walks its steps.
//
// Design:
//   * One launch covers the whole sequence: a loop over t inside the kernel
//     replaces the TPU's sequential grid over chunks, and h stays in
//     registers from the first step to the last, so it never goes to global
//     memory in between (the TPU kernel keeps it in VMEM for one chunk and
//     carries it through HBM from chunk to chunk).
//   * 4 lanes per (b, i): lane l holds the states l, l + 4, ... (Q per lane,
//     d_state <= 4 Q), and y_t is their sum by a 4-lane shuffle butterfly.
//     That puts B * d_inner * 4 threads in flight (65 536 at the shape
//     above) instead of B * d_inner with one thread per channel.  Each lane
//     repeats the per-channel work (the dt and x loads, dt * x) and the
//     shuffle sum, so more lanes per channel cost instructions, while fewer
//     put fewer threads in flight; of 1, 2, 4, 8 and 16 lanes per channel,
//     4 ran fastest on the H100.
//   * Inputs are loaded kAhead time steps ahead of the arithmetic, so each
//     thread has that many independent loads outstanding while the
//     dependent chain of h runs; steps past the sequence end load dt = 0
//     and B = 0, which leave h as it is.  Lane t % 4 writes y of step t.
//   * Strides, not layouts: dt, x and y share (time, batch) strides, B and
//     C theirs, and the channel / state stride is 1; so the (B, S, .) and
//     the time-major (C, B, .) layouts run without a transposed copy.
//   * exp is expf (not __expf), the arithmetic fp32; the sum order of y_t
//     differs from the reference's, hence a tolerance, not bitwise equality.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;     // lanes per (b, channel)
constexpr int kThreads = 256; // 64 channels per CTA

template <int Q>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int B, int S,
                int di, int ds, int64_t st_t, int64_t st_b, int64_t sb_t,
                int64_t sb_b) {
  constexpr int kAhead = Q <= 4 ? 4 : 16 / Q;
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * (kThreads / kLanes) +
                     threadIdx.x / kLanes;  // b * di + i
  const int lane = threadIdx.x % kLanes;
  if (ch >= static_cast<int64_t>(B) * di) return;  // whole 4-lane groups
  const unsigned mask = ((1u << kLanes) - 1u)
                        << ((threadIdx.x & 31) / kLanes * kLanes);
  const int b = static_cast<int>(ch / di);
  const int i = static_cast<int>(ch % di);

  float av[Q], h[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = lane + kLanes * q;
    av[q] = s < ds ? a[static_cast<int64_t>(i) * ds + s] : 0.f;
    h[q] = (h0 != nullptr && s < ds) ? h0[ch * ds + s] : 0.f;
  }
  const int64_t xo = static_cast<int64_t>(b) * st_b + i;
  const float* bp = bm + static_cast<int64_t>(b) * sb_b;
  const float* cp = cm + static_cast<int64_t>(b) * sb_b;

  for (int t0 = 0; t0 < S; t0 += kAhead) {
    float dts[kAhead], dxs[kAhead], bs[kAhead][Q], cs[kAhead][Q];
#pragma unroll
    for (int tt = 0; tt < kAhead; ++tt) {
      const int t = t0 + tt;
      const bool ok = t < S;
      const float dtv = ok ? dt[xo + t * st_t] : 0.f;
      const float xv = ok ? x[xo + t * st_t] : 0.f;
      dts[tt] = dtv;
      dxs[tt] = dtv * xv;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = lane + kLanes * q;
        const bool on = ok && s < ds;
        bs[tt][q] = on ? bp[t * sb_t + s] : 0.f;
        cs[tt][q] = on ? cp[t * sb_t + s] : 0.f;
      }
    }
#pragma unroll
    for (int tt = 0; tt < kAhead; ++tt) {
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float da = expf(dts[tt] * av[q]);
        h[q] = h[q] * da + dxs[tt] * bs[tt][q];
        part = fmaf(h[q], cs[tt][q], part);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(mask, part, off, kLanes);
      if (lane == tt % kLanes && t0 + tt < S) y[xo + (t0 + tt) * st_t] = part;
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = lane + kLanes * q;
    if (s < ds) h_out[ch * ds + s] = h[q];
  }
}

template <int Q>
void launch(unsigned blocks, cudaStream_t s, const float* dt, const float* bm,
            const float* cm, const float* x, const float* a, const float* h0,
            float* y, float* h_out, int B, int S, int di, int ds, int64_t st_t,
            int64_t st_b, int64_t sb_t, int64_t sb_b) {
  ssm_scan_kernel<Q><<<blocks, kThreads, 0, s>>>(
      dt, bm, cm, x, a, h0, y, h_out, B, S, di, ds, st_t, st_b, sb_t, sb_b);
}

}  // namespace

// dt, x, y: element (t, b, i) at t * st_t + b * st_b + i; bm, cm: (t, b, s)
// at t * sb_t + b * sb_b + s; a (di, ds); h0 (B, di, ds) or null for zeros;
// h_out (B, di, ds).  All float32, d_state <= 64.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int ssm_scan_f32(const float* dt, const float* bm, const float* cm,
                            const float* x, const float* a, const float* h0,
                            float* y, float* h_out, int B, int S, int di,
                            int ds, int64_t st_t, int64_t st_b, int64_t sb_t,
                            int64_t sb_b, void* stream) {
  const int64_t channels = static_cast<int64_t>(B) * di;
  if (channels <= 0 || ds <= 0) return 0;
  if (ds > 16 * kLanes) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (channels * kLanes + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned g = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds <= 2 * kLanes) {
    launch<2>(g, s, dt, bm, cm, x, a, h0, y, h_out, B, S, di, ds, st_t, st_b,
              sb_t, sb_b);
  } else if (ds <= 4 * kLanes) {
    launch<4>(g, s, dt, bm, cm, x, a, h0, y, h_out, B, S, di, ds, st_t, st_b,
              sb_t, sb_b);
  } else if (ds <= 8 * kLanes) {
    launch<8>(g, s, dt, bm, cm, x, a, h0, y, h_out, B, S, di, ds, st_t, st_b,
              sb_t, sb_b);
  } else {
    launch<16>(g, s, dt, bm, cm, x, a, h0, y, h_out, B, S, di, ds, st_t,
               st_b, sb_t, sb_b);
  }
  return static_cast<int>(cudaGetLastError());
}
