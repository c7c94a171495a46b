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
// What bounds it on this card: at one layer of falcon-mamba-7b width
// (B = 2, S = 2048, d_inner = 8192, d_state = 16) it reads dt and x and
// writes y, 3 x 134 MB, plus small B, C, A and h: ~403 MB, 0.120 ms at
// 3.35 TB/s.  Beside the bytes, it takes B * S * d_inner * d_state =
// 537 M expf, each one MUFU.EX2 at 16 a clock an SM (0.128 ms at 1.98 GHz)
// and eight more instructions (expf's range reduction and scaling, and
// dt * A), and the state update and y another three: with the loads and
// the loop about 15 instructions a state and step in all (120 a
// lane and step of 8 states in the SASS), 0.24 ms at four warp
// instructions a clock on each of 132 SMs at 1.98 GHz.  So the instruction rate,
// not the bytes, bounds it, and the design keeps the loads off the
// threads' instruction stream and forms each exponential once.  The
// channels are 16 K at that shape: two lanes a channel make 1 024 warps,
// under 8 an SM, so each warp must hide its own latency.
//
// Design:
//   * A CTA of 8 warps owns 128 contiguous channels of one batch (4 warps
//     and 64 channels above 32 states); a warp owns 16 of them, two lanes a channel, each lane half of the channel's
//     states (Q of them) with h and A in registers.  Of 1, 2, 4 and 8 lanes
//     a channel, 4 or 8 warps a CTA, 8 to 32 steps a tile and 3 to 8 tiles
//     a ring, this ran fastest on the H100 (PERF.md).  One launch covers the
//     sequence: the loop over t inside the kernel replaces the TPU's
//     sequential grid over chunks, and h never goes to global memory in
//     between.
//   * Each warp streams its inputs through its own ring of kStages tiles in
//     shared memory, a tile being kSteps time steps: the dt and x rows of
//     its 16 channels and the B and C rows of its batch.  The copies are
//     asynchronous (4-byte cp.async, so any stride and any alignment is
//     taken; rows past the sequence or channels past d_inner are zero-
//     filled) and complete on one mbarrier a stage (cp.async.mbarrier.
//     arrive.noinc from every lane), kStages - 1 tiles ahead of the
//     arithmetic.  A warp never waits for another: no CTA barrier.
//   * A lane reads its channel's dt and x from the tile free of bank
//     conflicts (the lanes of a channel share a word) and B and C as
//     vector loads that the lanes of a half broadcast.  Zero dt and B past
//     the sequence end leave h as it is.
//   * The two halves of y_t are summed by one shuffle; the first lane of a
//     channel writes it, so a warp's store of step t is its 16 channels'
//     64 contiguous bytes.
//   * Strides, not layouts: dt, x and y share (time, batch) strides, B and
//     C theirs, and the channel / state stride is 1; so the (B, S, .) and
//     the time-major (C, B, .) layouts run without a transposed copy.
//   * exp is expf (not __expf), the arithmetic fp32; the sum order of y_t
//     differs from the reference's, hence a tolerance, not bitwise equality.
//   * For training, the instantiation with kSave writes h as it enters each
//     tile (every kSteps steps) to h_tiles (B, ceil(S / kSteps), di, ds):
//     the states csrc/ssm_scan_bwd.cu recomputes a tile's h from.  Serving
//     runs the instantiation without it, which writes nothing more.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 2;                          // lanes a channel
constexpr int kWarpChannels = 32 / kLanes;
constexpr int kSteps = 16;                         // time steps a tile
constexpr int kStages = 4;                         // tiles in a warp's ring

constexpr size_t kSmemMax = 226 * 1024;  // dynamic shared memory a CTA

// A stage of a warp's ring: kSteps rows of [dt of the warp's channels | x of
// them], then kSteps rows of [B | C], each padded to kLanes * Q states.  A
// CTA has 8 warps, or as many as have room for their rings.
template <int Q>
struct Ring {
  static constexpr int kBC = 2 * kLanes * Q;
  static constexpr int kDX = 2 * kWarpChannels;
  static constexpr int kStage = kSteps * (kDX + kBC);  // floats
  static constexpr size_t kWarpBytes = size_t{4} * kStages * kStage;
  static constexpr int kWarps =
      8 * kWarpBytes <= kSmemMax ? 8 : (4 * kWarpBytes <= kSmemMax ? 4 : 2);
  static constexpr int kChannels = kWarps * kWarpChannels;  // a CTA's block
  static constexpr size_t kBytes = kWarps * kWarpBytes;
  static_assert(kBytes <= kSmemMax, "a CTA's rings fit in shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to dst, or 4 zero bytes (nothing read) where !ok.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Arrive on `bar` once this lane's copies so far have landed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int Q, bool kSave>
__global__ void __launch_bounds__(32 * Ring<Q>::kWarps)
ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out,
                float* __restrict__ h_tiles, int S,
                int di, int ds, int64_t st_t, int64_t st_b, int64_t sb_t,
                int64_t sb_b, int blocks) {
  using R = Ring<Q>;
  constexpr int V = Q < 4 ? Q : 4;  // states a vector load of B or C holds
  extern __shared__ float4 ring4[];
  __shared__ uint64_t bars[R::kWarps][kStages];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / blocks;  // a batch's `blocks` CTAs in a row
  const int wch0 = (blockIdx.x % blocks) * R::kChannels + warp * kWarpChannels;
  if (wch0 >= di) return;  // a whole warp past d_inner; no CTA barrier below
  const int i = wch0 + lane / kLanes;  // this lane's channel
  const int half = lane % kLanes;      // ... and its states half * Q + q
  const bool live = i < di;
  float* ring = reinterpret_cast<float*>(ring4) +
                static_cast<size_t>(warp) * kStages * R::kStage;
  uint64_t* bar = bars[warp];

  // arm the stages: every lane arrives once a phase
  if (lane < kStages)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;"
                 ::"r"(smem_u32(bar + lane)) : "memory");
  __syncwarp();

  // The lane's copies of a tile row: elements e = lane + 32 j of the row
  // [dt | x] of the warp's channels and of the row [B | C] padded to
  // kLanes * Q states each, every element of both rows written each tile
  // (zeros where no channel or state is, or past the sequence end).
  constexpr int kPerDX = (R::kDX + 31) / 32;
  constexpr int kPerBC = (R::kBC + 31) / 32;
  const float* dsrc[kPerDX];
  const float* bsrc[kPerBC];
  bool dhas[kPerDX], dok[kPerDX], bhas[kPerBC], bok[kPerBC];
#pragma unroll
  for (int j = 0; j < kPerDX; ++j) {
    const int e = lane + 32 * j;
    const bool is_dt = e < kWarpChannels;
    const int ch = wch0 + (is_dt ? e : e - kWarpChannels);
    dhas[j] = e < R::kDX;
    dok[j] = ch < di;
    dsrc[j] = (is_dt ? dt : x) + b * st_b + (dok[j] ? ch : 0);
  }
#pragma unroll
  for (int j = 0; j < kPerBC; ++j) {
    const int e = lane + 32 * j;
    const bool is_b = e < kLanes * Q;
    const int q = is_b ? e : e - kLanes * Q;
    bhas[j] = e < R::kBC;
    bok[j] = q < ds;
    bsrc[j] = (is_b ? bm : cm) + b * sb_b + (bok[j] ? q : 0);
  }
  const int ntiles = (S + kSteps - 1) / kSteps;
  auto fetch = [&](int tile) {
    const int s = tile % kStages;
    float* dxs = ring + s * R::kStage + lane;
    float* bcs = dxs + kSteps * R::kDX;
    const int t0 = tile * kSteps;
    const float* dp[kPerDX];
    const float* bp[kPerBC];
#pragma unroll
    for (int j = 0; j < kPerDX; ++j) dp[j] = dsrc[j] + t0 * st_t;
#pragma unroll
    for (int j = 0; j < kPerBC; ++j) bp[j] = bsrc[j] + t0 * sb_t;
    // A full tile copies without a test a row; the last, rows past S as
    // zeros from a source inside the arrays.
    auto rows = [&](auto full) {
#pragma unroll
      for (int tt = 0; tt < kSteps; ++tt) {
        const bool ok = decltype(full)::value || t0 + tt < S;
#pragma unroll
        for (int j = 0; j < kPerDX; ++j) {
          if (dhas[j])
            copy4(dxs + tt * R::kDX + 32 * j, ok ? dp[j] : dsrc[j], ok && dok[j]);
          dp[j] += st_t;
        }
#pragma unroll
        for (int j = 0; j < kPerBC; ++j) {
          if (bhas[j])
            copy4(bcs + tt * R::kBC + 32 * j, ok ? bp[j] : bsrc[j], ok && bok[j]);
          bp[j] += sb_t;
        }
      }
    };
    if (t0 + kSteps <= S) {
      rows(std::true_type{});
    } else {
      rows(std::false_type{});
    }
    arrive_on_copies(bar + s);
  };
  for (int p = 0; p < kStages - 1 && p < ntiles; ++p) fetch(p);

  float av[Q], h[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = half * Q + q;
    const bool on = live && s < ds;
    av[q] = on ? a[static_cast<int64_t>(i) * ds + s] : 0.f;
    h[q] = (on && h0 != nullptr)
               ? h0[(static_cast<int64_t>(b) * di + i) * ds + s] : 0.f;
  }
  float* yp = y + b * st_b + i;  // y of step t at yp + t * st_t
  const bool writer = half == 0 && live;
  const int cl = lane / kLanes;

  for (int tile = 0; tile < ntiles; ++tile) {
    if constexpr (kSave) {  // the state entering this tile
      float* hp = h_tiles + ((static_cast<int64_t>(b) * ntiles + tile) * di + i) * ds;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (live && half * Q + q < ds) hp[half * Q + q] = h[q];
    }
    if (tile + kStages - 1 < ntiles) fetch(tile + kStages - 1);
    wait_phase(bar + tile % kStages, (tile / kStages) & 1);
    const float* dxs = ring + (tile % kStages) * R::kStage;
    const float* bcs = dxs + kSteps * R::kDX;
#pragma unroll 4
    for (int tt = 0; tt < kSteps; ++tt) {
      const float dtv = dxs[tt * R::kDX + cl];
      const float dxv = dtv * dxs[tt * R::kDX + kWarpChannels + cl];
      const float* bq = bcs + tt * R::kBC + half * Q;
      float part = 0.f;
#pragma unroll
      for (int q0 = 0; q0 < Q; q0 += V) {
        float bv[V], cv[V];
        load_vec<V>(bq + q0, bv);
        load_vec<V>(bq + kLanes * Q + q0, cv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float da = expf(dtv * av[q0 + v]);
          h[q0 + v] = h[q0 + v] * da + dxv * bv[v];
          part = fmaf(h[q0 + v], cv[v], part);
        }
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (writer && tile * kSteps + tt < S) *yp = part;
      yp += st_t;
    }
    __syncwarp();  // the stage is read: the next fetch may refill it
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = half * Q + q;
    if (live && s < ds) h_out[(static_cast<int64_t>(b) * di + i) * ds + s] = h[q];
  }
}

template <int Q, bool kSave>
cudaError_t launch_as(cudaStream_t stream, const float* dt, const float* bm,
                      const float* cm, const float* x, const float* a,
                      const float* h0, float* y, float* h_out, float* h_tiles,
                      int B, int S, int di, int ds, int64_t st_t, int64_t st_b,
                      int64_t sb_t, int64_t sb_b) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<Q, kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Ring<Q>::kBytes));
  if (err != cudaSuccess) return err;
  const int blocks = (di + Ring<Q>::kChannels - 1) / Ring<Q>::kChannels;
  if (static_cast<int64_t>(blocks) * B > INT32_MAX)
    return cudaErrorInvalidConfiguration;
  ssm_scan_kernel<Q, kSave>
      <<<blocks * B, 32 * Ring<Q>::kWarps, Ring<Q>::kBytes, stream>>>(
          dt, bm, cm, x, a, h0, y, h_out, h_tiles, S, di, ds, st_t, st_b,
          sb_t, sb_b, blocks);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch(cudaStream_t stream, const float* dt, const float* bm,
                   const float* cm, const float* x, const float* a,
                   const float* h0, float* y, float* h_out, float* h_tiles,
                   int B, int S, int di, int ds, int64_t st_t, int64_t st_b,
                   int64_t sb_t, int64_t sb_b) {
  return h_tiles == nullptr
      ? launch_as<Q, false>(stream, dt, bm, cm, x, a, h0, y, h_out, h_tiles,
                            B, S, di, ds, st_t, st_b, sb_t, sb_b)
      : launch_as<Q, true>(stream, dt, bm, cm, x, a, h0, y, h_out, h_tiles,
                           B, S, di, ds, st_t, st_b, sb_t, sb_b);
}

}  // namespace

// dt, x, y: element (t, b, i) at t * st_t + b * st_b + i; bm, cm: (t, b, s)
// at t * sb_t + b * sb_b + s; a (di, ds); h0 (B, di, ds) or null for zeros;
// h_out (B, di, ds); h_tiles (B, n_tiles, di, ds) with n_tiles =
// ceil(S / 16), or null for serving.  All float32, d_state <= 64.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int ssm_scan_f32(const float* dt, const float* bm, const float* cm,
                            const float* x, const float* a, const float* h0,
                            float* y, float* h_out, float* h_tiles,
                            int n_tiles, int B, int S, int di, int ds,
                            int64_t st_t, int64_t st_b, int64_t sb_t,
                            int64_t sb_b, void* stream) {
  if (B <= 0 || di <= 0 || ds <= 0) return 0;
  if (ds > 32 * kLanes || ds > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (h_tiles != nullptr && n_tiles != (S + kSteps - 1) / kSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 2 * kLanes) {
    err = launch<2>(s, dt, bm, cm, x, a, h0, y, h_out, h_tiles, B, S, di,
                    ds, st_t, st_b, sb_t, sb_b);
  } else if (ds <= 4 * kLanes) {
    err = launch<4>(s, dt, bm, cm, x, a, h0, y, h_out, h_tiles, B, S, di,
                    ds, st_t, st_b, sb_t, sb_b);
  } else if (ds <= 8 * kLanes) {
    err = launch<8>(s, dt, bm, cm, x, a, h0, y, h_out, h_tiles, B, S, di,
                    ds, st_t, st_b, sb_t, sb_b);
  } else if (ds <= 16 * kLanes) {
    err = launch<16>(s, dt, bm, cm, x, a, h0, y, h_out, h_tiles, B, S, di,
                     ds, st_t, st_b, sb_t, sb_b);
  } else {
    err = launch<32>(s, dt, bm, cm, x, a, h0, y, h_out, h_tiles, B, S, di,
                     ds, st_t, st_b, sb_t, sb_b);
  }
  return static_cast<int>(err);
}
