// The selective scan's gradient for Hopper (sm_90a): the reverse walk of
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t ,   y_t = <h_t, C_t>
//
// given dy (the loss's gradient with respect to y) and dh (with respect to
// h_final).  With g_t the gradient with respect to h_t,
//
//     g_t = dy_t C_t + exp(dt_{t+1} A) g_{t+1}     (g past the end: dh),
//     w_t = g_t h_{t-1} exp(dt_t A),   du_t = <g_t, B_t>,
//     dx_t = du_t dt_t ,   d(dt)_t = du_t x_t + <w_t, A> ,
//     dB_t = sum_i g_t dt_t x_t ,   dC_t = sum_i dy_t h_t ,
//     dA = sum_{b,t} w_t dt_t ,   dh0 = exp(dt_0 A) g_0 .
//
// Replaces the gradient of the reference's `lax.scan` in `mamba_apply`
// (src/repro/models/mamba.py:114), which JAX forms by differentiating the
// scan; the TPU kernel `_ssm_chunk_kernel` (src/repro/kernels/ssm_scan.py)
// has no gradient.  Reached through `repro_torch.kernels.ssm_scan.
// ssm_scan_bwd`, the backward of `ops.ssm_scan`'s autograd Function.
//
// What bounds it on this card: at one layer of falcon-mamba-7b width in
// training (B = 2, S = 4096, d_inner = 8192, d_state = 16) it reads dt, x
// and dy and writes d(dt) and dx, 5 x 268 MB, and reads the saved states
// (1 / 16 of a full h: 268 MB): ~1.6 GB, 0.48 ms at 3.35 TB/s.  Beside the
// bytes it forms two exponentials a state and step (the tile's h
// recomputed, then the reverse walk), 2.1 G on the special-function units
// (0.51 ms at 16 a clock an SM and 1.98 GHz), and some 25 more
// instructions a state and step: ~0.9 ms at four warp
// instructions a clock on each of 132 SMs.  So the instruction rate and
// the latency of each warp's chains bound it, not the bytes.  On an
// NVIDIA H100 80GB HBM3 at 700.00 W it takes ~2.2 ms there, the first
// version ~9.2 ms timed in turns with it (chip_smoke.py phase 2; PERF.md).
//
// The design, point by point against what held the first version back
// (a CTA barrier a tile, the tile's partials summed on the walk):
//   1. The sums of dB and dC over d_inner are off the walk.  A CTA writes
//      its partial of every step to device memory and never waits on
//      another CTA; a second grid (ssm_scan_bwd_kernel_sums), parallel
//      over (batch, step, state), sums the partials in block order, and
//      dA's per-batch parts in batch order.  No float atomics and no
//      counters; B x blocks x S x 2 d_state floats of scratch, 128 MiB
//      at falcon's layer (128 blocks of 64 channels), as before.
//   2. Occupancy.  A lane holds Q = 4 states of one channel, L = 4 lanes
//      a channel at d_state 16 (L = d_state / 4 from 8 to 64; one lane a
//      channel and Q = 1, 2, 4 below), and the 17 states h_{t0-1} ..
//      h_{t0+15} of its tile in registers: no shared memory for h.  At
//      d_state 16 a CTA of 8 warps takes 96 KiB of shared memory and 128
//      registers a thread, so two CTAs, 16 warps, fit an SM (8 before).
//   3. Staging overlaps the walk.  Each warp streams its tiles (the dt, x
//      and dy rows of its channels, the B and C rows of its batch, the
//      saved state of its channels) through its own ring of kStages
//      tiles by 4-byte cp.async (any stride, any alignment; zeros past S,
//      d_inner or d_state) completed on an mbarrier a stage, as the
//      forward does: a tile's copies are in flight while the one before
//      it is walked.  The CTA's warps meet only on mbarriers (point 4);
//      the one CTA barrier arms them before the loop.
//   4. The warp's sums.  The 2Q terms of dB and dC a lane holds are summed
//      over the warp's channels by a reduce-scatter butterfly, 4 + 2 + 1 =
//      7 shuffles a lane and step at L = 4 (64 before), after which each
//      lane holds one of the step's 32 sums; d(dt) and dx over a channel's
//      lanes take one reduce-scatter level and one all-reduce level (d(dt)
//      summed as du x + <w, A> lane by lane, which is linear).  A warp
//      writes its sums of a tile to a slot of a ring of kSlots tiles in
//      shared memory and arrives on the slot's `full` mbarrier; after its
//      next tile every warp sums a slice of that slot over the warps in
//      order, writes the slice of the CTA's partial and arrives on the
//      slot's `empty` mbarrier, which the slot's next writer waits on.
//      With two slots a warp starts a tile once every warp has walked the
//      one before; three slots (a tile of slack) and 16 KiB more shared
//      memory a CTA ran 2-4 % slower on the H100.
//   5. The exponentials.  exp(dt A) is ex2.approx of dt times A log2(e),
//      two instructions, formed in each pass: storing it beside h would
//      take 64 more registers a lane and halve the warps an SM.  Its error
//      is expf's (both round the product once and take the same MUFU.EX2);
//      phase 2 of chip_smoke.py holds it to a float64 walk.
// The choices against their alternatives at falcon's layer, timed in
// turns on the H100 (tools/ssm_scan_bwd_variants.py; PERF.md): as built
// 2.14-2.23 ms; three slots of warp sums 2.22-2.30; 4 warps a CTA 2.30-
// 2.32 (twice the scratch); exp kept beside h 3.00-3.03 (232 registers, 8
// warps an SM); expf in both passes 2.78-2.79; a ring of 3 tiles 3.10-3.19
// (12 warps an SM); 8 lanes a channel with 2 states a lane 3.24-3.27.
// The tile stays the forward's saving interval, 16 steps.
// Every sum is taken in a fixed order, so a launch is repeatable bit for
// bit.  Strides, not layouts, as the forward: dt, x, dy, d(dt) and dx
// share (time, batch) strides, B, C, dB and dC theirs.
//
// Registers a thread and spills (ptxas -v, CUDA 12.8, sm_90a), warps a
// CTA, its shared memory, and warps an SM (by shared memory and
// registers), by instantiation (L, Q) and d_state:
//     (1, 1)   1      96, none            8   102 KiB   16
//     (1, 2)   2      127, none           8   108 KiB   16
//     (1, 4)   3-4    163, none           4    60 KiB   12
//     (2, 4)   5-8    128, 60 B stored    8    88 KiB   16
//     (4, 4)   9-16   128, 28 B stored    8    96 KiB   16  (falcon)
//     (8, 4)   17-32  165, none           4    74 KiB   12
//     (16, 4)  33-64  177, none           4   135 KiB    4
// The sums grid: 32 registers, 256 threads, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;   // a tile: the forward's saving interval (h_tiles)
constexpr int kStages = 2;   // tiles in a warp's input ring
constexpr int kSlots = 2;    // tiles in a CTA's ring of warp sums
constexpr size_t kSmemSM = 228 * 1024;   // shared memory an SM
constexpr size_t kSmemCTA = 227 * 1024;  // ... a CTA can take
constexpr size_t kSmemReserved = 1024;   // the system's share of each CTA
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kAll = 0xffffffffu;

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// Warps a CTA for a warp's shared memory: 8 where two such CTAs fit an SM,
// else 4 (or 2) in one CTA.
constexpr int warps_for(size_t warp_bytes) {
  return 2 * (8 * warp_bytes + kSmemReserved + 256) <= kSmemSM ? 8
         : 4 * warp_bytes <= kSmemCTA                         ? 4
                                                              : 2;
}

// L lanes a channel, Q states a lane.
template <int L, int Q>
struct Shape {
  static constexpr int kWarpChannels = 32 / L;
  static constexpr int kStates = L * Q;   // a channel's states, padded
  static constexpr int kSums = 2 * kStates;  // a step's [dB | dC]
  // a stage of a warp's ring, in floats: kSteps rows [dt | x | dy] of the
  // warp's channels, kSteps rows [B | C], the saved state of its channels
  static constexpr int kRowDXY = 3 * kWarpChannels;
  static constexpr int kRowBC = kSums;
  static constexpr int kStage =
      kSteps * (kRowDXY + kRowBC) + kWarpChannels * kStates;
  static constexpr int kSlotWarp = kSteps * kSums;  // a warp's sums of a tile
  static constexpr size_t kWarpBytes =
      size_t{4} * (kStages * kStage + kSlots * kSlotWarp);
  static constexpr int kWarps = warps_for(kWarpBytes);
  static constexpr int kChannels = kWarps * kWarpChannels;  // a CTA's
  static constexpr size_t kBytes = kWarps * kWarpBytes;
  static_assert(kBytes <= kSmemCTA, "a CTA's rings fit in shared memory");
  // CTAs an SM holds: 16 warps, as far as shared memory allows (so the
  // register cap is 128 a thread where two CTAs of 8 warps fit, and no
  // lower than shared memory needs elsewhere)
  static constexpr int kCTAsBySmem =
      static_cast<int>(kSmemSM / (kBytes + kSmemReserved + 256));
  static constexpr int kMinCTAs =
      16 / kWarps < kCTAsBySmem ? 16 / kWarps : kCTAsBySmem;
  // the butterfly over the warp's channels: reduce-scatter levels, then
  // all-reduce levels; the values a lane holds after it
  static constexpr int kChanLevels = log2i(kWarpChannels);
  static constexpr int kScatter =
      log2i(2 * Q) < kChanLevels ? log2i(2 * Q) : kChanLevels;
  static constexpr int kKept = (2 * Q) >> kScatter;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to dst, or 4 zero bytes (nothing read) where !ok.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void init_barrier(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive on `bar` once this lane's copies so far have landed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               ::"r"(smem_u32(bar)) : "memory");
}

// Arrive on `bar` (release: this lane's shared-memory writes and reads so
// far are ordered before the phase completes).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
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

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int L, int Q>
__global__ void __launch_bounds__(32 * Shape<L, Q>::kWarps,
                                  Shape<L, Q>::kMinCTAs)
ssm_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ x,
                    const float* __restrict__ a,
                    const float* __restrict__ h_tiles,
                    const float* __restrict__ dy, const float* __restrict__ dh,
                    float* __restrict__ ddt, float* __restrict__ dx,
                    float* __restrict__ dh0, float* __restrict__ part,
                    float* __restrict__ da_part, int S, int di, int ds,
                    int64_t st_t, int64_t st_b, int64_t sb_t, int64_t sb_b,
                    int blocks) {
  using T = Shape<L, Q>;
  constexpr int CW = T::kWarpChannels, K = T::kStates, W = T::kWarps;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t ring_bar[W][kStages];
  __shared__ uint64_t full_bar[kSlots], empty_bar[kSlots];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / blocks;  // a batch's `blocks` CTAs in a row
  const int blk = blockIdx.x % blocks;
  const int ch0 = blk * T::kChannels;
  const int live_warps = min(W, (di - ch0 + CW - 1) / CW);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      init_barrier(full_bar + s, 32 * live_warps);
      init_barrier(empty_bar + s, 32 * live_warps);
    }
  }
  if (lane < kStages) init_barrier(ring_bar[warp] + lane, 32);
  __syncthreads();  // the barriers are armed (before the time loop)
  if (warp >= live_warps) return;  // a whole warp past d_inner

  float* ring = reinterpret_cast<float*>(smem4) +
                static_cast<size_t>(warp) * kStages * T::kStage;
  float* sums = reinterpret_cast<float*>(smem4) +
                static_cast<size_t>(W) * kStages * T::kStage;
  uint64_t* bar = ring_bar[warp];
  const int wch0 = ch0 + warp * CW;
  const int cl = lane / L;     // the lane's channel in the warp
  const int part_id = lane % L;  // ... and its states part_id * Q + q
  const int i = wch0 + cl;
  const bool live = i < di;
  const int ntiles = (S + kSteps - 1) / kSteps;

  // The lane's copies of a tile: elements lane + 32 j of each [dt | x | dy]
  // row and each [B | C] row, and of the saved state [channel][state].
  constexpr int kPerDXY = (T::kRowDXY + 31) / 32;
  constexpr int kPerBC = (T::kRowBC + 31) / 32;
  constexpr int kPerH = (CW * K) / 32;  // = Q
  const float* dsrc[kPerDXY];
  const float* bsrc[kPerBC];
  bool dhas[kPerDXY], dok[kPerDXY], bhas[kPerBC], bok[kPerBC];
#pragma unroll
  for (int j = 0; j < kPerDXY; ++j) {
    const int e = lane + 32 * j;
    const int which = e / CW, c = e % CW;
    dhas[j] = e < T::kRowDXY;
    dok[j] = dhas[j] && wch0 + c < di;
    dsrc[j] = (which == 0 ? dt : which == 1 ? x : dy) + b * st_b +
              (dok[j] ? wch0 + c : 0);
  }
#pragma unroll
  for (int j = 0; j < kPerBC; ++j) {
    const int e = lane + 32 * j;
    const int s = e % K;
    bhas[j] = e < T::kRowBC;
    bok[j] = bhas[j] && s < ds;
    bsrc[j] = (e < K ? bm : cm) + b * sb_b + (bok[j] ? s : 0);
  }
  auto fetch = [&](int it) {
    const int tile = ntiles - 1 - it;
    const int t0 = tile * kSteps;
    float* dxs = ring + (it % kStages) * T::kStage + lane;
    float* bcs = dxs + kSteps * T::kRowDXY;
    float* hss = bcs + kSteps * T::kRowBC;
#pragma unroll
    for (int tt = 0; tt < kSteps; ++tt) {
      const bool ok = t0 + tt < S;
      const int64_t row = static_cast<int64_t>(ok ? t0 + tt : 0);
#pragma unroll
      for (int j = 0; j < kPerDXY; ++j)
        if (dhas[j])
          copy4(dxs + tt * T::kRowDXY + 32 * j, dsrc[j] + row * st_t,
                ok && dok[j]);
#pragma unroll
      for (int j = 0; j < kPerBC; ++j)
        if (bhas[j])
          copy4(bcs + tt * T::kRowBC + 32 * j, bsrc[j] + row * sb_t,
                ok && bok[j]);
    }
    const float* hsrc =
        h_tiles + ((static_cast<int64_t>(b) * ntiles + tile) * di + wch0) * ds;
#pragma unroll
    for (int j = 0; j < kPerH; ++j) {
      const int c = (lane + 32 * j) / K, s = (lane + 32 * j) % K;
      const bool ok = wch0 + c < di && s < ds;
      copy4(hss + 32 * j, ok ? hsrc + c * ds + s : h_tiles, ok);
    }
    arrive_on_copies(bar + it % kStages);
  };

  // What a lane holds after the butterfly over the warp's channels: kKept
  // values from index vbase of its 2Q [dB terms | dC terms], written to the
  // step's sums at o0 .. o0 + kKept - 1 by the lanes whose all-reduce bits
  // are zero.
  int vbase = 0;
#pragma unroll
  for (int r = 0; r < T::kScatter; ++r)
    if (lane & (16 >> r)) vbase += (2 * Q >> r) / 2;
  const int o0 = (vbase / Q) * K + part_id * Q + vbase % Q;
  const int reduce_bits = ((16 >> T::kScatter) << 1) - L;
  const bool sum_writer = (lane & reduce_bits) == 0;

  float a2[Q], g[Q], dacc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = part_id * Q + q;
    const bool on = live && s < ds;
    a2[q] = on ? a[static_cast<int64_t>(i) * ds + s] * kLog2e : 0.f;
    g[q] = on ? dh[(static_cast<int64_t>(b) * di + i) * ds + s] : 0.f;
    dacc[q] = 0.f;
  }
  float* part_cta = part + static_cast<int64_t>(b * blocks + blk) * S * T::kSums;

  // Sum a slice of tile `it`'s warp sums over the warps in order, write it
  // to the CTA's partial and free the slot.
  auto sum_tile = [&](int it) {
    const int slot = it % kSlots;
    wait_phase(full_bar + slot, (it / kSlots) & 1);
    const int t0 = (ntiles - 1 - it) * kSteps;
    const float* src = sums + slot * W * T::kSlotWarp;
    for (int e = warp * 32 + lane; e < T::kSlotWarp; e += 32 * live_warps) {
      float acc = src[e];
      for (int w = 1; w < live_warps; ++w) acc += src[w * T::kSlotWarp + e];
      const int t = t0 + e / T::kSums;
      if (t < S) part_cta[static_cast<int64_t>(t) * T::kSums + e % T::kSums] = acc;
    }
    arrive(empty_bar + slot);
  };

  const int64_t out0 = b * st_b + i;  // d(dt), dx of step t at out0 + t st_t
  for (int p = 0; p < kStages - 1 && p < ntiles; ++p) fetch(p);
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = (ntiles - 1 - it) * kSteps;
    const int slot = it % kSlots;
    if (it + kStages - 1 < ntiles) fetch(it + kStages - 1);
    wait_phase(bar + it % kStages, (it / kStages) & 1);
    if (it >= kSlots) wait_phase(empty_bar + slot, ((it / kSlots) - 1) & 1);
    const float* dxs = ring + (it % kStages) * T::kStage;
    const float* bcs = dxs + kSteps * T::kRowDXY;
    const float* hss = bcs + kSteps * T::kRowBC;
    float* wsum = sums + (slot * W + warp) * T::kSlotWarp;

    // the tile's states h_{t0-1} .. h_{t0+15}, from the one saved
    float hs[kSteps + 1][Q];
    load_vec<Q>(hss + cl * K + part_id * Q, hs[0]);
#pragma unroll
    for (int tt = 0; tt < kSteps; ++tt) {
      const float dtv = dxs[tt * T::kRowDXY + cl];
      const float dxv = dtv * dxs[tt * T::kRowDXY + CW + cl];
      float bv[Q];
      load_vec<Q>(bcs + tt * T::kRowBC + part_id * Q, bv);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        hs[tt + 1][q] = fmaf(hs[tt][q], exp2_approx(dtv * a2[q]), dxv * bv[q]);
    }

    // the reverse walk
#pragma unroll
    for (int tt = kSteps - 1; tt >= 0; --tt) {
      const float* row = dxs + tt * T::kRowDXY;
      const float dtv = row[cl], xv = row[CW + cl], dyv = row[2 * CW + cl];
      const float u = dtv * xv;
      float bv[Q], cv[Q], v[2 * Q];
      load_vec<Q>(bcs + tt * T::kRowBC + part_id * Q, bv);
      load_vec<Q>(bcs + tt * T::kRowBC + K + part_id * Q, cv);
      float du = 0.f, wa = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float decay = exp2_approx(dtv * a2[q]);
        const float gq = fmaf(dyv, cv[q], g[q]);
        v[q] = gq * u;                       // dB's term
        v[Q + q] = dyv * hs[tt + 1][q];      // dC's term
        const float w = gq * (hs[tt][q] * decay);
        dacc[q] = fmaf(w, dtv, dacc[q]);
        wa = fmaf(w, a2[q], wa);             // <w, A> / ln 2
        du = fmaf(gq, bv[q], du);
        g[q] = decay * gq;
      }
      // d(dt) and dx over the channel's lanes: one reduce-scatter level,
      // then all-reduce; lane 0 of the channel holds d(dt), lane 1 dx
      float own = fmaf(du, xv, wa * kLn2);
      float other = du * dtv;
      if constexpr (L > 1) {
        const bool odd = lane & 1;
        const float send = odd ? own : other;
        own = (odd ? other : own) + __shfl_xor_sync(kAll, send, 1);
#pragma unroll
        for (int m = 2; m < L; m <<= 1) own += __shfl_xor_sync(kAll, own, m);
      }
      const int t = t0 + tt;
      if (live && t < S) {
        const int64_t off = out0 + t * st_t;
        if constexpr (L == 1) {
          ddt[off] = own;
          dx[off] = other;
        } else if (part_id < 2) {
          (part_id == 0 ? ddt : dx)[off] = own;
        }
      }
      // dB, dC over the warp's channels: reduce-scatter from the highest
      // lane bit, then all-reduce
#pragma unroll
      for (int r = 0; r < T::kChanLevels; ++r) {
        const int m = 16 >> r;
        if (r < T::kScatter) {
          constexpr int kN = 2 * Q;
          const int n = kN >> r;
          const bool up = lane & m;
#pragma unroll
          for (int j = 0; j < kN / 2; ++j) {
            if (j < n / 2) {
              const float send = up ? v[j] : v[j + n / 2];
              const float keep = up ? v[j + n / 2] : v[j];
              v[j] = keep + __shfl_xor_sync(kAll, send, m);
            }
          }
        } else {
          v[0] += __shfl_xor_sync(kAll, v[0], m);
        }
      }
      if (sum_writer) {
#pragma unroll
        for (int j = 0; j < T::kKept; ++j) wsum[tt * T::kSums + o0 + j] = v[j];
      }
    }
    __syncwarp();  // the stage is read: the next fetch may refill it
    arrive(full_bar + slot);
    if (it > 0) sum_tile(it - 1);
  }
  sum_tile(ntiles - 1);

  // dh0 = exp(dt_0 A) g_0, carried; this batch's part of dA
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = part_id * Q + q;
    if (live && s < ds) {
      const int64_t at = (static_cast<int64_t>(b) * di + i) * ds + s;
      dh0[at] = g[q];
      da_part[at] = dacc[q];
    }
  }
}

// dB, dC: the CTAs' partials summed in block order; dA: the batches'
// parts summed in batch order.  One thread an output.
__global__ void __launch_bounds__(256)
ssm_scan_bwd_kernel_sums(const float* __restrict__ part,
                         const float* __restrict__ da_part,
                         float* __restrict__ dbm, float* __restrict__ dcm,
                         float* __restrict__ da, int B, int S, int di, int ds,
                         int K, int blocks, int64_t sb_t, int64_t sb_b) {
  const int sums = 2 * K;
  const int64_t n_bc = static_cast<int64_t>(B) * S * sums;
  const int64_t n_a = static_cast<int64_t>(di) * ds;
  const int64_t stride = static_cast<int64_t>(S) * sums;  // block to block
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_bc + n_a; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (e < n_bc) {
      const int o = static_cast<int>(e % sums);
      const int64_t bt = e / sums;
      const int t = static_cast<int>(bt % S), b = static_cast<int>(bt / S);
      const int s = o % K;
      if (s >= ds) continue;
      const float* p = part + (static_cast<int64_t>(b) * blocks * S + t) * sums + o;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < blocks; ++k) acc += __ldg(p + k * stride);
      (o < K ? dbm : dcm)[t * sb_t + b * sb_b + s] = acc;
    } else {
      const int64_t at = e - n_bc;
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc += __ldg(da_part + b * n_a + at);
      da[at] = acc;
    }
  }
}

template <int L, int Q>
int64_t blocks_for(int di) {
  return (di + Shape<L, Q>::kChannels - 1) / Shape<L, Q>::kChannels;
}

template <int L, int Q>
int64_t part_floats(int B, int S, int di) {
  return static_cast<int64_t>(B) * blocks_for<L, Q>(di) * S *
         Shape<L, Q>::kSums;
}

template <int L, int Q>
cudaError_t launch(cudaStream_t stream, const float* dt, const float* bm,
                   const float* cm, const float* x, const float* a,
                   const float* h_tiles, const float* dy, const float* dh,
                   float* ddt, float* dbm, float* dcm, float* dx, float* da,
                   float* dh0, float* work, int B, int S, int di, int ds,
                   int64_t st_t, int64_t st_b, int64_t sb_t, int64_t sb_b) {
  using T = Shape<L, Q>;
  auto* walk = ssm_scan_bwd_kernel<L, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(walk,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int64_t blocks = blocks_for<L, Q>(di);
  if (blocks * B > INT32_MAX) return cudaErrorInvalidConfiguration;
  float* part = work;
  float* da_part = work + part_floats<L, Q>(B, S, di);
  walk<<<static_cast<int>(blocks * B), 32 * T::kWarps, T::kBytes, stream>>>(
      dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dx, dh0, part, da_part, S, di,
      ds, st_t, st_b, sb_t, sb_b, static_cast<int>(blocks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(B) * S * T::kSums +
                    static_cast<int64_t>(di) * ds;
  const int64_t grid = (n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536;
  ssm_scan_bwd_kernel_sums<<<static_cast<int>(grid), 256, 0, stream>>>(
      part, da_part, dbm, dcm, da, B, S, di, ds, T::kStates,
      static_cast<int>(blocks), sb_t, sb_b);
  return cudaGetLastError();
}

// The instantiation for d_state ds: (lanes a channel, states a lane).
// Returns 0 past 64.
int layout_for(int ds) {
  if (ds <= 0) return 0;
  if (ds <= 1) return 11;
  if (ds <= 2) return 12;
  if (ds <= 4) return 14;
  if (ds <= 8) return 24;
  if (ds <= 16) return 44;
  if (ds <= 32) return 84;
  if (ds <= 64) return 164;
  return 0;
}

}  // namespace

// The float32 scratch a launch at these sizes takes, in elements.
extern "C" int ssm_scan_bwd_workspace_f32(int B, int S, int di, int ds,
                                          int64_t* floats) {
  if (B <= 0 || S <= 0 || di <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t n = 0;
  switch (layout_for(ds)) {
    case 11: n = part_floats<1, 1>(B, S, di); break;
    case 12: n = part_floats<1, 2>(B, S, di); break;
    case 14: n = part_floats<1, 4>(B, S, di); break;
    case 24: n = part_floats<2, 4>(B, S, di); break;
    case 44: n = part_floats<4, 4>(B, S, di); break;
    case 84: n = part_floats<8, 4>(B, S, di); break;
    case 164: n = part_floats<16, 4>(B, S, di); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *floats = n + static_cast<int64_t>(B) * di * ds;
  return 0;
}

// dt, x, dy, ddt, dx: element (t, b, i) at t * st_t + b * st_b + i; bm, cm,
// dbm, dcm: (t, b, s) at t * sb_t + b * sb_b + s; a, da (di, ds); dh, dh0
// (B, di, ds); h_tiles (B, n_tiles, di, ds), the states the forward saved
// (n_tiles = ceil(S / 16)); work: the float32 scratch of
// ssm_scan_bwd_workspace_f32.  All float32, 1 <= d_state <= 64, S >= 1.
// Launches two grids on `stream` and returns the first cudaError_t.
extern "C" int ssm_scan_bwd_f32(const float* dt, const float* bm,
                                const float* cm, const float* x,
                                const float* a, const float* h_tiles,
                                int n_tiles, const float* dy, const float* dh,
                                float* ddt, float* dbm, float* dcm, float* dx,
                                float* da, float* dh0, float* work, int B,
                                int S, int di, int ds, int64_t st_t,
                                int64_t st_b, int64_t sb_t, int64_t sb_b,
                                void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || layout_for(ds) == 0 ||
      n_tiles != (S + kSteps - 1) / kSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSM_BWD_LAUNCH(L, Q)                                                 \
  launch<L, Q>(s, dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm, dx, da, \
               dh0, work, B, S, di, ds, st_t, st_b, sb_t, sb_b)
  cudaError_t err;
  switch (layout_for(ds)) {
    case 11: err = SSM_BWD_LAUNCH(1, 1); break;
    case 12: err = SSM_BWD_LAUNCH(1, 2); break;
    case 14: err = SSM_BWD_LAUNCH(1, 4); break;
    case 24: err = SSM_BWD_LAUNCH(2, 4); break;
    case 44: err = SSM_BWD_LAUNCH(4, 4); break;
    case 84: err = SSM_BWD_LAUNCH(8, 4); break;
    default: err = SSM_BWD_LAUNCH(16, 4); break;
  }
#undef SSM_BWD_LAUNCH
  return static_cast<int>(err);
}
