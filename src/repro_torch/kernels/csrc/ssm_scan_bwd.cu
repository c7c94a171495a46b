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
// (1 / 16 of a full h: 268 MB): ~1.6 GB, 0.48 ms at 3.35 TB/s.  It takes
// two expf a state and step (the tile's h recomputed, then the reverse
// walk): 2.1 G, 0.51 ms on the special-function units at 1.98 GHz, with
// some 30 more instructions a state and step beside them.  So the
// instruction rate bounds it, as it does the forward.
//
// Design (a simple kernel first):
//   * A CTA owns kWarps x 16 channels of one batch, two lanes a channel,
//     each lane half of the channel's states, as the forward does; g, A and
//     the lane's share of dA stay in registers.  The CTA walks the tiles of
//     kSteps steps from the last to the first.
//   * A tile: the CTA stages the tile's dt, x and dy of its channels and B
//     and C of its batch in shared memory (zeros past S or d_inner, which
//     leave g and h as they are); each lane recomputes its h from the
//     state the forward saved as the tile began (h_tiles), keeping every
//     h_{t-1} of the tile in shared memory; then it walks the tile in
//     reverse.  exp(dt_t A) is formed once in each pass.
//   * The sums over d_inner (dB, dC) are deterministic, without float
//     atomics: a warp sums its 16 channels by shuffles, the CTA its warps
//     in order, and each CTA writes its partial of the tile; the CTA that
//     finishes a tile last (an integer counter a tile) sums all partials of
//     that tile in block order.  dA likewise: each CTA writes its batch's
//     partial, and the last of the batch's CTAs on a channel block sums
//     them in batch order.  So a step is repeatable bit for bit.
//   * Strides, not layouts, as the forward: dt, x, dy, d(dt) and dx share
//     (time, batch) strides, B, C, dB and dC theirs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 2;                    // lanes a channel
constexpr int kWarpChannels = 32 / kLanes;
constexpr int kSteps = 16;                   // the forward's tile: h_tiles

template <int Q>
struct Layout {
  static constexpr int kWarps = Q <= 8 ? 4 : (Q == 16 ? 2 : 1);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChannels = kWarps * kWarpChannels;
  static constexpr int kStates = kLanes * Q;  // a channel's states, padded
  // shared memory, in floats
  static constexpr int kRow = kSteps * kChannels;            // dt, x or dy
  static constexpr int kBC = kSteps * kStates;               // B or C
  static constexpr int kH = kWarps * kSteps * Q * 32;        // h_{t-1}
  static constexpr int kRed = kWarps * kSteps * 2 * kStates; // warp sums
  static constexpr size_t kBytes =
      size_t{4} * (3 * kRow + 2 * kBC + kH + kRed);
  static_assert(kBytes <= 227 * 1024, "fits a CTA's shared memory");
};

template <int Q>
__global__ void __launch_bounds__(Layout<Q>::kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ x,
                    const float* __restrict__ a,
                    const float* __restrict__ h_tiles,
                    const float* __restrict__ dy, const float* __restrict__ dh,
                    float* __restrict__ ddt, float* __restrict__ dbm,
                    float* __restrict__ dcm, float* __restrict__ dx,
                    float* __restrict__ da, float* __restrict__ dh0,
                    float* __restrict__ part, float* __restrict__ da_part,
                    int* __restrict__ counters, int B, int S, int di, int ds,
                    int64_t st_t, int64_t st_b, int64_t sb_t, int64_t sb_b,
                    int blocks) {
  using L = Layout<Q>;
  constexpr int K = L::kStates;
  extern __shared__ float smem[];
  float* dts = smem;                 // [tt][ch]
  float* xs = dts + L::kRow;
  float* dys = xs + L::kRow;
  float* bs = dys + L::kRow;         // [tt][s]
  float* cs = bs + L::kBC;
  float* hp_all = cs + L::kBC;       // [warp][tt][q][lane]
  float* red = hp_all + L::kH;       // [warp][tt][dB | dC][s]
  __shared__ int last;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / blocks;
  const int blk = blockIdx.x % blocks;
  const int ch0 = blk * L::kChannels;
  const int cl = warp * kWarpChannels + lane / kLanes;  // channel in the CTA
  const int i = ch0 + cl;
  const int half = lane % kLanes;
  const bool live = i < di;
  const int ntiles = (S + kSteps - 1) / kSteps;
  float* hp = hp_all + warp * kSteps * Q * 32 + lane;
  float* wred = red + warp * kSteps * 2 * K;

  float av[Q], g[Q], dacc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = half * Q + q;
    const bool on = live && s < ds;
    const int64_t at = (static_cast<int64_t>(b) * di + i) * ds + s;
    av[q] = on ? a[static_cast<int64_t>(i) * ds + s] : 0.f;
    g[q] = on ? dh[at] : 0.f;  // g_{t+1}, carried; exp(dt A) applied below
    dacc[q] = 0.f;
  }

  for (int tile = ntiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kSteps;
    // stage the tile
    for (int e = threadIdx.x; e < L::kRow; e += L::kThreads) {
      const int tt = e / L::kChannels, c = e % L::kChannels;
      const bool ok = t0 + tt < S && ch0 + c < di;
      const int64_t off = (t0 + tt) * st_t + b * st_b + ch0 + c;
      dts[e] = ok ? dt[off] : 0.f;
      xs[e] = ok ? x[off] : 0.f;
      dys[e] = ok ? dy[off] : 0.f;
    }
    for (int e = threadIdx.x; e < L::kBC; e += L::kThreads) {
      const int tt = e / K, s = e % K;
      const bool ok = t0 + tt < S && s < ds;
      const int64_t off = (t0 + tt) * sb_t + b * sb_b + s;
      bs[e] = ok ? bm[off] : 0.f;
      cs[e] = ok ? cm[off] : 0.f;
    }
    __syncthreads();

    // recompute the tile's h from the state it began with
    {
      float h[Q];
      const float* src = h_tiles +
          ((static_cast<int64_t>(b) * ntiles + tile) * di + i) * ds;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        h[q] = (live && half * Q + q < ds) ? src[half * Q + q] : 0.f;
      for (int tt = 0; tt < kSteps; ++tt) {
        const float dtv = dts[tt * L::kChannels + cl];
        const float dxv = dtv * xs[tt * L::kChannels + cl];
        const float* bq = bs + tt * K + half * Q;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          hp[(tt * Q + q) * 32] = h[q];
          h[q] = h[q] * expf(dtv * av[q]) + dxv * bq[q];
        }
      }
    }

    // the reverse walk
    for (int tt = kSteps - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float dtv = dts[tt * L::kChannels + cl];
      const float xv = xs[tt * L::kChannels + cl];
      const float dyv = dys[tt * L::kChannels + cl];
      const float u = dtv * xv;
      const float* bq = bs + tt * K + half * Q;
      const float* cq = cs + tt * K + half * Q;
      float bterm[Q], cterm[Q];
      float du = 0.f, wa = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float hprev = hp[(tt * Q + q) * 32];
        const float decay = expf(dtv * av[q]);
        const float gq = dyv * cq[q] + g[q];
        cterm[q] = dyv * (hprev * decay + u * bq[q]);
        bterm[q] = gq * u;
        du = fmaf(gq, bq[q], du);
        const float w = gq * hprev * decay;
        dacc[q] = fmaf(w, dtv, dacc[q]);
        wa = fmaf(w, av[q], wa);
        g[q] = decay * gq;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        du += __shfl_xor_sync(0xffffffffu, du, off);
        wa += __shfl_xor_sync(0xffffffffu, wa, off);
      }
      if (half == 0 && live && t < S) {
        const int64_t off = t * st_t + b * st_b + i;
        ddt[off] = fmaf(du, xv, wa);
        dx[off] = du * dtv;
      }
      // the warp's sums over its channels (lanes of one half hold the
      // same states)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int off = kLanes; off < 32; off <<= 1) {
          bterm[q] += __shfl_xor_sync(0xffffffffu, bterm[q], off);
          cterm[q] += __shfl_xor_sync(0xffffffffu, cterm[q], off);
        }
      }
      if (lane < kLanes) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          wred[(tt * 2) * K + half * Q + q] = bterm[q];
          wred[(tt * 2 + 1) * K + half * Q + q] = cterm[q];
        }
      }
    }
    __syncthreads();

    // the CTA's partial of the tile: its warps in order
    constexpr int kTileSums = kSteps * 2 * K;
    float* my_part = part +
        ((static_cast<int64_t>(b) * blocks + blk) * ntiles + tile) * kTileSums;
    for (int e = threadIdx.x; e < kTileSums; e += L::kThreads) {
      float sum = 0.f;
      for (int w = 0; w < L::kWarps; ++w) sum += red[w * kTileSums + e];
      my_part[e] = sum;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(counters + b * ntiles + tile, 1) == blocks - 1;
    __syncthreads();
    if (last) {  // every CTA of the batch has written the tile: sum them
      __threadfence();
      const float* tile_parts = part +
          (static_cast<int64_t>(b) * blocks * ntiles + tile) * kTileSums;
      for (int e = threadIdx.x; e < kTileSums; e += L::kThreads) {
        const int tt = e / (2 * K), which = (e / K) % 2, s = e % K;
        float sum = 0.f;
        for (int k = 0; k < blocks; ++k)
          sum += __ldcg(tile_parts + static_cast<int64_t>(k) * ntiles * kTileSums + e);
        if (t0 + tt < S && s < ds)
          (which ? dcm : dbm)[(t0 + tt) * sb_t + b * sb_b + s] = sum;
      }
    }
    __syncthreads();  // the tile's shared memory is read: restage it
  }

  // dh0 = exp(dt_0 A) g_0, carried; this batch's part of dA
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int s = half * Q + q;
    if (live && s < ds) {
      const int64_t at = (static_cast<int64_t>(b) * di + i) * ds + s;
      dh0[at] = g[q];
      da_part[at] = dacc[q];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + B * ntiles + blk, 1) == B - 1;
  __syncthreads();
  if (last) {  // every batch has written this channel block: sum in order
    __threadfence();
    for (int e = threadIdx.x; e < L::kChannels * ds; e += L::kThreads) {
      const int64_t at = static_cast<int64_t>(ch0) * ds + e;
      if (ch0 + e / ds >= di) continue;
      float sum = 0.f;
      for (int bb = 0; bb < B; ++bb)
        sum += __ldcg(da_part + static_cast<int64_t>(bb) * di * ds + at);
      da[at] = sum;
    }
  }
}

template <int Q>
int64_t blocks_for(int di) {
  return (di + Layout<Q>::kChannels - 1) / Layout<Q>::kChannels;
}

template <int Q>
cudaError_t launch(cudaStream_t stream, const float* dt, const float* bm,
                   const float* cm, const float* x, const float* a,
                   const float* h_tiles, const float* dy, const float* dh,
                   float* ddt, float* dbm, float* dcm, float* dx, float* da,
                   float* dh0, float* part, float* da_part, int* counters,
                   int B, int S, int di, int ds, int64_t st_t, int64_t st_b,
                   int64_t sb_t, int64_t sb_b) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<Q>::kBytes));
  if (err != cudaSuccess) return err;
  const int64_t blocks = blocks_for<Q>(di);
  if (blocks * B > INT32_MAX) return cudaErrorInvalidConfiguration;
  ssm_scan_bwd_kernel<Q><<<static_cast<int>(blocks * B), Layout<Q>::kThreads,
                           Layout<Q>::kBytes, stream>>>(
      dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm, dx, da, dh0, part,
      da_part, counters, B, S, di, ds, st_t, st_b, sb_t, sb_b,
      static_cast<int>(blocks));
  return cudaGetLastError();
}

// Q, the states a lane holds, for d_state ds (<= 64); 0 past that
int states_per_lane(int ds) {
  for (int q = 2; q <= 32; q *= 2)
    if (ds <= kLanes * q) return q;
  return 0;
}

}  // namespace

// The scratch a launch at these sizes takes, in elements: `part_floats`
// float32 partials and `counters` int32 counters (which must be zero).
extern "C" int ssm_scan_bwd_workspace_f32(int B, int S, int di, int ds,
                                          int64_t* part_floats,
                                          int64_t* counters) {
  const int q = states_per_lane(ds);
  if (B <= 0 || S <= 0 || di <= 0 || q == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = 0;
  switch (q) {
    case 2: blocks = blocks_for<2>(di); break;
    case 4: blocks = blocks_for<4>(di); break;
    case 8: blocks = blocks_for<8>(di); break;
    case 16: blocks = blocks_for<16>(di); break;
    default: blocks = blocks_for<32>(di); break;
  }
  const int64_t ntiles = (S + kSteps - 1) / kSteps;
  *part_floats = static_cast<int64_t>(B) * blocks * ntiles * kSteps * 2 *
                     kLanes * q +
                 static_cast<int64_t>(B) * di * ds;
  *counters = static_cast<int64_t>(B) * ntiles + blocks;
  return 0;
}

// dt, x, dy, ddt, dx: element (t, b, i) at t * st_t + b * st_b + i; bm, cm,
// dbm, dcm: (t, b, s) at t * sb_t + b * sb_b + s; a, da (di, ds); dh, dh0
// (B, di, ds); h_tiles (B, n_tiles, di, ds), the states the forward saved
// (n_tiles = ceil(S / 16)); work: the float32 scratch and counters of
// ssm_scan_bwd_workspace_f32, the counters zero.  All float32, d_state <=
// 64, S >= 1.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int ssm_scan_bwd_f32(const float* dt, const float* bm,
                                const float* cm, const float* x,
                                const float* a, const float* h_tiles,
                                int n_tiles, const float* dy, const float* dh,
                                float* ddt, float* dbm, float* dcm, float* dx,
                                float* da, float* dh0, float* work,
                                int* counters, int B, int S, int di, int ds,
                                int64_t st_t, int64_t st_b, int64_t sb_t,
                                int64_t sb_b, void* stream) {
  const int q = states_per_lane(ds);
  if (B <= 0 || S <= 0 || di <= 0 || q == 0 ||
      n_tiles != (S + kSteps - 1) / kSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t part_floats = 0, n_counters = 0;
  ssm_scan_bwd_workspace_f32(B, S, di, ds, &part_floats, &n_counters);
  float* da_part = work + (part_floats - static_cast<int64_t>(B) * di * ds);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q) {
    case 2:
      err = launch<2>(s, dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm, dx,
                      da, dh0, work, da_part, counters, B, S, di, ds, st_t,
                      st_b, sb_t, sb_b);
      break;
    case 4:
      err = launch<4>(s, dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm, dx,
                      da, dh0, work, da_part, counters, B, S, di, ds, st_t,
                      st_b, sb_t, sb_b);
      break;
    case 8:
      err = launch<8>(s, dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm, dx,
                      da, dh0, work, da_part, counters, B, S, di, ds, st_t,
                      st_b, sb_t, sb_b);
      break;
    case 16:
      err = launch<16>(s, dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm,
                       dx, da, dh0, work, da_part, counters, B, S, di, ds,
                       st_t, st_b, sb_t, sb_b);
      break;
    default:
      err = launch<32>(s, dt, bm, cm, x, a, h_tiles, dy, dh, ddt, dbm, dcm,
                       dx, da, dh0, work, da_part, counters, B, S, di, ds,
                       st_t, st_b, sb_t, sb_b);
      break;
  }
  return static_cast<int>(err);
}
