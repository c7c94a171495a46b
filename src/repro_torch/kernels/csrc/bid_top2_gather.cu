// Fused row gather + auction bidding reduction for Hopper (sm_90a):
// bid_top2(x[clip(idx, 0, n - 1)], c, p) without writing x[idx].
//
// Replaces the TPU kernel `_bid_gather_kernel` (with the 2-slot DMA ring
// of per-row copies that `_issue_block` / `_wait_block` drive) behind
// `bid_top2_gather_pallas` in src/repro/kernels/gather.py.  Reached through
// `repro_torch.kernels.ops.bid_top2(x, c, prices, idx=idx)` for d <= 512.
//
// What bounds it on this card: at the streaming chunk's shape (m = 8192
// indexed rows of a 253 680 x 22 table, k = 256) it does 46.1 M fp32 FMA
// and a top-2 step for each of the 2.1 M (row, column) pairs, and moves
// about 0.9 MB (the indexed rows, c, three (m,) outputs): 1.44 us of
// operations at 67 TFLOP/s against 0.27 us of bytes, so fp32 operations
// bound it.  Two things keep it from that bound.  Before its first FMA a
// CTA waits for two dependent global reads, an index and then its row;
// at this shape each CTA has one tile, so nothing hides that wait (on the
// H100 it is about a third of a CTA's cycles; the timed instantiation's
// stamps show it).  And the FMA loop issues ~32 instructions a (row,
// column) where the bound counts 23: 22 FMA, ~2.5 shared-memory reads,
// 2 for the value and 6 for the top-2 step.
//
// Design:
// - A CTA stays on its SM: the grid is the smaller of the row tiles (32
//   rows) and the CTAs the card holds at once (occupancy times SMs, asked
//   of the runtime), and each CTA loops over its tiles.
// - The first two tiles' indices are loaded first; then c comes once per
//   CTA while it fits in shared memory (`resident`), by one TMA bulk copy
//   when it is on the 16-byte grid, else by 4-byte cp.async copies along
//   its rows, and stays in c's own row-major layout (no transposition).
//   Each column's bias ||c_j||^2 - p_j is formed once per CTA, by the
//   sequential fmaf chain in feature order that bid_top2.cuh uses, so the
//   bits do not change.  Where c does not fit, column passes of 256 and
//   feature tiles are staged per tile, the bias chain carried across them.
// - The rows go through a 2-slot ring, the counterpart of the TPU kernel's
//   DMA ring: each warp's lanes 0-3 load its 4 rows' indices in one
//   coalesced load and clip them, and the warp issues every word of those
//   rows at once as cp.async (LDGSTS) copies, 8-byte granules where d is
//   even and x 8-byte aligned, else 4-byte ones; a tile's copies are one
//   commit group.  Tile t + 1 (and tile t + 2's indices) are in flight
//   while tile t's FMAs run; cp.async.wait_group and a barrier open a slot,
//   which is refilled as soon as its readers are done.
// - The ring slot is feature-major, a 16-byte chunk holding 2 rows x 2
//   features (8-byte granules) or 4 rows x 1 feature, each feature group
//   padded by one chunk: a warp's copies of consecutive granules land in
//   distinct banks but where a copy instruction straddles two row groups
//   (at most 2-way there), and the FMA loop reads a lane's rows of a
//   feature group as broadcast LDS.128s without conflict.
// - A lane holds 4 rows by 8 columns (a warp 8 row lanes by 4 column
//   lanes, 32 rows by 32 columns, a lane's columns 4 apart; the 8 warps
//   span 256 columns a pass).  Per pair of features it reads x with 2
//   LDS.128 and c with 8 LDS.64 (one a column: the 4 column lanes' rows
//   fall in distinct banks, rows of c a multiple of 16 floats long being
//   padded) for 64 FMAs.  No tensor cores: TF32 flips the auction's
//   argmaxes.
// - Each acc chain is a sequential fmaf over f from 0 and each value comes
//   from bid::value; a lane pushes its columns in increasing order with
//   bid::push_selp (bid::push's comparisons and picks as selects: the
//   compiler made a branch a row of push's nested conditional), the 4
//   column lanes and then the 8 warps merge with bid::merge, whose result
//   does not depend on the order of the merges: the tie rule (lowest
//   column; a doubled maximum gives v2 == v1), the masking of columns past
//   k and v2 floored at kNeg for k = 1 are those of bid_top2.cu, so the
//   result is bitwise bid_top2(gather_rows(x, idx), ...).
//
// For measurement only, in the same library: bid_top2_gather_prev_f32,
// the previous design (bid::launch of bid_top2.cuh through the index), and
// bid_top2_gather_timed_f32, this kernel with clock64 stamps per CTA.

#include <map>
#include <mutex>
#include <tuple>

#include "bid_top2.cuh"

namespace {

using bid::Top2;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RW = 4;                   // rows a lane
constexpr int CW = 8;                   // contiguous columns a lane
constexpr int kRows = 32;               // rows a tile: 8 row lanes x RW
constexpr int kCols = kWarps * 4 * CW;  // columns a pass: 8 warps x 4 x CW
constexpr int kSlots = 2;               // the ring
// shared memory a launch aims to stay under (two CTAs an SM); more only
// where the ring of the widest rows needs it
constexpr size_t kTargetSmem = 100 * 1024;
// stamps the timed instantiation writes per CTA, in SM cycles: issuing c,
// the first two tiles' indices and rows (the first index's load
// included); waiting for c; laying it out with its bias; waiting for
// rows, the FMA loop and pushes, the merge and store (each summed over
// the CTA's tiles); the whole CTA; and the tiles it took
constexpr int kStamps = 8;

struct Params {
  const float* x;
  const void* idx;
  int64_t n;
  const float* c;
  const float* p;  // null: zero prices
  float* v1;
  int64_t* j1;
  float* v2;
  int m, k, d;
  int tiles;     // row tiles
  int ldx;       // floats a feature group of a ring slot: kRows * GW + 4
  int slot;      // floats a ring slot
  int ldc;       // floats a row of c in shared memory
  int crows;     // rows of c (and entries of the bias) a CTA holds
  int dtile;     // features a staged c tile (d when resident)
  int resident;  // 1: all of c and the bias stay in shared memory
  int tma;       // 1 (resident only): c arrives in one bulk copy
  long long* stamps;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int Bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   bid::smem_u32(dst)),
               "l"(src), "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ Top2 shfl_xor(const Top2& t, int off) {
  Top2 o;
  o.v1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
  o.j1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
  o.v2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
  return o;
}

// Tile-local row of a lane's row i: with 8-byte granules a chunk holds
// rows (2 rl, 2 rl + 1) and the lane's second chunk is 8 chunks on, so a
// warp's 8 row lanes read 8 consecutive chunks in each LDS.128.
template <int GW>
__device__ __forceinline__ int lane_row(int rl, int i) {
  return GW == 2 ? (i < 2 ? 2 * rl + i : 16 + 2 * rl + i - 2) : RW * rl + i;
}

// Lanes 0-3 of warp w load and clip the indices of tile `tile`'s rows 4w ..
// 4w + 3 (one coalesced load); -1 past m or past the tiles.  Loaded a
// tile ahead of issue_rows, which consumes them.
template <typename Idx>
__device__ __forceinline__ int64_t load_index(const Params& P, int tile,
                                              int warp, int lane) {
  const int64_t row = static_cast<int64_t>(tile) * kRows + warp * RW + lane;
  return tile < P.tiles && lane < RW && row < P.m
      ? bid::row_offset(static_cast<const Idx*>(P.idx), P.n, 0, P.m,
                        static_cast<int>(row), 1)
      : int64_t{-1};
}

// Issue warp w's four rows (their clipped indices `s` in lanes 0-3) into
// ring slot `xs`: every granule of the four rows is one cp.async, the
// granules of a row on consecutive lanes.  Rows past m are not copied.
template <int GW>
__device__ __forceinline__ void issue_rows(const Params& P, float* xs,
                                           int64_t s, int warp, int lane) {
  constexpr int CL = 4 / GW;  // rows of a 16-byte chunk
  const int G = P.d / GW;     // granules of a row
  const int total = RW * G;
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = e0 + lane;
    const int q = e / CL, w = e % CL;
    const int fp = q % G;
    const int lr = (q / G) * CL + w;  // 0..3 for e < total
    const int64_t row = __shfl_sync(0xffffffffu, s, lr & (RW - 1));
    if (e < total && row >= 0)
      cp_async<4 * GW>(xs + fp * P.ldx + (warp * RW + lr) * GW,
                       P.x + row * P.d + fp * GW);
  }
}

// acc[r][t] += x_r[f] c_t[f] over the feature groups [0, nfp) of a slot,
// each a sequential fmaf in feature order.  xs points at the lane's first
// chunk of the slot's first group; cs at the row of c of the lane's column
// t = 0 and first feature, column t's row 4 t rows on.
template <int GW>
__device__ __forceinline__ void fma_features(const float* xs, int ldx,
                                             const float* cs, int ldc,
                                             int nfp, float (&acc)[RW][CW]) {
  const int step = 4 * ldc;
#pragma unroll 2
  for (int fp = 0; fp < nfp; ++fp) {
    const float* xf = xs + fp * ldx;
    const float* cf = cs + fp * GW;
    if constexpr (GW == 2) {
      const float4 a = *reinterpret_cast<const float4*>(xf);
      const float4 b = *reinterpret_cast<const float4*>(xf + 32);
      const float x0[RW] = {a.x, a.z, b.x, b.z}, x1[RW] = {a.y, a.w, b.y, b.w};
      float c0[CW], c1[CW];
#pragma unroll
      for (int t = 0; t < CW; ++t) {
        const float2 q = *reinterpret_cast<const float2*>(cf + t * step);
        c0[t] = q.x;
        c1[t] = q.y;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int t = 0; t < CW; ++t) acc[r][t] = fmaf(x0[r], c0[t], acc[r][t]);
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int t = 0; t < CW; ++t) acc[r][t] = fmaf(x1[r], c1[t], acc[r][t]);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(xf);
      const float x0[RW] = {a.x, a.y, a.z, a.w};
      float c0[CW];
#pragma unroll
      for (int t = 0; t < CW; ++t) c0[t] = cf[t * step];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int t = 0; t < CW; ++t) acc[r][t] = fmaf(x0[r], c0[t], acc[r][t]);
    }
  }
}

// cs[j * ldc + f] = c[(k0 + j) * d + d0 + f] for j < kk, f < dt: coalesced
// reads along c's rows.
__device__ __forceinline__ void stage_c(const Params& P, float* cs, int k0,
                                        int kk, int d0, int dt) {
  const int total = kk * dt;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int j = e / dt, f = e - j * dt;
    cs[j * P.ldc + f] = P.c[static_cast<size_t>(k0 + j) * P.d + d0 + f];
  }
}

__device__ __forceinline__ float price(const Params& P, int col) {
  return P.p != nullptr ? P.p[col] : 0.f;
}

// ||c_j||^2 over the features [0, dt) of row j of cs, carried on from cn:
// the sequential fmaf chain in feature order of bid_top2.cuh.
__device__ __forceinline__ float norm_chain(const float* row, int dt,
                                            float cn) {
#pragma unroll 8
  for (int f = 0; f < dt; ++f) cn = fmaf(row[f], row[f], cn);
  return cn;
}

template <int GW, typename Idx, bool kTimed>
__global__ void __launch_bounds__(kThreads, 2)
bid_top2_gather_kernel(const Params P) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar;
  __shared__ Top2 parts[kWarps][kRows];
  float* ring = reinterpret_cast<float*>(smem4);
  float* cs = ring + kSlots * P.slot;
  float* bias = cs + ((P.crows * P.ldc + 3) & ~3);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = lane & 3, rl = lane >> 2;
  const int wb = warp * 32;  // the warp's first column in a pass
  long long t_mark = 0, t_start = 0, cyc[kStamps - 2] = {};
  auto stamp = [&](int stage) {
    if constexpr (kTimed) {
      const long long now = clock64();
      cyc[stage] += now - t_mark;
      t_mark = now;
    }
  };
  if constexpr (kTimed) t_start = t_mark = clock64();

  // the first two tiles' indices lead; then c (by the TMA on the 16-byte
  // grid, else by 4-byte copies along its rows, its own commit group) and
  // the tiles' rows fly together
  int tile = blockIdx.x;
  const int64_t s0 = load_index<Idx>(P, tile, warp, lane);
  int64_t s_next = load_index<Idx>(P, tile + gridDim.x, warp, lane);
  const float p_own =
      P.resident && threadIdx.x < P.k ? price(P, threadIdx.x) : 0.f;
  if (P.resident) {
    if (P.tma) {
      if (threadIdx.x == 0)
        bid::bulk_load(cs, P.c, static_cast<uint32_t>(P.k) * P.d * 4u, &bar);
    } else {
      for (int e = threadIdx.x; e < P.k * P.d; e += kThreads) {
        const int j = e / P.d;
        cp_async<4>(cs + j * P.ldc + (e - j * P.d), P.c + e);
      }
    }
  }
  cp_async_commit();
  issue_rows<GW>(P, ring, s0, warp, lane);
  cp_async_commit();
  issue_rows<GW>(P, ring + P.slot, s_next, warp, lane);
  cp_async_commit();
  stamp(0);

  if (P.resident) {
    if (P.tma) {
      __syncthreads();  // the barrier's init is visible
      bid::wait_phase(&bar, 0);
    } else {
      cp_async_wait<2>();  // this thread's copies of c, not the rows'
      __syncthreads();
    }
    stamp(1);
    for (int j = threadIdx.x; j < P.k; j += kThreads)
      bias[j] = norm_chain(cs + j * P.ldc, P.d, 0.f) -
                (j == threadIdx.x ? p_own : price(P, j));
    // the bias's readers pass the barrier at the top of the tile loop
  }
  stamp(2);

  for (int i = 0; tile < P.tiles; ++i, tile += gridDim.x) {
    float* xs = ring + (i & 1) * P.slot;
    cp_async_wait<1>();  // this thread's copies of tile i have landed
    __syncthreads();     // A: everyone's have
    stamp(3);
    s_next = load_index<Idx>(P, tile + 2 * gridDim.x, warp, lane);

    Top2 best[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) best[r] = {-INFINITY, INT32_MAX, -INFINITY};
    const float* xl = xs + 4 * rl;  // the lane's first chunk
    for (int k0 = 0; k0 < P.k; k0 += kCols) {
      float acc[RW][CW];
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int t = 0; t < CW; ++t) acc[r][t] = 0.f;
      const bool live = k0 + wb < P.k;  // the warp has columns in the pass
      const float* bcol;  // the bias of the lane's column t = 0
      if (P.resident) {
        if (live)
          fma_features<GW>(xl, P.ldx, cs + (k0 + wb + cl) * P.ldc, P.ldc,
                           P.d / GW, acc);
        bcol = bias + k0 + wb + cl;
      } else {
        const int kk = min(kCols, P.k - k0);
        float cn = 0.f;  // column k0 + threadIdx.x's chain, over the tiles
        for (int d0 = 0; d0 < P.d; d0 += P.dtile) {
          const int dt = min(P.dtile, P.d - d0);
          __syncthreads();  // the previous tile's (or pass's) readers
          stage_c(P, cs, k0, kk, d0, dt);
          __syncthreads();
          if (threadIdx.x < kk)
            cn = norm_chain(cs + threadIdx.x * P.ldc, dt, cn);
          if (live)
            fma_features<GW>(xl + (d0 / GW) * P.ldx, P.ldx,
                             cs + (wb + cl) * P.ldc, P.ldc, dt / GW, acc);
        }
        if (threadIdx.x < kk) bias[threadIdx.x] = cn - price(P, k0 + threadIdx.x);
        __syncthreads();
        bcol = bias + wb + cl;
      }
      if (live) {
#pragma unroll
        for (int t = 0; t < CW; ++t) {
          const int col = k0 + wb + cl + 4 * t;
          if (col < P.k) {
            const float b = bcol[4 * t];
#pragma unroll
            for (int r = 0; r < RW; ++r)
              bid::push_selp(best[r], bid::value(acc[r][t], b), col);
          }
        }
      }
    }
    // the 4 column lanes of a row, then the 8 warps
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      best[r] = bid::merge(best[r], shfl_xor(best[r], 1));
      best[r] = bid::merge(best[r], shfl_xor(best[r], 2));
      if (cl == 0) parts[warp][lane_row<GW>(rl, r)] = best[r];
    }
    stamp(4);
    __syncthreads();  // B: slot i & 1 and the parts are read and written
    issue_rows<GW>(P, xs, s_next, warp, lane);
    cp_async_commit();

    const int row = threadIdx.x >> 3, q = threadIdx.x & 7;
    Top2 t = parts[q][row];
    t = bid::merge(t, shfl_xor(t, 1));
    t = bid::merge(t, shfl_xor(t, 2));
    t = bid::merge(t, shfl_xor(t, 4));
    const int64_t grow = static_cast<int64_t>(tile) * kRows + row;
    if (q == 0 && grow < P.m) {
      P.v1[grow] = t.v1;
      P.j1[grow] = t.j1;
      P.v2[grow] = fmaxf(t.v2, bid::kNeg);  // k == 1: the sentinel
    }
    stamp(5);
  }
  cp_async_wait<0>();
  if constexpr (kTimed) {
    if (threadIdx.x == 0) {
      long long* out = P.stamps + static_cast<size_t>(blockIdx.x) * kStamps;
      for (int i = 0; i < kStamps - 2; ++i) out[i] = cyc[i];
      out[kStamps - 2] = clock64() - t_start;
      out[kStamps - 1] = (P.tiles - 1 - blockIdx.x) / gridDim.x + 1;
    }
  }
}

// Per device: SMs and the shared memory a CTA may opt in to; per kernel,
// device and dynamic shared memory: the CTAs an SM holds (the attribute
// set first where it passes 48 KB).
std::mutex cache_lock;
std::map<int, std::pair<int, int>> device_cache;
// (kernel, device, dynamic bytes) -> CTAs an SM; (kernel, device, 0) marks
// the attribute set
std::map<std::tuple<uintptr_t, int, size_t>, int> occupancy_cache;

cudaError_t device_limits(int dev, int* sms, int* optin) {
  std::lock_guard<std::mutex> hold(cache_lock);
  auto it = device_cache.find(dev);
  if (it == device_cache.end()) {
    int a = 0, b = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&a, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
    if (err != cudaSuccess) return err;
    it = device_cache.emplace(dev, std::make_pair(a, b)).first;
  }
  *sms = it->second.first;
  *optin = it->second.second;
  return cudaSuccess;
}

// The kernel's dynamic shared memory may reach `budget` on this device: set
// once a kernel and device, since the attribute is the kernel's and holds
// for every later launch.
template <typename K>
cudaError_t ctas_per_sm(K kernel, int dev, size_t smem, size_t budget,
                        int* blocks) {
  std::lock_guard<std::mutex> hold(cache_lock);
  const uintptr_t fn = reinterpret_cast<uintptr_t>(kernel);
  const auto key = std::make_tuple(fn, dev, smem);
  auto it = occupancy_cache.find(key);
  if (it == occupancy_cache.end()) {
    cudaError_t err = cudaSuccess;
    const auto opted = std::make_tuple(fn, dev, size_t{0});
    if (occupancy_cache.find(opted) == occupancy_cache.end()) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(budget));
      if (err != cudaSuccess) return err;
      occupancy_cache.emplace(opted, 0);
    }
    int b = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (b < 1) return cudaErrorInvalidConfiguration;
    it = occupancy_cache.emplace(key, b).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

size_t round4(size_t floats) { return (floats + 3) & ~size_t{3}; }

template <int GW, typename Idx, bool kTimed>
cudaError_t launch_gather(Params P, cudaStream_t stream, int* grid_out) {
  if (grid_out != nullptr) *grid_out = 0;
  if (P.m <= 0) return cudaSuccess;
  if (P.k <= 0 || P.d <= 0 || P.d % GW != 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = device_limits(dev, &sms, &optin);
  if (err != cudaSuccess) return err;

  P.tiles = (P.m + kRows - 1) / kRows;
  P.ldx = kRows * GW + 4;
  P.slot = (P.d / GW) * P.ldx;
  const size_t ring = static_cast<size_t>(kSlots) * P.slot;
  // the kernel's static words (the parts and the barrier), with room
  const size_t budget = static_cast<size_t>(optin) - 4 * 1024;

  // A lane reads 4 rows of c 1, 2 or 3 rows apart; they fall in distinct
  // banks unless the row stride is a multiple of 16 floats, so such rows
  // are padded (to 2 mod 4 for 8-byte reads, odd for 4-byte ones).
  auto row_stride = [](int dt) {
    if (GW == 2) return dt % 4 == 2 ? dt : dt + 2;
    return dt | 1;
  };
  // resident: c's rows, rounded to a warp's 32 columns, and its bias
  const int ldc = P.d % 16 != 0 ? P.d : row_stride(P.d);
  const int crows = (P.k + 31) / 32 * 32;
  size_t smem = 4 * (ring + round4(static_cast<size_t>(crows) * ldc) +
                     round4(crows));
  if (smem <= kTargetSmem) {
    const size_t cbytes = static_cast<size_t>(P.k) * P.d * 4;
    P.resident = 1;
    P.tma = ldc == P.d && reinterpret_cast<uintptr_t>(P.c) % 16 == 0 &&
            cbytes % 16 == 0;
    P.ldc = ldc;
    P.crows = crows;
    P.dtile = P.d;
  } else {  // column passes of kCols, feature tiles of dtile, per tile
    P.resident = 0;
    P.tma = 0;
    P.crows = kCols;
    auto bytes = [&](int dt) {
      return 4 * (ring + round4(static_cast<size_t>(kCols) * row_stride(dt)) +
                  kCols);
    };
    const size_t room = bytes(P.d < 32 ? P.d : 32) <= kTargetSmem
                            ? kTargetSmem : budget;
    int dtile = P.d;
    while (dtile > GW && bytes(dtile) > room) dtile -= GW;
    P.dtile = dtile;
    P.ldc = row_stride(dtile);
    smem = bytes(dtile);
  }
  if (smem > budget) return cudaErrorInvalidValue;

  auto kernel = bid_top2_gather_kernel<GW, Idx, kTimed>;
  int blocks = 0;
  err = ctas_per_sm(kernel, dev, smem, budget, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t held = static_cast<int64_t>(blocks) * sms;
  const int grid = static_cast<int>(P.tiles < held ? P.tiles : held);
  kernel<<<grid, kThreads, smem, stream>>>(P);
  if (grid_out != nullptr) *grid_out = grid;
  return cudaGetLastError();
}

template <bool kTimed>
int gather(const float* x, const void* idx, int idx_is_64, const float* c,
           const float* p, float* v1, int64_t* j1, float* v2, int64_t n,
           int m, int k, int d, long long* stamps, int* grid, void* stream) {
  Params P{};
  P.x = x; P.idx = idx; P.n = n; P.c = c; P.p = p;
  P.v1 = v1; P.j1 = j1; P.v2 = v2;
  P.m = m; P.k = k; P.d = d;
  P.stamps = stamps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  cudaError_t err;
  if (idx_is_64) {
    err = pairs ? launch_gather<2, int64_t, kTimed>(P, s, grid)
                : launch_gather<1, int64_t, kTimed>(P, s, grid);
  } else {
    err = pairs ? launch_gather<2, int32_t, kTimed>(P, s, grid)
                : launch_gather<1, int32_t, kTimed>(P, s, grid);
  }
  return static_cast<int>(err);
}

}  // namespace

// x (n, d), c (k, d), p (k,) float32 contiguous; idx (m,) int32
// (idx_is_64 == 0) or int64; v1, v2 (m,) float32 and j1 (m,) int64 are
// written.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int bid_top2_gather_f32(const float* x, const void* idx,
                                   int idx_is_64, const float* c,
                                   const float* p, float* v1, int64_t* j1,
                                   float* v2, int64_t n, int m, int k, int d,
                                   void* stream) {
  return gather<false>(x, idx, idx_is_64, c, p, v1, j1, v2, n, m, k, d,
                       nullptr, nullptr, stream);
}

// The same launch with per-CTA clock64 stamps, for measurement only:
// stamps holds kStamps int64 a CTA for at least ceil(m / 32) CTAs, and
// *grid (host memory) receives the CTAs launched.
extern "C" int bid_top2_gather_timed_f32(const float* x, const void* idx,
                                         int idx_is_64, const float* c,
                                         const float* p, float* v1,
                                         int64_t* j1, float* v2, int64_t n,
                                         int m, int k, int d,
                                         long long* stamps, int* grid,
                                         void* stream) {
  return gather<true>(x, idx, idx_is_64, c, p, v1, j1, v2, n, m, k, d,
                      stamps, grid, stream);
}

// The previous design, for measurement only: bid_top2.cuh's kernel staging
// its rows through the index a warp a row at a time (the wide tile at m =
// 8192: 32 rows a CTA, one CTA a tile, c restaged by each).
extern "C" int bid_top2_gather_prev_f32(const float* x, const void* idx,
                                        int idx_is_64, const float* c,
                                        const float* p, float* v1,
                                        int64_t* j1, float* v2, int64_t n,
                                        int m, int k, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = idx_is_64
      ? bid::launch(x, static_cast<const int64_t*>(idx), n, c, p, v1,
                    j1, v2, 1, 1, m, k, d, s)
      : bid::launch(x, static_cast<const int32_t*>(idx), n, c, p, v1,
                    j1, v2, 1, 1, m, k, d, s);
  return static_cast<int>(err);
}
