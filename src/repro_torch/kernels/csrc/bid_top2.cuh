// The fused auction bidding reduction of bid_top2.cu (rows read in place;
// through a clipped index it is bid_top2_gather.cu's previous design, kept
// there for measurement), and the top-2 arithmetic that auction_phase.cu
// and bid_top2_gather.cu's own kernel share with it.  See bid_top2.cu for
// what it replaces, what bounds it and its design.
//
// Per row i of group g it returns the best value v1, its column j1 and the
// second-best value v2 of
//
//     value[i, j] = -2 x_i . c_j + ||c_j||^2 - p_j
//
// over the k columns j.  The instantiations differ only in where a CTA's
// rows start in x (`row_offset`) and in how many rows and columns a lane
// holds (`Shape`); the arithmetic of a value is one code path.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace bid {

constexpr float kNeg = -1e30f;  // the reference's "minus infinity"

struct Top2 {
  float v1;
  int j1;
  float v2;
};

// Candidates reach a lane in increasing column order: a tie keeps the
// earlier column and lifts v2 to v1.  Written as selects, not branches: a
// kernel whose lone warp pushes a chain of columns pays for every branch.
__device__ __forceinline__ void push(Top2& t, float v, int j) {
  const bool first = v > t.v1;
  t.v2 = first ? t.v1 : (v > t.v2 ? v : t.v2);
  t.j1 = first ? j : t.j1;
  t.v1 = first ? v : t.v1;
}

// push with its picks forced to selects (PTX selp), where the compiler
// turns push's nested conditional into a branch a row: the same
// comparisons and the same picks, so the same bits for every input.
__device__ __forceinline__ void push_selp(Top2& t, float v, int j) {
  float v1, v2;
  int j1;
  asm("{\n\t.reg .pred first, second;\n\t"
      "setp.gt.f32 first, %3, %4;\n\t"       // v > v1
      "setp.gt.f32 second, %3, %5;\n\t"      // v > v2
      "selp.f32 %1, %3, %5, second;\n\t"     // v > v2 ? v : v2
      "selp.f32 %1, %4, %1, first;\n\t"      // first ? v1 : that
      "selp.b32 %2, %6, %7, first;\n\t"      // first ? j : j1
      "selp.f32 %0, %3, %4, first;\n\t}"     // first ? v : v1
      : "=f"(v1), "=&f"(v2), "=r"(j1)
      : "f"(v), "f"(t.v1), "f"(t.v2), "r"(j), "r"(t.j1));
  t.v1 = v1;
  t.v2 = v2;
  t.j1 = j1;
}

// A value from its dot-product chain acc = x_i . c_j (sequential fmaf over d
// from 0) and b = ||c_j||^2 - p_j.  Every kernel forms values here, so the
// compiler rounds the expression the same way in all of them.
__device__ __forceinline__ float value(float acc, float b) { return -2.f * acc + b; }

// Top-2 of the union of two disjoint column sets; the lower column wins a
// tie of the best values.
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  // `|` and `&`, not `||` and `&&`: no short-circuit branch
  const bool a_wins = (a.v1 > b.v1) | ((a.v1 == b.v1) & (a.j1 < b.j1));
  Top2 w = a_wins ? a : b;
  const float lv1 = a_wins ? b.v1 : a.v1;
  w.v2 = fmaxf(w.v2, lv1);
  return w;
}

// Element offset in x of row `row` of group g: (g * m + row) * d in place
// (Idx = void), or clip(idx[row], 0, n - 1) * d through the index.
template <typename Idx>
__device__ __forceinline__ int64_t row_offset(const Idx* idx, int64_t n,
                                              int g, int m, int row, int d) {
  if constexpr (std::is_void_v<Idx>) {
    return (static_cast<int64_t>(g) * m + row) * d;
  } else {
    int64_t s = static_cast<int64_t>(idx[row]);
    s = s < 0 ? 0 : (s >= n ? n - 1 : s);
    return s * d;
  }
}

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Dynamic shared memory a CTA takes at most: with the static words, under
// the 48 KB that needs no opt-in.
constexpr int kSmemBudget = 47 * 1024;

// A CTA's tile: a lane holds RW rows and CW columns (lane, lane + 32, ...);
// the 8 warps form WR row groups by WC column groups.  A CTA covers kRows
// rows against kCols columns a pass.
template <int RW_, int CW_, int WC_>
struct Shape {
  static constexpr int RW = RW_, CW = CW_, WC = WC_, WR = kWarps / WC_;
  static constexpr int kRows = WR * RW;
  static constexpr int kCols = WC * 32 * CW;
  static_assert(kWarps % WC_ == 0 && (RW_ == 1 || RW_ == 2 || RW_ == 4),
                "8 warps in whole column groups; 1, 2 or 4 rows a lane");
  static_assert(WC_ == 1 || kRows * WC_ <= 32,
                "one warp merges the column groups' partial top-2s");
};
// Few rows (the auction's m = 256): 4 rows a CTA, a column a lane, so
// m = 256 is 64 CTAs (128 for the span's pair) and ||c_j||^2 is formed
// once a column.  Of 1, 2 and 4 rows a CTA with a column a lane, and 4
// rows with two, 4 rows and a column ran fastest on the H100 (PERF.md).
using Narrow = Shape<4, 1, 8>;
// Many rows (a stack of more than 2 048, counting the span's two slots):
// 32 rows a CTA, 8 columns a lane, so c is staged 16 times less often and
// a lane merges 8 columns per shuffle.  The fused gather kernel has its
// own tile (bid_top2_gather.cu); only its previous design takes this one.
using Wide = Shape<4, 8, 1>;
// The most CTAs the narrow tile may take before the wide one is used.
constexpr int64_t kNarrowMaxCtas = 512;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory by the TMA, completing on `bar` (phase 0).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(b) : "memory");
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

template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// One feature f of the chains: acc[r][t] += x_r[f] c_t[f] and cn[t] +=
// c_t[f]^2, each a sequential fmaf from 0 in feature order.  xf points at
// the lane's RW rows' x[f], contiguous.
template <int RW, int CW>
__device__ __forceinline__ void accumulate(const float* xf, const float (&cv)[CW],
                                           float (&acc)[RW][CW], float (&cn)[CW]) {
  float xv[RW];
  load_rows<RW>(xf, xv);
#pragma unroll
  for (int t = 0; t < CW; ++t) {
    cn[t] = fmaf(cv[t], cv[t], cn[t]);
#pragma unroll
    for (int r = 0; r < RW; ++r) acc[r][t] = fmaf(xv[r], cv[t], acc[r][t]);
  }
}

// x: the rows (G, m, d) in place, or the (n, d) table read through idx
// (G == 1); c (G, k, d).  blockIdx.z is the slot: slot 0 bids with x at
// prices p (a null pointer means zero prices), slot 1 (the span's pair)
// with -x at prices 2 ||c_j||^2: its bias is -cn, which equals cn - 2 cn
// exactly.  v1, j1, v2 are (slots, G, m).
//
// The tile of c is cs[j * ldc + f] (column j, feature f) and of x
// xs[f * kRows + r].  `whole`: the CTA's whole k x d block of c arrives in
// one TMA bulk copy (ldc = d, one pass, one feature tile); else column
// passes of kCols and feature tiles of `dtile` are staged by the threads,
// with ldc odd so that lanes reading 32 columns hit 32 banks.
template <typename S, typename Idx>
__global__ void __launch_bounds__(kThreads)
bid_top2_kernel(const float* __restrict__ x, const Idx* __restrict__ idx,
                int64_t n, const float* __restrict__ c,
                const float* __restrict__ p, float* __restrict__ v1_out, int64_t* __restrict__ j1_out,
                float* __restrict__ v2_out, int G, int m, int k, int d,
                int dtile, int ldc, int whole) {
  constexpr int RW = S::RW, CW = S::CW, WC = S::WC, kRows = S::kRows;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar;
  __shared__ Top2 parts[WC > 1 ? kRows * WC : 1];

  float* cs = reinterpret_cast<float*>(smem4);
  const int ncs = whole ? k * d : S::kCols * ldc;
  float* xs = cs + ((ncs + 3) & ~3);

  const int slot = blockIdx.z;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp / WC, wc = warp % WC;
  const float* cg = c + static_cast<size_t>(g) * k * d;
  const float* pg = p == nullptr ? nullptr : p + static_cast<size_t>(g) * k;
  const bool neg = slot != 0;  // -x is exact, so the bits are -x's

  Top2 best[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) best[r] = {-INFINITY, INT32_MAX, -INFINITY};

  for (int k0 = 0; k0 < k; k0 += S::kCols) {
    const int kk = min(S::kCols, k - k0);
    int jl[CW];  // this lane's columns in the pass, clamped for the reads
#pragma unroll
    for (int t = 0; t < CW; ++t) jl[t] = min(wc * 32 * CW + lane + 32 * t, kk - 1);
    float acc[RW][CW], cn[CW];
#pragma unroll
    for (int t = 0; t < CW; ++t) {
      cn[t] = 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[r][t] = 0.f;
    }

    for (int d0 = 0; d0 < d; d0 += dtile) {
      const int dt = min(dtile, d - d0);
      if (whole) {  // one pass, one tile: c arrives while x is staged
        if (threadIdx.x == 0)
          bulk_load(cs, cg, static_cast<uint32_t>(k) * d * 4u, &bar);
      } else {
        __syncthreads();  // the previous tile's readers are done
        for (int jj = warp; jj < kk; jj += kWarps) {
          const float* src = cg + static_cast<size_t>(k0 + jj) * d + d0;
          for (int f = lane; f < dt; f += 32) cs[jj * ldc + f] = src[f];
        }
      }
      for (int r = warp; r < kRows; r += kWarps) {
        const int row = row0 + r;
        const float* src =
            row < m ? x + row_offset(idx, n, g, m, row, d) + d0 : nullptr;
        for (int f = lane; f < dt; f += 32) {
          const float v = src ? src[f] : 0.f;
          xs[f * kRows + r] = neg ? -v : v;
        }
      }
      __syncthreads();
      if (whole) wait_phase(&bar, 0);

      const float* xw = xs + wr * RW;
      int f = 0;
      if ((ldc & 1) == 0) {  // even rows: 8-byte reads, no bank conflict
#pragma unroll 2
        for (; f + 1 < dt; f += 2) {
          float ca[CW], cb[CW];
#pragma unroll
          for (int t = 0; t < CW; ++t) {
            const float2 q = *reinterpret_cast<const float2*>(cs + jl[t] * ldc + f);
            ca[t] = q.x;
            cb[t] = q.y;
          }
          accumulate(xw + f * kRows, ca, acc, cn);
          accumulate(xw + (f + 1) * kRows, cb, acc, cn);
        }
      }
#pragma unroll 4
      for (; f < dt; ++f) {
        float ca[CW];
#pragma unroll
        for (int t = 0; t < CW; ++t) ca[t] = cs[jl[t] * ldc + f];
        accumulate(xw + f * kRows, ca, acc, cn);
      }
    }

#pragma unroll
    for (int t = 0; t < CW; ++t) {
      const int col = k0 + wc * 32 * CW + lane + 32 * t;
      if (col < k) {
        const float b = neg ? -cn[t] : cn[t] - (pg != nullptr ? pg[col] : 0.f);
#pragma unroll
        for (int r = 0; r < RW; ++r) push(best[r], value(acc[r][t], b), col);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o;
      o.v1 = __shfl_xor_sync(0xffffffffu, best[r].v1, off);
      o.j1 = __shfl_xor_sync(0xffffffffu, best[r].j1, off);
      o.v2 = __shfl_xor_sync(0xffffffffu, best[r].v2, off);
      best[r] = merge(best[r], o);
    }
  }
  const size_t out0 = (static_cast<size_t>(slot) * G + g) * m;
  auto store = [&](int row, const Top2& t) {
    if (row < m) {
      v1_out[out0 + row] = t.v1;
      j1_out[out0 + row] = t.j1;
      v2_out[out0 + row] = fmaxf(t.v2, kNeg);  // k == 1: the sentinel
    }
  };
  if constexpr (WC == 1) {
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (lane == r) store(row0 + wr * RW + r, best[r]);
  } else {  // one warp merges the WC column groups' top-2 of each row
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r) parts[(wr * RW + r) * WC + wc] = best[r];
    }
    __syncthreads();
    constexpr int kParts = kRows * WC;
    if (threadIdx.x < kParts) {
      constexpr unsigned mask = kParts == 32 ? 0xffffffffu : (1u << kParts) - 1u;
      Top2 t = parts[threadIdx.x];
#pragma unroll
      for (int off = WC / 2; off > 0; off >>= 1) {
        Top2 o;
        o.v1 = __shfl_xor_sync(mask, t.v1, off);
        o.j1 = __shfl_xor_sync(mask, t.j1, off);
        o.v2 = __shfl_xor_sync(mask, t.v2, off);
        t = merge(t, o);
      }
      if (threadIdx.x % WC == 0) store(row0 + threadIdx.x / WC, t);
    }
  }
}

template <typename S, typename Idx>
cudaError_t launch_shape(const float* x, const Idx* idx, int64_t n,
                         const float* c, const float* p, float* v1, int64_t* j1, float* v2, int slots, int G,
                         int m, int k, int d, cudaStream_t stream) {
  const size_t cbytes = static_cast<size_t>(k) * d * 4;
  const size_t xbytes = static_cast<size_t>(S::kRows) * d * 4;
  const bool whole = k <= S::kCols && reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                     cbytes % 16 == 0 && cbytes + xbytes <= kSmemBudget;
  int dtile = d, ldc = d;
  size_t smem = cbytes + xbytes;
  if (!whole) {
    for (dtile = d < 64 ? d : 64;; --dtile) {
      ldc = dtile | 1;
      const size_t ncs = static_cast<size_t>(S::kCols) * ldc;
      smem = ((ncs + 3) & ~size_t{3}) * 4 + static_cast<size_t>(S::kRows) * dtile * 4;
      if (smem <= kSmemBudget || dtile == 1) break;
    }
  }
  const dim3 grid((m + S::kRows - 1) / S::kRows, G, slots);
  bid_top2_kernel<S, Idx><<<grid, kThreads, smem, stream>>>(
      x, idx, n, c, p, v1, j1, v2, G, m, k, d, dtile, ldc, whole);
  return cudaGetLastError();
}

// slots == 1: bid_top2(x, c, p).  slots == 2: the span's pair, bid_top2(x,
// c, p) and bid_top2(-x, c, 2 ||c||^2) in one launch.  The tile is the narrow one
// while it takes at most kNarrowMaxCtas CTAs, else the wide one; a row's
// bits do not depend on the tile.
template <typename Idx>
cudaError_t launch(const float* x, const Idx* idx, int64_t n, const float* c,
                   const float* p, float* v1, int64_t* j1, float* v2,
                   int slots, int G, int m, int k, int d,
                   cudaStream_t stream) {
  if (G <= 0 || m <= 0 || slots <= 0) return cudaSuccess;
  const int64_t narrow = static_cast<int64_t>((m + Narrow::kRows - 1) / Narrow::kRows) * G * slots;
  return narrow <= kNarrowMaxCtas
      ? launch_shape<Narrow>(x, idx, n, c, p, v1, j1, v2, slots, G, m, k, d, stream)
      : launch_shape<Wide>(x, idx, n, c, p, v1, j1, v2, slots, G, m, k, d, stream);
}

}  // namespace bid
