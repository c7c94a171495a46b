// One epsilon phase of the Jacobi auction, for Hopper (sm_90a): the kernel
// that auction_phase.cu (the factored values) and auction_phase_dense.cu
// (the values of an explicit cost stack) instantiate.
//
// Replaces the JAX `lax.while_loop` of `_auction_phase`
// (src/repro/core/assignment.py:115-213), run over the factored reduction of
// `auction_solve_factored` or over `_top2_batched` of `auction_solve`'s
// dense cost, and the port's Python counterpart of that loop
// (`kernels.ref.auction_rounds` over `factored_top2` or over `top2`), which
// launched about twenty small PyTorch kernels per bidding round.  It is not
// the port of a `pallas_call`: the TPU kernel `_bid_kernel` is ported as
// bid_top2.cu, and its arithmetic is shared here through bid_top2.cuh.
//
// Which route runs which: the "auction_fused" solver (the stream route of
// `anticluster(x, k, chunk_size="auto")` at scale) runs the factored
// instantiation, one launch per phase; the "auction" solver (the default
// spec's flat route and the stacked route) runs the dense one, one launch
// per LAP (all its phases).
//
// Per group g of a stack it runs each phase to its end: rows i bid for
// objects j at value
//
//     value[i, j] = -2 x_i . c_j + ||c_j||^2 - p_j   (factored, real rows)
//     value[i, j] = -p_j                             (factored, dummy rows)
//     value[i, j] = cost[g, i, j] - p_j              (dense)
//
// each unassigned row bids ((v1 + p[j1]) - v2) + eps on its best object j1,
// every object goes to its highest bid (the lowest row among equal bids),
// the previous owner is unassigned and the price rises to the winning bid;
// until no row is unassigned or `max_rounds` rounds have run (or exactly
// `fixed_rounds` rounds when that is > 0).  The results are bitwise those of
// the Python loop: a factored value is the same sequential fmaf chain over d
// as bid_top2.cuh, formed by its `bid::value`, ||c_j||^2 the same chain; a
// dense value is the one float32 subtraction of `cost - p` (`__fsub_rn`, so
// nothing contracts it); the top-2 is the same order-free merge (larger
// value, then lower column; a maximum that occurs twice gives v2 = v1, as
// `ref.top2`), the bid the same three float32 additions, and the per-object
// best bid and lowest winning row are exact.  The two value sources differ
// in the top-2 of a row (`FactoredRows` / `DenseRows` below) and in the
// CTA path's work item; the bid posting, the update, the bidder lists, the
// one-warp path and the counters are one code path.
//
// What bounds it on this card: operations, and at the main shape the
// latency of a round.  A round costs bidders x n x 2d FLOP; a main-shape LAP
// (n = 256, d = 22, ~5 000 bids) comes to tens of MFLOP, under a
// microsecond at the fp32 peak, but it runs ~500 rounds one after another,
// and four in five of them have a single bidder: a lone bidder after its
// object's owner was outbid, in chains that last until the phase ends.  A
// LAP is sequential with the next (batch b + 1 bids against the centroids
// batch b moved), so the design keeps one SM busy for a whole phase with no
// host round trip, and makes the lone-bidder round short:
//   * grid = G CTAs of 512 threads, one per group; the CTA runs every round
//     of its phase and tests the stopping rule itself after each round.
//   * c (feature-major, 16-byte aligned rows, so a lane reads four
//     consecutive columns at once) and ||c||^2 are staged in shared memory
//     once per phase, with x, the prices, the assignment, each object's
//     owner and best bid, and the bidder lists of this round and the next
//     (kShared).  Where x and c do not fit beside that state they are read
//     from device memory instead, c through a feature-major copy the CTA
//     writes once per phase (kState); where the state itself does not fit (n
//     above about 6 300) it lives in the caller's scratch too, so only the
//     partial top-2s stay in shared memory (kNone).  All of it is read by
//     one SM and stays in L2.
//   * Few bidders (at most warp_threshold(n, d), the crossover measured on
//     the card): warp 0 runs the rounds alone while the other warps wait at
//     one barrier.  A bidder's lanes cover all n columns (lane l the float4
//     groups 4l + 128q), each an independent fmaf chain over d, with the
//     column terms ||c||^2 - p loaded before the chains (a single warp has
//     no other warp to hide a load behind), then one warp merge; lane s
//     keeps bidder s's bid.  A lone bidder wins outright; more post their
//     bids with a shared atomicMax and read back, after a __syncwarp,
//     whether they won.  The update touches only the objects bid on, and a
//     ballot lists the next round's bidders.  No CTA barrier a round.  The
//     count of unassigned rows never rises, so once a phase is here it
//     stays to its end.
//   * More bidders: a factored warp item is two bidders (one if only one is
//     left) against one tile of 64 columns (or every kMaxParts-th tile, for
//     n above 16 384); each item leaves a top-2 per row and item in shared
//     memory, a team of lanes per bidder merges its tiles by shuffles, and
//     the team's first lane forms the bid and posts it (a dense warp item
//     is two whole rows: below).  Then one pass over
//     the bidders (not the objects) moves ownership and prices and lists
//     the outbid owners and the losers: the next round's bidders, in no
//     particular order (no result depends on it).  Three barriers a round.
//   * A bid is posted as one 64-bit atomicMax of (order-preserving bits of
//     the bid, ~row): the largest bid wins, the lowest row among equal
//     bids, exactly and in any order.  The winner resets its object's slot,
//     so every slot is empty between rounds without a pass over n (a loser
//     reads the winner's key or the empty slot, and loses either way).
//   * Dummy rows all share the top-2 of -p, computed by one warp in a
//     round where it may be needed.
//   * The counters: per phase and group the rounds run go to `rounds_g`;
//     the bids are added to counters[1], the rounds with a single bidder to
//     counters[3], and the last CTA to finish adds, phase by phase, the
//     largest group's rounds to counters[0] (the round count of the Python
//     loop over the whole stack), so reading them needs no launch and no
//     sync per phase.
//   * The timed instantiations (measurement only) stamp clock64() around
//     every round of group 0 and its steps and record (bidders, cycles,
//     path, steps, bidders on staged rows); they may also move the
//     crossover, to time both kinds of round at one bidder count.
//
// The dense values, and a LAP in one launch.  A cost row has no d-chain:
// a value is one load and one subtraction.  A LAP of the main shape (n =
// 256) runs ~1 220 rounds, one after another, so the kernel is bound by
// the latency of a round, not by bytes or operations: its bound (the cost
// read once, 0.08 us) is ~10^4 times under its ~0.95 ms a LAP (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md).  Measured before this design (the
// parent's timed instantiation): the cost already sat in L1 (the block used
// ~21 KB of shared memory, L1 kept the rest of the SM's 256 KB), a lone
// round took ~1 150 cycles, most of them its top-2's chain, and a round of
// more than 32 bidders ~17 000, bound by issuing ~120 merge instructions
// a lane for each of 512 two-row, 64-column warp items.
// What the dense instantiation does about it:
//   * One launch runs the P phases of a LAP's (P, G) eps schedule back to
//     back, each from every row unassigned and the prices of the one
//     before: the LAP costs the host one launch and no read (the schedule
//     is formed on the device), and the cost is staged once.
//   * The CTA path reduces whole rows, a warp a bidder (two bidders at a
//     time, their loads and merges interleaved, where there are more
//     bidders than warps), as the warp path does; it keeps no partial
//     top-2s.  A > 32-bidder round takes about half the cycles it did.
//   * The cost rows are staged in shared memory once a launch, as many as
//     fit beside the state: 217 of 256 at n = 256 (the group's 256 KB does
//     not fit in 227 KB), 104 of 512, all of them up to n ~ 240, fewer
//     above, a few where the state itself lives in device memory (kNone).
//     A TMA bulk copy on an mbarrier stages them where the rows are
//     16-byte aligned (n % 4 == 0), the threads elsewhere.  A row past
//     them is read through L1, with the least shared-memory carve-out
//     that holds the block set explicitly.  Staged rows are read as fast
//     as rows that L1 holds (measured), but are never evicted: the
//     staging saves ~2 % of the cycles, not more.  Which rows are staged
//     is a residency chosen from n, never a fallback.
//   * A bidder's top-2 is its lanes' float4 groups of the row, then three
//     `redux.sync` (redux_merge) in place of five shuffle levels (~1 %).
//   * The warp path takes the lone rounds at n = 256 (re-timed with the
//     new CTA path, which now wins from 2 bidders); where it takes 2 (n <=
//     128), their rows are reduced at once.
// Dummy rows need nothing of their own: the solver zeroes their cost rows,
// so they see -p.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bid_top2.cuh"

namespace phase {

using bid::Top2;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;            // bidder rows a warp item reduces at once
constexpr int kCols = 2;            // columns a lane owns in a tile
constexpr int kTileK = 32 * kCols;  // columns per tile
constexpr int kMaxParts = 256;      // partial top-2s a row, at most
constexpr size_t kSmemBudget = 232448 - 1024;  // opt-in limit less static
constexpr int kStateWords = 10;     // scratch words a row for the state
// The warp path: a lane owns kWarpVecs float4 column groups of a warp tile,
// and one bidder (its lane) in the update.
constexpr int kWarpVecs = 2;
constexpr int kWarpTile = 32 * 4 * kWarpVecs;  // columns per warp tile
constexpr int kMaxWarpBidders = 32;
// The crossover, in fmaf a lane may spend on a round's bidders in the warp
// path (bidders x ceil(n / 32) x d).  Measured on the H100 at n = 256,
// d = 22 (176 a bidder; PERF.md): one bidder ran faster in one warp than on
// the CTA path, two slower.
constexpr int kWarpWork = 256;
// A dense value is one load where a factored one is d fmaf: the crossover
// counts a dense column as this many fmaf, so at n = 256 only lone rounds
// take the warp path (2 bidders at n <= 128; a lone dense bidder always
// does: the CTA path would run the same row reduction between barriers).
// Timed on the H100 at n = 256 by every bidder count, each round forced to
// each path (PERF.md):
// on the CTA path that reduces a row a warp, 2 bidders take 1 739 cycles
// against the warp path's 2 097; a lone bidder 1 740 against 1 216.
constexpr int kDenseColumnWork = 32;

// What lives in shared memory: the per-row state, x and c (kShared); the
// state only (kState); neither (kNone).  The factored CTA path's partial
// top-2s always do, and the dense launch's staged cost rows where they fit.
enum Residency { kShared, kState, kNone };
// Where the state (36 bytes a row) fits, a row has no more tiles than parts.
static_assert(kSmemBudget / 36 <= static_cast<size_t>(kMaxParts) * kTileK,
              "kShared and kState take one tile a warp item");
constexpr unsigned kFull = 0xffffffffu;

// The timed instantiation's record of round `it` of group 0: bidders,
// cycles, 1 for the warp path (else 0), the cycles of its three steps: the
// top-2s, posting the bids, the update, and the bidders whose cost rows
// were read from shared memory (dense; 0 for the factored values).
constexpr int kTraceCols = 7;
__device__ __forceinline__ void record(long long* trace, int it, int bidders,
                                       int warp_path, long long t0,
                                       long long reduce, long long post,
                                       int staged) {
  const long long cycles = clock64() - t0;
  long long* r = trace + static_cast<size_t>(kTraceCols) * it;
  r[0] = bidders;
  r[1] = cycles;
  r[2] = warp_path;
  r[3] = reduce;
  r[4] = post;
  r[5] = cycles - reduce - post;
  r[6] = staged;
}

// Monotone map of a float onto unsigned integers and back.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A bid as one integer: the larger bid is the larger integer, and of equal
// bids the lower row.  The low word is never 0 for a row (the empty slot).
__device__ __forceinline__ unsigned long long pack_bid(float b, int row) {
  return (static_cast<unsigned long long>(order_key(b)) << 32) |
         static_cast<unsigned>(~row);
}

// The merge of a Top2 with lane ^ off's, for every off below `width`.
__device__ __forceinline__ Top2 xor_merge(Top2 t, int width) {
#pragma unroll 1
  for (int off = width >> 1; off > 0; off >>= 1) {
    Top2 o;
    o.v1 = __shfl_xor_sync(kFull, t.v1, off);
    o.j1 = __shfl_xor_sync(kFull, t.j1, off);
    o.v2 = __shfl_xor_sync(kFull, t.v2, off);
    t = bid::merge(t, o);
  }
  return t;
}

__device__ __forceinline__ Top2 warp_merge(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.v1 = __shfl_xor_sync(kFull, t.v1, off);
    o.j1 = __shfl_xor_sync(kFull, t.j1, off);
    o.v2 = __shfl_xor_sync(kFull, t.v2, off);
    t = bid::merge(t, o);
  }
  t.v2 = fmaxf(t.v2, bid::kNeg);  // the reference's sentinel
  return t;
}

// warp_merge of R rows, level by level, so the rows' shuffles overlap.
template <int R>
__device__ __forceinline__ void warp_merge_rows(Top2 (&t)[R]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      Top2 o;
      o.v1 = __shfl_xor_sync(kFull, t[i].v1, off);
      o.j1 = __shfl_xor_sync(kFull, t[i].j1, off);
      o.v2 = __shfl_xor_sync(kFull, t[i].v2, off);
      t[i] = bid::merge(t[i], o);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) t[i].v2 = fmaxf(t[i].v2, bid::kNeg);
}

// The top-2 of a warp tile's columns in one lane, as a merge tree: a
// shorter chain than pushing them one by one (the merge is order-free: the
// same top-2).
__device__ __forceinline__ Top2 merge_tree(Top2 (&m)[kWarpVecs * 4]) {
#pragma unroll
  for (int w = kWarpVecs * 2; w > 0; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w; ++i) m[i] = bid::merge(m[i], m[i + w]);
  }
  return m[0];
}

// The top-2 of -p over the n objects (every dummy row's), in every lane.
__device__ __forceinline__ Top2 dummy_top2(const float* price, int n, int lane) {
  Top2 dm = {-INFINITY, INT32_MAX, -INFINITY};
#pragma unroll 1
  for (int j = lane; j < n; j += 32) bid::push(dm, -price[j], j);
  return warp_merge(dm);
}

// The factored values' source.  xs holds the rows (n x d); ct is c
// feature-major, d rows of ldc floats (a multiple of 4, 16-byte aligned, 0
// past the last column), then row d: ||c_j||^2 - p_j, -inf past the last
// column (a value of -inf leaves a top-2 as it was).
struct FactoredRows {
  const float* xs;
  const float* ct;
  int ldc, d, n;

  // The top-2 of row r over all n columns, by one warp, in every lane:
  // lane l takes the columns k0 + 4l + 128v + (0..3) of each warp tile k0.
  __device__ __forceinline__ Top2 row_top2(int r, int lane) const {
    const float* xr = xs + static_cast<size_t>(r) * d;
    Top2 t = {-INFINITY, INT32_MAX, -INFINITY};
    const int ld4 = ldc >> 2;
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += kWarpTile) {
      float acc[kWarpVecs][4];
      float4 b[kWarpVecs];
      const float4* cv[kWarpVecs];
      bool live[kWarpVecs];
#pragma unroll
      for (int v = 0; v < kWarpVecs; ++v) {
        const int col = k0 + 4 * lane + 128 * v;
        live[v] = col < n;
        cv[v] = reinterpret_cast<const float4*>(ct + col);
        b[v] = live[v] ? cv[v][d * ld4]
                       : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[v][q] = 0.f;
      }
#pragma unroll 4
      for (int dd = 0; dd < d; ++dd) {
        const float xv = xr[dd];
#pragma unroll
        for (int v = 0; v < kWarpVecs; ++v) {
          const float4 c4 = live[v] ? cv[v][dd * ld4] : make_float4(0.f, 0.f, 0.f, 0.f);
          acc[v][0] = fmaf(xv, c4.x, acc[v][0]);
          acc[v][1] = fmaf(xv, c4.y, acc[v][1]);
          acc[v][2] = fmaf(xv, c4.z, acc[v][2]);
          acc[v][3] = fmaf(xv, c4.w, acc[v][3]);
        }
      }
      Top2 m[kWarpVecs * 4];
#pragma unroll
      for (int v = 0; v < kWarpVecs; ++v) {
        const float bv[4] = {b[v].x, b[v].y, b[v].z, b[v].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m[4 * v + q] = {bid::value(acc[v][q], bv[q]), k0 + 4 * lane + 128 * v + q,
                          -INFINITY};
        }
      }
      t = bid::merge(t, merge_tree(m));
    }
    return warp_merge(t);
  }

  // The values of R listed rows at the columns k0 + lane + 32q of a tile,
  // -inf past the last column.
  template <int R>
  __device__ __forceinline__ void tile_values(const int* rows, int k0, int lane,
                                              float (&v)[R][kCols]) const {
    const float* xr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xr[i] = xs + static_cast<size_t>(rows[i]) * d;
    float acc[R][kCols], b[kCols];  // b: row d of ct
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int col = k0 + lane + 32 * q;
      b[q] = col < n ? ct[static_cast<size_t>(d) * ldc + col] : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
    const float* cc = ct + k0 + lane;
    const int cols_left = n - k0 - lane;  // column q is live if 32q < this
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float xv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) xv[i] = xr[i][dd];
      const float* cr = cc + static_cast<size_t>(dd) * ldc;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float cv = 32 * q < cols_left ? cr[32 * q] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][q] = fmaf(xv[i], cv, acc[i][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int i = 0; i < R; ++i) v[i][q] = bid::value(acc[i][q], b[q]);
  }
};

// The top-2 of a warp's lanes by three `redux.sync` on order-preserving
// keys, in every lane: the largest v1, the lowest column at it, then the
// largest of that column's v2 and every other lane's v1.  The same top-2 as
// warp_merge's five shuffle levels (a repeated maximum gives v2 = v1), with
// -0.0 keyed as +0.0, which the float compare treats as equal.  v1 and v2
// come back from their keys, so a zero comes back +0.0: a zero's sign
// cannot change a bid ((v1 + p) - v2) + eps with eps > 0, their only use.
__device__ __forceinline__ unsigned zero_key(float v) {
  return order_key(v == 0.f ? 0.f : v);
}

__device__ __forceinline__ Top2 redux_merge(const Top2& t) {
  const unsigned k1 = zero_key(t.v1);
  const unsigned m1 = __reduce_max_sync(kFull, k1);
  const unsigned j = __reduce_min_sync(
      kFull, k1 == m1 ? static_cast<unsigned>(t.j1) : 0xffffffffu);
  const unsigned m2 = __reduce_max_sync(
      kFull, static_cast<unsigned>(t.j1) == j ? zero_key(t.v2) : k1);
  return {key_value(m1), static_cast<int>(j), fmaxf(key_value(m2), bid::kNeg)};
}

// Loads from shared memory by their own instruction, so that a row known to
// be staged is never also read from device memory.
__device__ __forceinline__ float lds(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(bid::smem_u32(p)));
  return v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(bid::smem_u32(p)));
  return v;
}

// The dense values' source: the group's (n, n) cost rows, row-major, the
// first `staged` of them also in shared memory (`rows_sh`, staged once a
// launch), and the prices (in shared memory, or in scratch for kNone).
// `vec`: n is a multiple of 4 and the rows are 16-byte aligned, so a lane
// loads float4s.  A row is read from shared memory if it is staged, else
// from device memory; which one is the same in every lane.
struct DenseRows {
  const float* cost;
  const float* rows_sh;
  const float* price;
  int n, staged;
  bool vec;

  // The 4 values of row r at columns col .. col + 3 (vec).
  __device__ __forceinline__ float4 values4(int r, bool sh, int col) const {
    const size_t e = static_cast<size_t>(r) * n + col;
    const float4 cv = sh ? lds4(rows_sh + e)
                         : __ldg(reinterpret_cast<const float4*>(cost + e));
    const float4 pv = *reinterpret_cast<const float4*>(price + col);
    return make_float4(__fsub_rn(cv.x, pv.x), __fsub_rn(cv.y, pv.y),
                       __fsub_rn(cv.z, pv.z), __fsub_rn(cv.w, pv.w));
  }

  __device__ __forceinline__ float value(int r, bool sh, int col) const {
    const size_t e = static_cast<size_t>(r) * n + col;
    return __fsub_rn(sh ? lds(rows_sh + e) : __ldg(cost + e), price[col]);
  }

  // The top-2s of R rows, by one warp, in every lane, their loads and
  // merges interleaved: with `vec` lane l takes the float4 groups k0 + 4l +
  // 128v of each warp tile k0, else the columns lane, lane + 32, ...
  template <int R>
  __device__ __forceinline__ void rows_top2(const int (&r)[R], int lane,
                                            Top2 (&out)[R]) const {
    Top2 t[R];
    bool sh[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      t[i] = {-INFINITY, INT32_MAX, -INFINITY};
      sh[i] = r[i] < staged;
    }
    if (vec) {
      // the tile of k0 for every row; the first tile starts the top-2s, so
      // n <= kWarpTile (the main shape) takes no merge with the empty one
      auto tile = [&](int k0, bool first) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          Top2 m[kWarpVecs * 4];
#pragma unroll
          for (int v = 0; v < kWarpVecs; ++v) {
            const int col = k0 + 4 * lane + 128 * v;  // n % 4 == 0: all 4 live
            const float4 a = col < n ? values4(r[i], sh[i], col)
                                     : make_float4(-INFINITY, -INFINITY,
                                                   -INFINITY, -INFINITY);
            m[4 * v + 0] = {a.x, col, -INFINITY};
            m[4 * v + 1] = {a.y, col + 1, -INFINITY};
            m[4 * v + 2] = {a.z, col + 2, -INFINITY};
            m[4 * v + 3] = {a.w, col + 3, -INFINITY};
          }
          const Top2 u = merge_tree(m);
          t[i] = first ? u : bid::merge(t[i], u);
        }
      };
      tile(0, true);
#pragma unroll 1
      for (int k0 = kWarpTile; k0 < n; k0 += kWarpTile) tile(k0, false);
    } else {
#pragma unroll 2
      for (int j = lane; j < n; j += 32) {
#pragma unroll
        for (int i = 0; i < R; ++i) bid::push(t[i], value(r[i], sh[i], j), j);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = redux_merge(t[i]);
  }

  __device__ __forceinline__ Top2 row_top2(int r, int lane) const {
    const int rr[1] = {r};
    Top2 t[1];
    rows_top2<1>(rr, lane, t);
    return t[0];
  }
};

// The per-part top-2 of R listed rows against the tiles part, part + np,
// ... of kTileK columns, taken in column order, as push needs; lane 0
// writes them to the partials of batch rows r0 .. r0 + R - 1.  Only kNone
// can have more tiles than parts (n > kMaxParts * kTileK); the others leave
// the walk after one tile, known at compile time, so it costs them nothing.
template <Residency kRes, int R, class Src>
__device__ __forceinline__ void tile_top2(const int* rows, const Src& src,
                                          int n, int part, int np, int nt,
                                          int r0, int lane, float* part_v1,
                                          int* part_j1, float* part_v2) {
  Top2 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = {-INFINITY, INT32_MAX, -INFINITY};
#pragma unroll 1
  for (int tile = part;; tile += np) {
    const int k0 = tile * kTileK;
    float v[R][kCols];
    src.template tile_values<R>(rows, k0, lane, v);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
#pragma unroll
      for (int i = 0; i < R; ++i) bid::push(t[i], v[i][q], k0 + lane + 32 * q);
    }
    if (kRes != kNone || tile + np >= nt) break;
  }
  warp_merge_rows<R>(t);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = (r0 + i) * np + part;
      part_v1[e] = t[i].v1;
      part_j1[e] = t[i].j1;
      part_v2[e] = t[i].v2;
    }
  }
}

// Shared-memory bytes: the staged cost rows (dense, `stage_rows` rows of n
// floats, first, so they are 16-byte aligned for the TMA), or c
// feature-major with the column terms (d + 1 rows of c_stride(n) floats,
// first, likewise) and x if kShared; the per-row state (9 words) unless
// kNone; and `part_rows` rows of partial top-2s (3 words each, n_parts a
// row).
__host__ __device__ inline int c_stride(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int n_tiles(int n) { return (n + kTileK - 1) / kTileK; }
__host__ __device__ inline int n_parts(int n) { return min(n_tiles(n), kMaxParts); }
__host__ __device__ inline size_t base_bytes(int n, int d, Residency r) {
  return (r == kNone ? 0 : 36ull * n) +
         (r == kShared ? 4ull * (static_cast<size_t>(n) * d +
                                 static_cast<size_t>(d + 1) * c_stride(n))
                       : 0);
}
__host__ __device__ inline size_t part_bytes(int n, int rows) {
  return 12ull * n_parts(n) * rows;
}
__host__ __device__ inline size_t stage_bytes(int n, int rows) {
  return (4ull * n * rows + 15) & ~15ull;
}

// The most bidders a round may have to take the warp path.  There one warp
// reduces each bidder over all n columns, ceil(n / 32) x d fmaf a lane (d =
// kDenseColumnWork for a dense row); the CTA path spreads that over its
// warps for the price of three barriers.
__device__ __forceinline__ int warp_threshold(int n, int d) {
  const int lane_work = (n + 31) / 32 * d;  // fmaf a lane does per bidder
  return min(kMaxWarpBidders, kWarpWork / lane_work);
}

// One thread: `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory by TMA bulk copies of at most 64 KB, all
// completing on `bar` (phase 0), which this call initialises.
__device__ __forceinline__ void stage_bulk(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  const uint32_t b = bid::smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  const uint32_t d0 = bid::smem_u32(dst);
  const char* s0 = static_cast<const char*>(src);
  for (uint32_t off = 0; off < bytes; off += 65536u) {
    const uint32_t len = min(bytes - off, 65536u);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(d0 + off), "l"(s0 + off), "r"(len),
        "r"(b) : "memory");
  }
}

// kDense: x is the (G, n, n) cost stack, c and is_real are null, d is 0 and
// `vec` says whether its rows may be read as float4s; the first
// `stage_rows` rows of each group's cost are staged in shared memory once
// a launch.  Else x and c are (G, n, d) and stage_rows is 0.  `scratch`
// holds, unless kDense, c feature-major and the column terms for every
// group, (G, d + 1, c_stride(n)) (used unless kShared), then per group
// kStateWords * n words for the state (used if kNone); x is then read in
// place.  eps and skip are (P, G): the launch runs the P phases one after
// another, each from every row unassigned (the identity in a skipped
// group) and the prices of the phase before; the seed is the first
// phase's.  rounds_g (P, G) receives each phase's rounds.  `trace`
// (kTimed): (trace_cap, kTraceCols) int64, see record(), of group 0's
// rounds over the phases; `threshold` >= 0 replaces warp_threshold there.
template <Residency kRes, bool kTimed, bool kDense>
__global__ void __launch_bounds__(kThreads, 1)
auction_phase_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const uint8_t* __restrict__ is_real,
                     const float* __restrict__ prices_in,
                     const float* __restrict__ eps,
                     const uint8_t* __restrict__ skip,
                     const float* __restrict__ seed_v1,
                     const int64_t* __restrict__ seed_j1,
                     const float* __restrict__ seed_v2,
                     int64_t* __restrict__ assign_out,
                     float* __restrict__ prices_out, int64_t* rounds_g,
                     unsigned long long* counters, float* scratch, int G, int n,
                     int d, int P, int max_rounds, int fixed_rounds,
                     int part_rows, int stage_rows, long long* trace,
                     int trace_cap, int threshold, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next_total[2];
  __shared__ int handback[3];  // the warp path's it, total and parity
  __shared__ int staged_sh;    // kTimed: a CTA round's bidders on staged rows
  __shared__ Top2 dummy_sh;
  __shared__ __align__(8) uint64_t stage_bar;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t gn = static_cast<size_t>(g) * n;
  const float* xg = x + gn * (kDense ? n : d);  // the group's rows
  const float* cg = kDense ? nullptr : c + gn * d;
  const uint8_t* real_g = is_real ? is_real + gn : nullptr;
  const int ldc = c_stride(n);
  const int nt = n_tiles(n);
  const int np = n_parts(n);
  const size_t cd = kDense ? 0 : static_cast<size_t>(d + 1) * ldc;

  unsigned char* sp = smem;
  float* ct;
  const float* rows_sh = nullptr;  // kDense: the staged cost rows
  if constexpr (kDense) {
    static_assert(kRes != kShared, "a dense launch stages cost rows, not x");
    ct = nullptr;
    rows_sh = reinterpret_cast<const float*>(sp);
    sp += stage_bytes(n, stage_rows);
  } else if constexpr (kRes == kShared) {
    ct = reinterpret_cast<float*>(sp);
    sp += 4 * cd;
  } else {
    ct = scratch + g * cd;
  }
  unsigned long long* best;                          // object -> packed bid
  if constexpr (kRes == kNone) {
    best = reinterpret_cast<unsigned long long*>(scratch + G * cd +
                                                 gn * kStateWords);
  } else {
    best = reinterpret_cast<unsigned long long*>(sp);
    sp += 36 * static_cast<size_t>(n);
  }
  float* price = reinterpret_cast<float*>(best + n);
  int* owner = reinterpret_cast<int*>(price + n);    // object -> row, or -1
  int* assign = owner + n;                           // row -> object, or -1
  float* cn = reinterpret_cast<float*>(assign + n);  // ||c_j||^2
  float* term = kDense ? nullptr : ct + static_cast<size_t>(d) * ldc;  // ||c_j||^2 - p_j
  int* list_a = reinterpret_cast<int*>(cn + n);      // bidder slot -> row,
  int* list_b = list_a + n;                          // by round parity
  int* bid_obj = list_b + n;                         // slot -> object bid on
  const float* xs = xg;
  if constexpr (kRes == kShared) {
    xs = reinterpret_cast<float*>(sp);
    sp += 4 * static_cast<size_t>(n) * d;
  }
  // per (batch row, part): the part's top-2 of that row
  float* part_v1 = reinterpret_cast<float*>(sp);
  const int part_len = part_rows * np;
  int* part_j1 = reinterpret_cast<int*>(part_v1 + part_len);
  float* part_v2 = reinterpret_cast<float*>(part_j1 + part_len);

  // Once a launch: the cost rows to stage (the TMA where rows are 16-byte
  // aligned, else the threads), the prices, and the factored c.
  if constexpr (kDense) {
    if (stage_rows > 0) {
      if (vec) {
        if (tid == 0) {
          stage_bulk(const_cast<float*>(rows_sh), xg,
                     static_cast<uint32_t>(4ull * n * stage_rows), &stage_bar);
        }
      } else {
        float* w = const_cast<float*>(rows_sh);
        for (long long e = tid; e < static_cast<long long>(n) * stage_rows; e += kThreads) {
          w[e] = xg[e];
        }
      }
    }
  }
  const unsigned long long no_bid =
      static_cast<unsigned long long>(order_key(bid::kNeg)) << 32;
  bool dummy = false;
  for (int j = tid; j < n; j += kThreads) {
    best[j] = no_bid;
    price[j] = prices_in[gn + j];
    dummy |= real_g != nullptr && real_g[j] == 0;
  }
  if constexpr (kRes == kShared) {
    float* xw = const_cast<float*>(xs);
    for (long long e = tid; e < static_cast<long long>(n) * d; e += kThreads) xw[e] = xg[e];
  }
  if constexpr (!kDense) {
    for (int dd = warp; dd < d; dd += kWarps) {  // c feature-major, 0-padded
      for (int j = lane; j < ldc; j += 32) {
        ct[static_cast<size_t>(dd) * ldc + j] =
            j < n ? cg[static_cast<size_t>(j) * d + dd] : 0.f;
      }
    }
  }
  const bool has_dummy = __syncthreads_or(dummy);
  if constexpr (!kDense) {
    for (int j = tid; j < ldc; j += kThreads) {
      float s = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float v = ct[static_cast<size_t>(dd) * ldc + j];
        s = fmaf(v, v, s);
      }
      if (j < n) cn[j] = s;
      term[j] = j < n ? s - price[j] : -INFINITY;
    }
    __syncthreads();
  }
  if constexpr (kDense) {
    if (stage_rows > 0 && vec) bid::wait_phase(&stage_bar, 0);
  }
  // where the rows' values come from
  std::conditional_t<kDense, DenseRows, FactoredRows> src;
  if constexpr (kDense) {
    src = DenseRows{xg, rows_sh, price, n, stage_rows, vec};
  } else {
    src = FactoredRows{xs, ct, ldc, d, n};
  }

  // A team of `team` lanes (a power of two up to 32) merges a bidder's np
  // partials: the tree is shorter than one thread's chain where np > 2.
  const int team_log = np > 1 ? min(5, 32 - __clz(np - 1)) : 0;
  const int team = 1 << team_log;
  const int limit = fixed_rounds > 0 ? fixed_rounds : max_rounds;
  const int warp_max = kTimed && threshold >= 0
                           ? min(threshold, kMaxWarpBidders)
                           : kDense ? max(1, warp_threshold(n, kDenseColumnWork))
                                    : warp_threshold(n, d);
  long long bids = 0, single = 0;
  int traced = 0;  // kTimed: group 0's rounds of the phases before

#pragma unroll 1
  for (int ph = 0; ph < P; ++ph) {
    const bool skip_g = skip != nullptr && skip[static_cast<size_t>(ph) * G + g] != 0;
    const float eps_g = eps[static_cast<size_t>(ph) * G + g];
    for (int j = tid; j < n; j += kThreads) {
      owner[j] = skip_g ? j : -1;  // skip: rows start on the identity
      assign[j] = skip_g ? j : -1;
      list_a[j] = j;               // else every row bids in round one
    }
    __syncthreads();

    // The row in bidder slot s of `list` bids for its favourite object.
    auto place_bid = [&](const Top2& t, const int* list, int s) {
      const int j = t.j1;
      const float b = ((t.v1 + price[j]) - t.v2) + eps_g;
      bid_obj[s] = j;
      atomicMax(&best[j], pack_bid(b, list[s]));
    };

    // One call site for each kind of round keeps the kernel's code small: a
    // round that spans more code than the instruction cache holds stalls on
    // it.  Round one may come from the caller's reduction and always runs;
    // past convergence a round is a no-op, so `fixed_rounds` stops there
    // too.  it, total and parity are the same in every thread.
    int it = 0, parity = 0;
    int total = skip_g ? 0 : n;
#pragma unroll 1
    for (;;) {
      const bool seeded = ph == 0 && it == 0 && seed_v1 != nullptr;
      if (!seeded && (it >= limit || total == 0)) break;
      if (!seeded && total <= warp_max) {
        if (warp == 0) {
          // The warp path: every round here has 1 .. warp_max bidders, one
          // a lane; the count never rises, so this runs to the phase's end.
#pragma unroll 1
          while (total > 0 && total <= warp_max && it < limit) {
            long long t0 = 0, t1 = 0, t2 = 0;
            if (kTimed) t0 = clock64();
            int* list = parity ? list_b : list_a;
            int* next_list = parity ? list_a : list_b;
            unsigned long long key = 0;
            int obj = 0, row = -1, own = -1;
            float cn_obj = 0.f;
            bool have_dm = false;
            Top2 dm;
            // lane s keeps bidder s's bid; no update has run yet this round
            auto keep = [&](const Top2& t, int s, int r) {
              if (lane == s) {
                obj = t.j1;
                row = r;
                own = owner[obj];
                if constexpr (!kDense) cn_obj = cn[obj];
                key = pack_bid(((t.v1 + price[obj]) - t.v2) + eps_g, r);
              }
            };
            if constexpr (kDense) {
              // two bidders' rows at once, their loads and merges
              // interleaved; a lone one alone
#pragma unroll 1
              for (int s = 0; s < total; s += kRows) {
                if (total - s >= kRows) {
                  int r[kRows];
#pragma unroll
                  for (int i = 0; i < kRows; ++i) r[i] = list[s + i];
                  Top2 t[kRows];
                  src.template rows_top2<kRows>(r, lane, t);
#pragma unroll
                  for (int i = 0; i < kRows; ++i) keep(t[i], s + i, r[i]);
                } else {
                  const int r = list[s];
                  keep(src.row_top2(r, lane), s, r);
                }
              }
            } else {
#pragma unroll 1
              for (int s = 0; s < total; ++s) {
                const int r = list[s];
                Top2 t;
                if (has_dummy && real_g[r] == 0) {
                  if (!have_dm) dm = dummy_top2(price, n, lane);
                  have_dm = true;
                  t = dm;
                } else {
                  t = src.row_top2(r, lane);
                }
                keep(t, s, r);
              }
            }
            if (kTimed) t1 = clock64();
            // A lone bidder wins; more post their bids, the largest key wins.
            const bool contested = total > 1;
            if (contested) {
              if (row >= 0) atomicMax(&best[obj], key);
              __syncwarp();
            }
            if (kTimed) t2 = clock64();
            int next = -1;  // the row this bidder hands to the next round
            if (row >= 0) {
              if (!contested || best[obj] == key) {
                next = own;
                if (next >= 0) assign[next] = -1;
                assign[row] = obj;
                owner[obj] = row;
                const float p = key_value(static_cast<unsigned>(key >> 32));
                price[obj] = p;
                if constexpr (!kDense) term[obj] = cn_obj - p;
                if (contested) best[obj] = no_bid;
              } else {
                next = row;
              }
            }
            const unsigned listed = __ballot_sync(kFull, next >= 0);
            if (next >= 0) next_list[__popc(listed & ((1u << lane) - 1u))] = next;
            __syncwarp();
            if (kTimed && g == 0 && traced + it < trace_cap) {
              const int on_chip = kDense ? __popc(__ballot_sync(
                                               kFull, row >= 0 && row < stage_rows))
                                         : 0;
              if (lane == 0) record(trace, traced + it, total, 1, t0, t1 - t0, t2 - t1, on_chip);
            }
            bids += total;
            single += total == 1;
            total = __popc(listed);
            parity ^= 1;
            ++it;
          }
          if (lane == 0) {
            handback[0] = it;
            handback[1] = total;
            handback[2] = parity;
          }
        }
        __syncthreads();
        it = handback[0];
        total = handback[1];
        parity = handback[2];
        continue;
      }

      // The CTA path.
      long long t0 = 0, t1 = 0, reduce = 0, post = 0;
      if (kTimed) t0 = clock64();
      int* list = parity ? list_b : list_a;
      int* next_list = parity ? list_a : list_b;
      if (tid == 0) next_total[parity] = 0;
      if (kTimed && tid == 0) staged_sh = 0;
      if (seeded) {
#pragma unroll 1
        for (int s = tid; s < total; s += kThreads) {
          const size_t o = gn + list[s];
          place_bid({seed_v1[o], static_cast<int>(seed_j1[o]), seed_v2[o]}, list, s);
        }
        __syncthreads();
        if (kTimed) post = clock64() - t0;
      } else if constexpr (kDense) {
        // A warp a bidder: each warp reduces its bidders' whole rows as the
        // warp path does and its first lane posts their bids (the timed
        // split counts both as the top-2s).  Up to kWarps bidders take a
        // warp each; more go kRows to a warp, their loads and merges
        // interleaved, which takes less than kRows single rows.
        const int per = total <= kWarps ? 1 : kRows;
#pragma unroll 1
        for (int s0 = warp * per; s0 < total; s0 += kWarps * per) {
          if (per == kRows && total - s0 >= kRows) {
            int r[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) r[i] = list[s0 + i];
            Top2 t[kRows];
            src.template rows_top2<kRows>(r, lane, t);
            if (lane == 0) {
#pragma unroll
              for (int i = 0; i < kRows; ++i) place_bid(t[i], list, s0 + i);
            }
          } else {
            const Top2 t = src.row_top2(list[s0], lane);
            if (lane == 0) place_bid(t, list, s0);
          }
        }
        __syncthreads();
        if (kTimed) reduce = clock64() - t0;
      } else {
        if (has_dummy && warp == 0) {  // every dummy row sees -p
          const Top2 dm = dummy_top2(price, n, lane);
          if (lane == 0) dummy_sh = dm;
        }
#pragma unroll 1
        for (int b0 = 0; b0 < total; b0 += part_rows) {
          if (kTimed) t1 = clock64();
          const int rows = min(part_rows, total - b0);
          const int items = (rows + kRows - 1) / kRows * np;
#pragma unroll 1
          for (int item = warp; item < items; item += kWarps) {
            const int pair = item / np;
            const int part = item - pair * np;
            const int r0 = pair * kRows;
            const int* pr = list + b0 + r0;
            if (rows - r0 >= kRows) {
              tile_top2<kRes, kRows>(pr, src, n, part, np, nt, r0, lane,
                                     part_v1, part_j1, part_v2);
            } else {  // the batch's last row has no partner
              tile_top2<kRes, 1>(pr, src, n, part, np, nt, r0, lane, part_v1,
                                 part_j1, part_v2);
            }
          }
          __syncthreads();
          if (kTimed) {
            const long long now = clock64();
            reduce += now - (b0 == 0 ? t0 : t1);
            t1 = now;
          }
          // team merges: lane e of the batch's rows * team takes row
          // e / team, partials e % team, e % team + team, ...
          const int span = rows << team_log;
#pragma unroll 1
          for (int base = warp * 32; base < span; base += kThreads) {
            const int e = base + lane;
            const int r = e >> team_log;
            Top2 t = {-INFINITY, INT32_MAX, -INFINITY};
            if (e < span) {
#pragma unroll 1
              for (int q = e & (team - 1); q < np; q += team) {
                const int f = r * np + q;
                t = bid::merge(t, {part_v1[f], part_j1[f], part_v2[f]});
              }
            }
            t = xor_merge(t, team);
            if (e < span && (e & (team - 1)) == 0) {
              if (has_dummy && real_g[list[b0 + r]] == 0) t = dummy_sh;
              place_bid(t, list, b0 + r);
            }
          }
          __syncthreads();
          if (kTimed) post += clock64() - t1;
        }
      }
      // The update: each bidder learns whether it won; a winner moves its
      // object (and empties its slot), the outbid owner and the losers are
      // listed for the next round.
      int* count = &next_total[parity];
#pragma unroll 1
      for (int s = tid; s < total; s += kThreads) {
        const int row = list[s];
        const int j = bid_obj[s];
        const unsigned long long p = best[j];
        if (kTimed && kDense && !seeded && row < stage_rows) atomicAdd(&staged_sh, 1);
        if (static_cast<unsigned>(p) == ~static_cast<unsigned>(row)) {
          const int o = owner[j];
          if (o >= 0) {
            assign[o] = -1;
            next_list[atomicAdd(count, 1)] = o;
          }
          assign[row] = j;
          owner[j] = row;
          const float pj = key_value(static_cast<unsigned>(p >> 32));
          price[j] = pj;
          if constexpr (!kDense) term[j] = cn[j] - pj;
          best[j] = no_bid;
        } else {
          next_list[atomicAdd(count, 1)] = row;  // outbid
        }
      }
      __syncthreads();
      if (kTimed && g == 0 && tid == 0 && traced + it < trace_cap) {
        record(trace, traced + it, total, 0, t0, reduce, post, staged_sh);
      }
      bids += total;
      single += total == 1;
      total = *count;
      parity ^= 1;
      ++it;
    }
    traced += it;
    if (tid == 0) rounds_g[static_cast<size_t>(ph) * G + g] = fixed_rounds > 0 ? fixed_rounds : it;
  }

  for (int j = tid; j < n; j += kThreads) {
    assign_out[gn + j] = assign[j];
    prices_out[gn + j] = price[j];
  }
  if (tid == 0) {
    atomicAdd(&counters[1], static_cast<unsigned long long>(bids));
    atomicAdd(&counters[3], static_cast<unsigned long long>(single));
    __threadfence();
    if (atomicAdd(&counters[2], 1ull) == static_cast<unsigned long long>(G - 1)) {
      // the last CTA: the stack ran, phase by phase, its longest group's
      // rounds
      const volatile long long* rg = reinterpret_cast<volatile long long*>(rounds_g);
      unsigned long long sum = 0;
      for (int ph = 0; ph < P; ++ph) {
        long long most = 0;
        for (int h = 0; h < G; ++h) {
          const long long r = rg[static_cast<size_t>(ph) * G + h];
          most = r > most ? r : most;
        }
        sum += static_cast<unsigned long long>(most);
      }
      counters[0] += sum;
      counters[2] = 0;
    }
  }
}

// Launches P phases: the residency is the most that fits in shared memory
// beside two rows of partial top-2s (which always fit); the partials take
// what is left, up to n rows; a dense launch then stages as many of the
// group's cost rows as fit in the rest.  x / c / d as
// auction_phase_kernel takes them.
template <bool kTimed, bool kDense>
int launch(const float* x, const float* c, const uint8_t* is_real,
           const float* prices, const float* eps, const uint8_t* skip,
           const float* seed_v1, const int64_t* seed_j1, const float* seed_v2,
           int64_t* assign, float* prices_out, int64_t* rounds_g,
           int64_t* counters, float* scratch, int G, int n, int d, int P,
           int max_rounds, int fixed_rounds, long long* trace, int trace_cap,
           int threshold, void* stream) {
  if (G <= 0 || n <= 0) return 0;
  if ((!kDense && (d <= 0 || P != 1)) || P <= 0 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the dense CTA path reduces whole rows a warp: it keeps no partials
  const size_t min_parts = kDense ? 0 : part_bytes(n, kRows);
  Residency res = kDense ? kState : kShared;
  while (base_bytes(n, d, res) + min_parts > kSmemBudget) {
    res = static_cast<Residency>(res + 1);
  }
  const size_t base = base_bytes(n, d, res);
  size_t rows = 0;
  if (!kDense) {
    rows = (kSmemBudget - base) / part_bytes(n, 1);
    rows = rows < static_cast<size_t>(n) ? rows & ~static_cast<size_t>(kRows - 1) : n;
  }
  size_t bytes = base + part_bytes(n, static_cast<int>(rows));
  // float4 reads of a dense row: every row 16-byte aligned
  const bool vec = kDense && n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int stage = 0;
  if (kDense) {
    const size_t fit = (kSmemBudget - bytes) / (4ull * n);
    stage = fit < static_cast<size_t>(n) ? static_cast<int>(fit) : n;
    bytes += stage_bytes(n, stage);
  }
  auto* kernel = auction_phase_kernel<kNone, kTimed, kDense>;
  if constexpr (!kDense) {
    if (res == kShared) kernel = auction_phase_kernel<kShared, kTimed, kDense>;
  }
  if (res == kState) kernel = auction_phase_kernel<kState, kTimed, kDense>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kDense) {
    // the rows not staged are read through L1: ask for the least carve-out
    // that holds the shared memory above (static words and the block's
    // reserve included), so L1 keeps the rest of the SM's 256 KB, rather
    // than leave the split to the runtime's default
    const size_t max_shared = 233472;  // the SM's most shared memory, 228 KB
    const int carve = static_cast<int>(
        ((bytes + 2048) * 100 + max_shared - 1) / max_shared);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               carve < 100 ? carve : 100);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<G, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, c, is_real, prices, eps, skip, seed_v1, seed_j1, seed_v2, assign,
      prices_out, rounds_g, reinterpret_cast<unsigned long long*>(counters), scratch,
      G, n, d, P, max_rounds, fixed_rounds, static_cast<int>(rows), stage, trace,
      trace_cap, threshold, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phase
