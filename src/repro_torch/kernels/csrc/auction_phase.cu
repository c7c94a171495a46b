// One epsilon phase of the matrix-free Jacobi auction, for Hopper (sm_90a).
//
// Replaces the JAX `lax.while_loop` of `_auction_phase`
// (src/repro/core/assignment.py:115-213) run over the factored reduction of
// `auction_solve_factored`, and the port's Python counterpart of that loop
// (`_auction_phase` over `_factored_top2` in
// src/repro_torch/core/assignment.py), which launched `bid_top2` and about
// twenty small PyTorch kernels per bidding round.  It is not the port of a
// `pallas_call`: the TPU kernel `_bid_kernel` is ported as bid_top2.cu, and
// its arithmetic is shared here through bid_top2.cuh.
//
// Per group g of a (G, n, d) x (G, n, d) stack it runs one phase to its end:
// rows x_i bid for objects j at value
//
//     value[i, j] = -2 x_i . c_j + ||c_j||^2 - p_j      (real rows)
//     value[i, j] = -p_j                                (dummy rows)
//
// each unassigned row bids ((v1 + p[j1]) - v2) + eps on its best object j1,
// every object goes to its highest bid (the lowest row among equal bids),
// the previous owner is unassigned and the price rises to the winning bid;
// until no row is unassigned or `max_rounds` rounds have run (or exactly
// `fixed_rounds` rounds when that is > 0).  The results are bitwise those of
// the Python loop over the bid_top2 kernel: each value is the same sequential
// fmaf chain over d as bid_top2.cuh, ||c_j||^2 the same chain, the top-2 the
// same order-free merge (larger value, then lower column), the bid the same
// three float32 additions, and the per-object best bid and lowest winning
// row are exact.
//
// What bounds it on this card: operations, and at the main shape the
// latency of a round.  A round costs bidders x n x 2d FLOP (plus n x 2d for
// ||c||^2 once a phase); a main-shape LAP (n = 256, d = 22, ~6 000 bids)
// comes to tens of MFLOP, under a microsecond at the fp32 peak, but it runs
// ~1 200 rounds, most of them with one or a few bidders, each a chain of
// dependent shared-memory steps.  The Python loop paid ~20 launches of host
// time per round instead.  A LAP is sequential with the next (batch b + 1
// bids against the centroids batch b moved), so the design keeps one SM busy
// for a whole phase with no host round trip:
//   * grid = G CTAs of 512 threads, one per group; the CTA runs every round
//     of its phase and tests the stopping rule itself after each round.
//   * x, c (feature-major, so a lane's column reads are consecutive words)
//     and ||c||^2 are staged in shared memory once per phase, with the
//     prices, the assignment, each object's owner and best bid, and the
//     bidder lists of this round and the next (kShared).  Where x and c do
//     not fit beside that state they are read from device memory instead,
//     c through a feature-major copy the CTA writes once per phase (kState);
//     where the state itself does not fit (n above about 6 300) it lives in
//     the caller's scratch too, so only the partial top-2s stay in shared
//     memory (kNone).  All of it is read by one SM and stays in L2.
//   * A round: a warp item is two bidders against one tile of 64 columns
//     (or every kMaxParts-th tile, for n above 16 384), so even one bidder
//     spreads over n / 64 warps; each item leaves a top-2 per row and item
//     in shared memory (the two rows' warp merges
//     interleaved), and one thread per bidder merges its tiles, forms the
//     bid and posts it with one 64-bit atomicMax of (order-preserving bits
//     of the bid, ~row): the largest bid wins, the lowest row among equal
//     bids, exactly and in any order, so no result depends on scheduling.
//     Then one pass over the objects moves ownership and prices and lists
//     the outbid owners, and one over the bidders lists those that lost:
//     together the next round's bidders, in no particular order (no result
//     depends on it).  Three barriers a round, no host involvement.  The
//     round has one call site, which keeps the kernel small enough for the
//     instruction cache.
//   * Dummy rows all share the top-2 of -p; one warp computes it a round.
//   * The counters: per group the rounds run go to `rounds_g`; the bids are
//     added to counters[1], the rounds with a single bidder to counters[3],
//     and the last CTA to finish adds the largest group's rounds to
//     counters[0] (the round count of the Python loop over the whole
//     stack), so reading them needs no launch and no sync per phase.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bid_top2.cuh"

namespace {

using bid::Top2;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;            // bidder rows a warp reduces at once
constexpr int kCols = 2;            // columns a lane owns in a tile
constexpr int kTileK = 32 * kCols;  // columns per tile
constexpr int kMaxParts = 256;      // partial top-2s a row, at most
constexpr size_t kSmemBudget = 232448 - 1024;  // opt-in limit less static
constexpr int kStateWords = 10;     // scratch words a row for the state

// What lives in shared memory: the per-row state, x and c (kShared); the
// state only (kState); neither (kNone).  The partial top-2s always do.
enum Residency { kShared, kState, kNone };
// Where the state (36 bytes a row) fits, a row has no more tiles than parts.
static_assert(kSmemBudget / 36 <= static_cast<size_t>(kMaxParts) * kTileK,
              "kShared and kState take one tile a warp item");
constexpr unsigned kFull = 0xffffffffu;

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

// warp_merge of the first `live` rows (the same in every lane), level by
// level, so the rows' shuffles overlap.
__device__ __forceinline__ void warp_merge_rows(Top2 (&t)[kRows], int live) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < live) {
        Top2 o;
        o.v1 = __shfl_xor_sync(kFull, t[i].v1, off);
        o.j1 = __shfl_xor_sync(kFull, t[i].j1, off);
        o.v2 = __shfl_xor_sync(kFull, t[i].v2, off);
        t[i] = bid::merge(t[i], o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) t[i].v2 = fmaxf(t[i].v2, bid::kNeg);
}

// Shared-memory bytes: the per-row state (9 words) unless kNone, x and c if
// kShared, and `part_rows` rows of partial top-2s (3 words each, n_parts a
// row).
__host__ __device__ inline int c_stride(int n) { return n | 1; }
__host__ __device__ inline int n_tiles(int n) { return (n + kTileK - 1) / kTileK; }
__host__ __device__ inline int n_parts(int n) { return min(n_tiles(n), kMaxParts); }
__host__ __device__ inline size_t base_bytes(int n, int d, Residency r) {
  return (r == kNone ? 0 : 36ull * n) +
         (r == kShared ? 4ull * d * (static_cast<size_t>(n) + c_stride(n)) : 0);
}
__host__ __device__ inline size_t part_bytes(int n, int rows) {
  return 12ull * n_parts(n) * rows;
}

// `scratch` holds, per group, kStateWords * n words for the state (used if
// kNone), then per group c feature-major, (d, c_stride(n)) (used unless
// kShared); x is then read in place.
template <Residency kRes>
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
                     int d, int max_rounds, int fixed_rounds, int part_rows) {
  extern __shared__ unsigned long long smem8[];
  __shared__ int next_total[2];
  __shared__ Top2 dummy_top2;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t gn = static_cast<size_t>(g) * n;
  const float* xg = x + gn * d;
  const float* cg = c + gn * d;
  const uint8_t* real_g = is_real ? is_real + gn : nullptr;
  const int ldc = c_stride(n);
  const int nt = n_tiles(n);
  const int np = n_parts(n);

  unsigned long long* best =                         // object -> packed bid
      kRes == kNone
          ? reinterpret_cast<unsigned long long*>(scratch + gn * kStateWords)
          : smem8;
  float* price = reinterpret_cast<float*>(best + n);
  int* owner = reinterpret_cast<int*>(price + n);    // object -> row, or -1
  int* assign = owner + n;                           // row -> object, or -1
  float* cn = reinterpret_cast<float*>(assign + n);  // ||c_j||^2
  int* list = reinterpret_cast<int*>(cn + n);        // bidder slot -> row
  int* next_list = list + n;                         // the next round's
  int* bid_obj = next_list + n;                      // slot -> object bid on
  float* xs;
  float* ct;
  float* part_v1;
  if constexpr (kRes == kShared) {
    xs = reinterpret_cast<float*>(bid_obj + n);  // (n, d) row-major
    ct = xs + static_cast<size_t>(n) * d;     // (d, ldc) feature-major
    part_v1 = ct + static_cast<size_t>(d) * ldc;
  } else {
    xs = const_cast<float*>(xg);
    ct = scratch + static_cast<size_t>(G) * n * kStateWords +
         static_cast<size_t>(g) * d * ldc;
    part_v1 = kRes == kState ? reinterpret_cast<float*>(bid_obj + n)
                             : reinterpret_cast<float*>(smem8);
  }
  // per (batch row, part): the part's top-2 of that row
  const int part_len = part_rows * np;
  int* part_j1 = reinterpret_cast<int*>(part_v1 + part_len);
  float* part_v2 = reinterpret_cast<float*>(part_j1 + part_len);

  const bool skip_g = skip != nullptr && skip[g] != 0;
  const float eps_g = eps[g];
  const unsigned long long no_bid =
      static_cast<unsigned long long>(order_key(bid::kNeg)) << 32;
  bool dummy = false;
  for (int j = tid; j < n; j += kThreads) {
    price[j] = prices_in[gn + j];
    owner[j] = skip_g ? j : -1;  // skip: rows start on the identity
    assign[j] = skip_g ? j : -1;
    list[j] = j;                 // else every row bids in round one
    dummy |= real_g != nullptr && real_g[j] == 0;
  }
  const long long nd = static_cast<long long>(n) * d;
  if constexpr (kRes == kShared) {
    for (long long e = tid; e < nd; e += kThreads) xs[e] = xg[e];
  }
  for (long long e = tid; e < nd; e += kThreads) {
    const long long j = e / d;
    ct[(e - j * d) * ldc + j] = cg[e];
  }
  const bool has_dummy = __syncthreads_or(dummy);
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float v = ct[static_cast<size_t>(dd) * ldc + j];
      s = fmaf(v, v, s);
    }
    cn[j] = s;
  }
  __syncthreads();

  // The row in bidder slot s bids for its favourite object.
  auto place_bid = [&](const Top2& t, int s) {
    const int j = t.j1;
    const float b = ((t.v1 + price[j]) - t.v2) + eps_g;
    bid_obj[s] = j;
    atomicMax(&best[j], pack_bid(b, list[s]));
  };

  // The per-part top-2 of the listed rows [b0, b0 + rows): a warp item is
  // two rows against the tiles part, part + np, ... of kTileK columns,
  // taken in column order, as push needs.  Only kNone can have more tiles
  // than parts (n > kMaxParts * kTileK); the others leave the walk after
  // one tile, known at compile time, so it costs them nothing.
  auto reduce_tiles = [&](int b0, int rows) {
    const int items = (rows + kRows - 1) / kRows * np;
#pragma unroll 1
    for (int item = warp; item < items; item += kWarps) {
      const int pair = item / np;
      const int part = item - pair * np;
      const int r0 = pair * kRows;  // batch row of the pair's first row
      int row[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) row[i] = list[b0 + min(r0 + i, rows - 1)];
      Top2 t[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) t[i] = {-INFINITY, INT32_MAX, -INFINITY};
      const float* xr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) xr[i] = xs + static_cast<size_t>(row[i]) * d;
#pragma unroll 1
      for (int tile = part;; tile += np) {
        const int k0 = tile * kTileK;
        float acc[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
        const float* cc = ct + k0 + lane;
        const int cols_left = n - k0 - lane;  // column q is live if 32q < this
#pragma unroll 4
        for (int dd = 0; dd < d; ++dd) {
          float xv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) xv[i] = xr[i][dd];
          const float* cr = cc + static_cast<size_t>(dd) * ldc;
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const float cv = 32 * q < cols_left ? cr[32 * q] : 0.f;
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc[i][q] = fmaf(xv[i], cv, acc[i][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int col = k0 + lane + 32 * q;
          if (col < n) {
            const float b = cn[col] - price[col];
#pragma unroll
            for (int i = 0; i < kRows; ++i) bid::push(t[i], -2.f * acc[i][q] + b, col);
          }
        }
        if (kRes != kNone || tile + np >= nt) break;
      }
      warp_merge_rows(t, min(kRows, rows - r0));
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (lane == 0 && r0 + i < rows) {
          const int e = (r0 + i) * np + part;
          part_v1[e] = t[i].v1;
          part_j1[e] = t[i].j1;
          part_v2[e] = t[i].v2;
        }
      }
    }
  };

  // One bidding round over the `total` listed rows.  The rows unassigned
  // after it are the bidders that lost and the owners that were outbid, so
  // the update lists them for the next round; returns how many there are.
  int parity = 0;
  auto bid_round = [&](int total, bool use_seed) -> int {
    for (int j = tid; j < n; j += kThreads) best[j] = no_bid;
    if (tid == 0) next_total[parity] = 0;
    if (use_seed) {
      __syncthreads();
#pragma unroll 1
      for (int s = tid; s < total; s += kThreads) {
        const size_t o = gn + list[s];
        place_bid({seed_v1[o], static_cast<int>(seed_j1[o]), seed_v2[o]}, s);
      }
      __syncthreads();
    } else {
      if (has_dummy && warp == 0) {  // every dummy row sees -p
        Top2 dm = {-INFINITY, INT32_MAX, -INFINITY};
#pragma unroll 1
        for (int j = lane; j < n; j += 32) bid::push(dm, -price[j], j);
        dm = warp_merge(dm);
        if (lane == 0) dummy_top2 = dm;
      }
#pragma unroll 1
      for (int b0 = 0; b0 < total; b0 += part_rows) {
        const int rows = min(part_rows, total - b0);
        reduce_tiles(b0, rows);
        __syncthreads();
#pragma unroll 1
        for (int r = tid; r < rows; r += kThreads) {
          Top2 t;
          if (has_dummy && real_g[list[b0 + r]] == 0) {
            t = dummy_top2;
          } else {
            const int e = r * np;
            t = {part_v1[e], part_j1[e], part_v2[e]};
#pragma unroll 1
            for (int q = 1; q < np; ++q)
              t = bid::merge(t, {part_v1[e + q], part_j1[e + q], part_v2[e + q]});
          }
          place_bid(t, b0 + r);
        }
        __syncthreads();
      }
    }
    int* count = &next_total[parity];
#pragma unroll 1
    for (int j = tid; j < n; j += kThreads) {
      const unsigned long long p = best[j];
      const unsigned low = static_cast<unsigned>(p);
      if (low != 0u) {  // the object changes hands at the winning bid
        const int w = static_cast<int>(~low);
        const int o = owner[j];
        if (o >= 0) {
          assign[o] = -1;
          next_list[atomicAdd(count, 1)] = o;
        }
        assign[w] = j;
        owner[j] = w;
        price[j] = key_value(static_cast<unsigned>(p >> 32));
      }
    }
#pragma unroll 1
    for (int s = tid; s < total; s += kThreads) {
      if (static_cast<unsigned>(best[bid_obj[s]]) != ~static_cast<unsigned>(list[s])) {
        next_list[atomicAdd(count, 1)] = list[s];  // outbid
      }
    }
    __syncthreads();
    int* const t = list;
    list = next_list;
    next_list = t;
    parity ^= 1;
    return *count;
  };

  // One call site for the round keeps the kernel's code small: a round
  // that spans more code than the instruction cache holds stalls on it.
  // Round one may come from the caller's reduction and always runs; past
  // convergence a round is a no-op, so `fixed_rounds` stops there too.
  int it = 0;
  long long bids = 0, single = 0;
  int total = skip_g ? 0 : n;
  const int limit = fixed_rounds > 0 ? fixed_rounds : max_rounds;
#pragma unroll 1
  for (;; ++it) {
    const bool seeded = it == 0 && seed_v1 != nullptr;
    if (!seeded && (it >= limit || total == 0)) break;
    bids += total;
    single += total == 1;
    total = bid_round(total, seeded);
  }
  if (fixed_rounds > 0) it = fixed_rounds;

  for (int j = tid; j < n; j += kThreads) {
    assign_out[gn + j] = assign[j];
    prices_out[gn + j] = price[j];
  }
  if (tid == 0) {
    rounds_g[g] = it;
    atomicAdd(&counters[1], static_cast<unsigned long long>(bids));
    atomicAdd(&counters[3], static_cast<unsigned long long>(single));
    __threadfence();
    if (atomicAdd(&counters[2], 1ull) == static_cast<unsigned long long>(G - 1)) {
      long long most = 0;  // the last CTA: the stack ran its longest group's rounds
      for (int h = 0; h < G; ++h) {
        const long long r = reinterpret_cast<volatile long long*>(rounds_g)[h];
        most = r > most ? r : most;
      }
      counters[0] += static_cast<unsigned long long>(most);
      counters[2] = 0;
    }
  }
}

}  // namespace

// x, c (G, n, d), prices (G, n), eps (G,) float32; is_real (G, n) and skip
// (G,) bytes, or null; seed_v1 / seed_j1 / seed_v2 (G, n) float32 / int64 /
// float32, or all null; assign (G, n) int64 and prices_out (G, n) float32
// are written; rounds_g (G,) int64 is scratch; counters int64 [rounds, bids,
// ticket, single-bidder rounds] accumulate; scratch float32 of at least
// G * (10 n + d * (n | 1)) words, of which the launch uses what does not fit
// in shared memory.  All contiguous, on the current device.  Launches on
// `stream` and returns a cudaError_t.
extern "C" int auction_phase_f32(const float* x, const float* c,
                                 const uint8_t* is_real, const float* prices,
                                 const float* eps, const uint8_t* skip,
                                 const float* seed_v1, const int64_t* seed_j1,
                                 const float* seed_v2, int64_t* assign,
                                 float* prices_out, int64_t* rounds_g,
                                 int64_t* counters, float* scratch, int G, int n,
                                 int d, int max_rounds, int fixed_rounds,
                                 void* stream) {
  if (G <= 0 || n <= 0) return 0;
  if (d <= 0 || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // keep as much as fits in shared memory beside two rows of partial top-2s
  // (which always fit); the partials take what is left, up to n rows
  Residency res = kShared;
  while (base_bytes(n, d, res) + part_bytes(n, kRows) > kSmemBudget) {
    res = static_cast<Residency>(res + 1);
  }
  const size_t base = base_bytes(n, d, res);
  size_t rows = (kSmemBudget - base) / part_bytes(n, 1);
  rows = rows < static_cast<size_t>(n) ? rows & ~static_cast<size_t>(kRows - 1) : n;
  const size_t bytes = base + part_bytes(n, static_cast<int>(rows));
  auto* kernel = res == kShared  ? auction_phase_kernel<kShared>
                 : res == kState ? auction_phase_kernel<kState>
                                 : auction_phase_kernel<kNone>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<G, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, c, is_real, prices, eps, skip, seed_v1, seed_j1, seed_v2, assign,
      prices_out, rounds_g, reinterpret_cast<unsigned long long*>(counters), scratch,
      G, n, d, max_rounds, fixed_rounds, static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}
