// One epsilon phase of the factored (matrix-free) Jacobi auction, for
// Hopper (sm_90a): the "auction_fused" solver's phase, one launch each,
// which the stream route of `anticluster(x, k, chunk_size="auto")` runs at
// scale.  Values are -2 x_i . c_j + ||c_j||^2 - p_j, formed from the rows
// and centroids.
//
// Replaces the JAX `lax.while_loop` of `_auction_phase`
// (src/repro/core/assignment.py:115-213) over the factored reduction of
// `auction_solve_factored`.  The kernel, what bounds it and its design are
// in auction_phase.cuh, shared with auction_phase_dense.cu (the default
// route's dense phase).

#include "auction_phase.cuh"

// x, c (G, n, d), prices (G, n), eps (G,) float32; is_real (G, n) and skip
// (G,) bytes, or null; seed_v1 / seed_j1 / seed_v2 (G, n) float32 / int64 /
// float32, or all null; assign (G, n) int64 and prices_out (G, n) float32
// are written; rounds_g (G,) int64 is scratch; counters int64 [rounds, bids,
// ticket, single-bidder rounds] accumulate; scratch float32 of at least
// G * (10 n + (d + 1) * ((n + 3) & ~3)) words, of which the launch uses what
// does not fit in shared memory.  All contiguous, on the current device.
// Launches on `stream` and returns a cudaError_t.
extern "C" int auction_phase_f32(const float* x, const float* c,
                                 const uint8_t* is_real, const float* prices,
                                 const float* eps, const uint8_t* skip,
                                 const float* seed_v1, const int64_t* seed_j1,
                                 const float* seed_v2, int64_t* assign,
                                 float* prices_out, int64_t* rounds_g,
                                 int64_t* counters, float* scratch, int G, int n,
                                 int d, int max_rounds, int fixed_rounds,
                                 void* stream) {
  return phase::launch<false, false>(
      x, c, is_real, prices, eps, skip, seed_v1, seed_j1, seed_v2, assign,
      prices_out, rounds_g, counters, scratch, G, n, d, 1, max_rounds,
      fixed_rounds, nullptr, 0, -1, stream);
}

// The same phase, with group 0's rounds timed for measurement: trace
// (trace_cap, 7) int64 receives (bidders, clock64 cycles, 1 if the round ran
// in the one-warp path else 0, the cycles of its top-2s, of posting its
// bids, of its update, 0) of round r in row r, for r < trace_cap; threshold >= 0
// sets the most bidders a round may have to run in the warp path (up to 32),
// -1 keeps the kernel's rule.
extern "C" int auction_phase_timed_f32(
    const float* x, const float* c, const uint8_t* is_real, const float* prices,
    const float* eps, const uint8_t* skip, const float* seed_v1,
    const int64_t* seed_j1, const float* seed_v2, int64_t* assign,
    float* prices_out, int64_t* rounds_g, int64_t* counters, float* scratch,
    int G, int n, int d, int max_rounds, int fixed_rounds, int64_t* trace,
    int trace_cap, int threshold, void* stream) {
  return phase::launch<true, false>(
      x, c, is_real, prices, eps, skip, seed_v1, seed_j1, seed_v2, assign,
      prices_out, rounds_g, counters, scratch, G, n, d, 1, max_rounds,
      fixed_rounds, reinterpret_cast<long long*>(trace), trace_cap, threshold,
      stream);
}
