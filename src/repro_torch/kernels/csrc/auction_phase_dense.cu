// The epsilon phases of one dense-cost Jacobi auction LAP, for Hopper
// (sm_90a): the "auction" solver's whole schedule in one launch, which the
// default spec's flat route (`anticluster(x, k)` with no `chunk_size`) and
// the stacked route run once a LAP.  Values are cost[g, i, j] - p_j, read
// from the (G, n, n) cost stack that `_assign_batch` builds (dummy rows
// zeroed), as many of its rows as fit staged in shared memory.
//
// Replaces the JAX `lax.while_loop` of `_auction_phase`
// (src/repro/core/assignment.py:115-213) over `_top2_batched`
// (`:106-112`), reached from `auction_solve`, and the port's Python round
// loop `kernels.ref.auction_rounds` over `kernels.ref.top2`, some twenty
// launches a round.  The kernel, what bounds it and its design are in
// auction_phase.cuh, shared with auction_phase.cu (the factored phase, one
// launch a phase): the two differ in where a row's values come from and in
// how many phases a launch runs.

#include "auction_phase.cuh"

// cost (G, n, n), prices (G, n) float32, the first phase's prices; eps
// (P, G) float32, the schedule; skip (P, G) bytes, or null; seed_v1 /
// seed_j1 / seed_v2 (G, n) float32 / int64 / float32, the first phase's
// first reduction, or all null; assign (G, n) int64 and prices_out (G, n)
// float32 are written, the last phase's; rounds_g (P, G) int64 is scratch;
// counters int64 [rounds, bids, ticket, single-bidder rounds] accumulate;
// scratch float32 of at least G * 10 n words, used where the per-row state
// does not fit in shared memory.  All contiguous, on the current device.
// Runs the P phases one after another in one launch on `stream` and
// returns a cudaError_t.
extern "C" int auction_phase_dense_f32(
    const float* cost, const float* prices, const float* eps,
    const uint8_t* skip, const float* seed_v1, const int64_t* seed_j1,
    const float* seed_v2, int64_t* assign, float* prices_out, int64_t* rounds_g,
    int64_t* counters, float* scratch, int G, int n, int P, int max_rounds,
    int fixed_rounds, void* stream) {
  return phase::launch<false, true>(
      cost, nullptr, nullptr, prices, eps, skip, seed_v1, seed_j1, seed_v2,
      assign, prices_out, rounds_g, counters, scratch, G, n, 0, P, max_rounds,
      fixed_rounds, nullptr, 0, -1, stream);
}

// The same phases with group 0's rounds timed, for measurement only: trace,
// trace_cap and threshold as auction_phase_timed_f32 takes them
// (auction_phase.cu), the trace's rows running on over the phases, its
// last column the round's bidders whose cost rows were staged in shared
// memory.
extern "C" int auction_phase_dense_timed_f32(
    const float* cost, const float* prices, const float* eps,
    const uint8_t* skip, const float* seed_v1, const int64_t* seed_j1,
    const float* seed_v2, int64_t* assign, float* prices_out, int64_t* rounds_g,
    int64_t* counters, float* scratch, int G, int n, int P, int max_rounds,
    int fixed_rounds, int64_t* trace, int trace_cap, int threshold,
    void* stream) {
  return phase::launch<true, true>(
      cost, nullptr, nullptr, prices, eps, skip, seed_v1, seed_j1, seed_v2,
      assign, prices_out, rounds_g, counters, scratch, G, n, 0, P, max_rounds,
      fixed_rounds, reinterpret_cast<long long*>(trace), trace_cap, threshold,
      stream);
}
