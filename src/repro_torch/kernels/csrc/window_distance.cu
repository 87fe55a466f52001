// Window pass of the interleaved stack-distance engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.window_distance` of the JAX
// package: `window_grid` (pallas_call at window_distance.py:325) and
// `window_cell` (pallas_call at :438), whose shared loop body is
// `_window_loop` (:164).  One CTA runs one cell of the
// {quantum x fleet x slots x latency} grid from its first scheduler window
// to `total_steps` committed accesses.  Each trip commits one window of the
// scheduled program p = schedule[sched_idx]: read W tags and costs at
// (cursor[p] + i) % trace_len, take every access's LRU stack distance in
// the merged stream, classify cold/miss, cumsum the cycle costs from the
// open quantum, cut at the first quantum expiry, and fold the committed
// prefix into the carried per-tag last-occurrence vector.  All arithmetic
// is int32, equal bit for bit to the plain PyTorch body beside the wrapper
// (repro_torch/kernels/window_distance.py).
//
// What bounds it on this card: neither bytes nor operations.  The fig7
// grid reads ~0.4 GB of tag/cost stream (mostly from L2) and does a few x
// num_tags int32 operations per access, a throughput bound of ~0.08 ms;
// the kernel is instead the latency of a sequential chain per cell: a
// trip's rows are walked in passes of a few hundred rows, each pass
// depending on the last one's cut, and the slowest cell of the fig7 grid
// takes ~1,000 passes.  The time is (passes of the slowest cell) x
// (latency of one pass), so the design shortens the pass.
//
// Two routes, chosen in the C entry point from the shapes alone and
// written back through `route`:
//
// * "bitset" (num_tags <= 32 and num_progs <= 32: every tag alphabet of
//   the simulator, whose ISA has 30 instructions) keeps a set of tags in
//   one 32-bit word, so a stack distance is one popcount.  A pass is
//   kBitsetWarps warps of 32 rows (256 rows).  In each warp sub-chunk
//   `__match_any_sync` gives a row the rows of its tag; its previous
//   in-warp occurrence is the highest of them below it, and the distinct
//   tags since then are the live rows after it (a row is live while it is
//   the last occurrence of its tag: an exclusive OR-scan of 1 << prev
//   kills the rest).  A row whose tag last occurred before its warp takes
//   the popcount of one word: the tags newer than that occurrence (the
//   carried newer-than set N_t = {u : last_pos[u] > last_pos[t]}, or,
//   where an earlier warp of the pass holds t, that warp's tags after
//   its last t) ORed with the tag sets of the warps in between and the
//   tags of the rows before it in its warp.  Costs are summed by warp
//   shuffles and one exchange of warp totals; a warp's first expiry is a
//   ballot and __ffs, the cut the first warp holding one.  The commit is
//   owned by one row per tag, its final committed occurrence, which
//   writes last_pos (and last_miss) and the tag's new newer-than set; the
//   pass's committed tags are ORed into the newer-than set of every tag
//   it did not touch.  Counters are popcounts of ballots.  Three block
//   barriers a pass (tag sets published; warp totals published; cut and
//   commit inputs published), against ~11 of the generic route, and the
//   trip's bookkeeping folds into the pass that ends it, computed alike
//   by every thread.  The streams are staged: each program's next
//   accesses sit in a shared-memory ring of `ring_rows(W)` rows (tags and
//   costs, int32) that holds at least two windows ahead of its cursor,
//   refilled with 4-byte cp.async copies of the rows a trip consumed,
//   issued at the trip's end and waited on two passes later; the wrap at
//   trace_len is taken at copy time.  No L2 round trip and no 64-bit
//   modulo sit on the chain.  The ring is what bounds the route's shapes:
//   8 x P x ring_rows(W) bytes of shared memory (P 4, W 2,048: 128 KB).
// * "generic" (larger alphabets or fleets) is the first design, kept as
//   it was: the per-tag vectors in shared memory, a window walked in
//   chunks of kThreads rows, each tag's occurrences a row bitmask per
//   chunk, an access's previous occurrence one find-last-set and its
//   stack distance a loop over tags that stops at the slot count, the
//   scan, min and sums as block-wide reductions.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -maxrregcount=128; the plain C entry point is
//        bound with ctypes.  Without an explicit -maxrregcount, ptxas
//        (CUDA 12.9) fails to allocate the bitset kernel ("register count
//        of '7'"), whatever its launch bounds or __maxnreg__ say; under a
//        cap of 128 it takes 80 registers (79 materialising), which keeps
//        three bitset CTAs on an SM: all 312 fig7 cells resident on 132
//        SMs.  Caps of 72 and 80 failed to allocate an earlier form with
//        more live registers; the generic kernel uses 64.
// nvcc-flags: -maxrregcount=128

#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;            // rows per chunk, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kThreads / 32;    // row-bitmask words per tag
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int* tags;         // (B, P, N) pre-gathered slot tags, -1 unslotted
  const int* costs;        // (B, P, N) hardware cycles
  const int* slot_counts;  // (K,)
  const int* lats;         // (L,)
  const int* quanta;       // (Q, P)
  const int* schedule;     // (S,)
  const int* seed_last;    // (T,) engine-coordinate seed, or null
  const int* seed_vec;     // (5, P) cursors/cycles/instrs/misses/bs, or null
  const int* seed_sca;     // (3,) sched_idx/q_cycles/switches, or null
  int* out_vec;            // (C, 5, P) cursors/cycles/instrs/misses/bs
  int* out_sca;            // (C, 4) sched_idx/steps_done/q_cycles/switches
  int* out_last;           // (C, T) or null
  int* out_miss;           // (C, T) or null
  int B, P, N, Q, K, L, S, T;
  int handler, bs_extra, total_steps, window, pos_base;
  int* out_stats;          // (C, 2) trips/passes, or null (bitset route)
  int ring;                // rows of a program's stream ring (bitset route)
};

// Highest set bit of the row mask strictly below row j, or -1.
__device__ __forceinline__ int last_bit_below(const unsigned* m, int j) {
  int w = j >> 5;
  unsigned bits = m[w] & ((1u << (j & 31)) - 1u);
  while (true) {
    if (bits) return (w << 5) + 31 - __clz(bits);
    if (--w < 0) return -1;
    bits = m[w];
  }
}

// Any set bit of the row mask in rows [lo, hi).
__device__ __forceinline__ bool any_bits(const unsigned* m, int lo, int hi) {
  if (lo >= hi) return false;
  const int wl = lo >> 5, wh = (hi - 1) >> 5;
  for (int w = wl; w <= wh; ++w) {
    unsigned bits = m[w];
    if (w == wl) bits &= kFull << (lo & 31);
    if (w == wh) {
      const int e = (hi - 1) & 31;
      bits &= (e == 31) ? kFull : ((1u << (e + 1)) - 1u);
    }
    if (bits) return true;
  }
  return false;
}

// Block-wide inclusive sum scan; `red` holds kWarps ints.  Ends with a
// barrier so `red` can be reused at once.
__device__ __forceinline__ int block_incl_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) red[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += red[warp - 1];
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

template <bool kMaterialise>
__global__ void __launch_bounds__(kThreads) window_kernel(Params prm) {
  extern __shared__ int smem[];
  const int T = prm.T, P = prm.P, N = prm.N;
  int* cur = smem;                                // (T,) last position
  int* curmiss = cur + T;                         // (T,) last slot miss
  unsigned* occ = reinterpret_cast<unsigned*>(curmiss + T);  // (T, kWords)
  int* pv = reinterpret_cast<int*>(occ + T * kWords);        // (5, P)
  __shared__ int red[kWarps];
  __shared__ int sca[4];     // sched_idx, steps_done, q_cycles, switches
  __shared__ int end_cum;

  const int cell = blockIdx.x;
  const int l = cell % prm.L;
  const int k = (cell / prm.L) % prm.K;
  const int b = (cell / (prm.L * prm.K)) % prm.B;
  const int q = cell / (prm.L * prm.K * prm.B);
  const int tid = threadIdx.x;
  const int num_active = prm.slot_counts[k];
  const int lat = prm.lats[l];
  const int* quanta = prm.quanta + q * P;
  const int* tags = prm.tags + static_cast<size_t>(b) * P * N;
  const int* costs = prm.costs + static_cast<size_t>(b) * P * N;

  for (int u = tid; u < T; u += kThreads) {
    cur[u] = prm.seed_last ? prm.seed_last[u] : -1;
    curmiss[u] = -1;
  }
  for (int i = tid; i < 5 * P; i += kThreads)
    pv[i] = prm.seed_vec ? prm.seed_vec[i] : 0;
  if (tid == 0) {
    sca[0] = prm.seed_sca ? prm.seed_sca[0] : 0;
    sca[1] = 0;
    sca[2] = prm.seed_sca ? prm.seed_sca[1] : 0;
    sca[3] = prm.seed_sca ? prm.seed_sca[2] : 0;
  }
  __syncthreads();

  while (true) {
    const int steps_done = sca[1];
    if (steps_done >= prm.total_steps) break;
    const int sched_idx = sca[0];
    const int q_cycles = sca[2];
    const int p = prm.schedule[sched_idx];
    const int quantum = quanta[p];
    int start = pv[p] % N;                       // pv[0 * P + p]: cursor
    if (start < 0) start += N;
    // rows past the run's end never commit and cannot move the ones
    // before them, so the window is cut to what remains
    const int limit = min(prm.window, prm.total_steps - steps_done);
    const int* ptag = tags + static_cast<size_t>(p) * N;
    const int* pcost = costs + static_cast<size_t>(p) * N;
    int running = q_cycles;
    int committed = 0, n_miss = 0, n_cold = 0;
    bool do_switch = false;
    for (int base = 0; base < limit; base += kThreads) {
      const int rows = min(kThreads, limit - base);
      const int j = tid;
      const bool valid = j < rows;
      int t = -1, h = 0;
      if (valid) {
        const int idx = static_cast<int>(
            (static_cast<long long>(start) + base + j) % N);
        t = ptag[idx];
        h = pcost[idx];
      }
      const int pos0 = prm.pos_base + steps_done + base;
      for (int i = tid; i < T * kWords; i += kThreads) occ[i] = 0u;
      __syncthreads();
      if (t >= 0) atomicOr(&occ[t * kWords + (j >> 5)], 1u << (j & 31));
      __syncthreads();

      bool cold = false, miss = false;
      if (t >= 0) {
        const int kself = last_bit_below(occ + t * kWords, j);
        const int prev_self = kself >= 0 ? pos0 + kself : cur[t];
        cold = prev_self < 0;
        if (cold) {
          miss = true;
        } else {
          // distinct tags touched after the previous occurrence: tags seen
          // in-chunk after it, plus (when it lies before the chunk) tags
          // whose carried position is newer
          const int lo = kself + 1;
          int dist = 0;
          for (int u = 0; u < T && dist < num_active; ++u)
            dist += any_bits(occ + u * kWords, lo, j) ||
                    (kself < 0 && cur[u] > prev_self);
          miss = dist >= num_active;
        }
      }
      const int cost = valid ? h + (miss ? lat : 0) + (cold ? prm.bs_extra : 0)
                             : 0;
      const int cum = running + block_incl_scan(cost, red);
      const bool expire = valid && cum >= quantum;
      const int first = block_min(expire ? j : kThreads, red);
      const int cut = first < kThreads ? first + 1 : rows;
      const bool in_run = j < cut;
      // every read of `cur` above precedes block_min's barrier
      if (in_run && t >= 0) {
        atomicMax(&cur[t], pos0 + j);
        if (kMaterialise && miss) atomicMax(&curmiss[t], pos0 + j);
      }
      if (j == cut - 1) end_cum = cum;
      n_miss += block_sum(in_run && miss, red);
      n_cold += block_sum(in_run && cold, red);
      committed += cut;
      running = end_cum;
      if (first < kThreads) {
        do_switch = true;
        break;
      }
    }
    __syncthreads();
    if (tid == 0) {
      pv[0 * P + p] += committed;
      pv[1 * P + p] += running - q_cycles + (do_switch ? prm.handler : 0);
      pv[2 * P + p] += committed;
      pv[3 * P + p] += n_miss;
      pv[4 * P + p] += n_cold;
      sca[0] = do_switch ? (sched_idx + 1) % prm.S : sched_idx;
      sca[1] = steps_done + committed;
      sca[2] = do_switch ? 0 : running;
      sca[3] += do_switch ? 1 : 0;
    }
    __syncthreads();
  }

  for (int i = tid; i < 5 * P; i += kThreads)
    prm.out_vec[static_cast<size_t>(cell) * 5 * P + i] = pv[i];
  if (tid < 4) prm.out_sca[cell * 4 + tid] = sca[tid];
  if (prm.out_last) {
    for (int u = tid; u < T; u += kThreads) {
      prm.out_last[static_cast<size_t>(cell) * T + u] = cur[u];
      prm.out_miss[static_cast<size_t>(cell) * T + u] = curmiss[u];
    }
  }
}

// ---------------------------------------------------------------------------
// the bitset route (num_tags <= 32, num_progs <= 32)
// ---------------------------------------------------------------------------

constexpr int kBitsetWarps = 8;                  // warps of a pass
constexpr int kPassRows = 32 * kBitsetWarps;     // rows of a pass
constexpr int kMaxTags = 32;                     // tags of a word
constexpr int kMaxProgs = 32;                    // a warp's lanes hold them

// Rows of a program's stream ring.  A trip reads at most W rows from the
// cursor; the refill of the n <= W rows it consumed is waited on two
// passes later, so the next trip's W rows, or the next trip's single pass
// and the first pass of the one after it (min(R, W) rows each), must fit
// in the rows beside it.
__host__ __device__ constexpr long long ring_rows(long long window) {
  return window + (window > 2 * (window < kPassRows ? window : kPassRows)
                       ? window
                       : 2 * (window < kPassRows ? window : kPassRows));
}

// 4 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// What the warps publish to each other within a pass, and the per-tag
// carry.  Each array is written in one phase and read only in the next,
// so three barriers a pass order every access.  The per-warp arrays have
// 32 entries, those past the last warp neutral, so that lane x of every
// warp reads warp x's entry without a lane test.
struct BitsetShared {
  int last_pos[kMaxTags];
  int last_miss[kMaxTags];
  unsigned newer[kMaxTags];                 // N_t: tags newer than t
  unsigned wset[kBitsetWarps];              // phase 1: a warp's tag set
  unsigned after[kBitsetWarps][kMaxTags];   // phase 1: tags after a tag's
                                            // last occurrence in the warp
  unsigned tot[32];                         // phase 2: a warp's cost sum
  int info[32];                             // phase 3: first expiry | its
                                            // misses << 8 | colds << 16
  int end_cum[32];                          // phase 3: cost sum there
  unsigned rset[32];                        // phase 3: tags up to it
  unsigned rmiss[32];                       // phase 3: missed tags up to it
  int trips, passes;                        // the cell's counts (stats)
  // the cell's constants and its switch count, read where used: kept
  // here, not in registers held across the pass loop
  int num_active, switches;
  unsigned lat;
  size_t stream;                            // the fleet's offset in tags
};

// The trace index of program p's cursor: its seed (row 0 of seed_vec)
// modulo N, taken non-negative.
__device__ __forceinline__ int cursor_index(const int* seed_vec, int p,
                                            int N) {
  const int start = (seed_vec ? seed_vec[p] : 0) % N;
  return start < 0 ? start + N : start;
}

// Inclusive OR-scans over the lanes below (up) or above (down) this one.
// A shuffle from past the warp's edge returns the lane's own value, which
// an OR absorbs: the scans need no lane tests.
__device__ __forceinline__ unsigned or_prefix(unsigned v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v |= __shfl_up_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned or_suffix(unsigned v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v |= __shfl_down_sync(kFull, v, o);
  return v;
}

// Its register cap is the source's -maxrregcount (see Build above); its
// loop-invariant per-program counters, trip counts and the cell's
// constants sit in shared memory, so that 80 registers hold the rest.
template <bool kMaterialise>
__global__ void window_kernel_bitset(Params prm) {
  extern __shared__ int smem[];
  __shared__ BitsetShared sh;
  const int P = prm.P, N = prm.N, cap = prm.ring;
  int* ring_tag = smem;                   // (P, cap) upcoming tags
  int* ring_cost = ring_tag + P * cap;    // (P, cap) upcoming costs
  int* sched = ring_cost + P * cap;       // (S,)
  int* quanta = sched + prm.S;            // (P,) this cell's quanta
  int* pv = quanta + P;                   // (5, P) per-program counters

  const int cell = blockIdx.x;
  const int l = cell % prm.L;
  const int k = (cell / prm.L) % prm.K;
  const int b = (cell / (prm.L * prm.K)) % prm.B;
  const int q = cell / (prm.L * prm.K * prm.B);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t stream = static_cast<size_t>(b) * P * N;

  for (int i = tid; i < prm.S; i += kPassRows) sched[i] = prm.schedule[i];
  for (int i = tid; i < P; i += kPassRows) quanta[i] = prm.quanta[q * P + i];
  // the first fill: every program's ring holds the cap rows from its
  // cursor (start + row < N + cap fits an int)
  for (int pr = 0; pr < P; ++pr) {
    const int start = cursor_index(prm.seed_vec, pr, N);
    const int* gtag = prm.tags + stream + static_cast<size_t>(pr) * N;
    const int* gcost = prm.costs + stream + static_cast<size_t>(pr) * N;
    for (int a = tid; a < cap; a += kPassRows) {
      const int src = (start + a) % N;
      cp_async4(ring_tag + pr * cap + a, gtag + src);
      cp_async4(ring_cost + pr * cap + a, gcost + src);
    }
  }
  cp_async_commit();
  for (int i = tid; i < 5 * P; i += kPassRows)
    pv[i] = prm.seed_vec ? prm.seed_vec[i] : 0;
  // lane p of every warp holds program p's ring state: the ring slot of
  // its cursor and the trace index of the row its next refill fetches
  int slot = 0, fetch = 0;
  if (lane < P) fetch = (cursor_index(prm.seed_vec, lane, N) + cap) % N;
  if (warp == 0) {
    const int lp = lane < prm.T && prm.seed_last ? prm.seed_last[lane] : -1;
    unsigned newer = 0;
    for (int v = 0; v < 32; ++v)
      newer |= static_cast<unsigned>(__shfl_sync(kFull, lp, v) > lp) << v;
    sh.last_pos[lane] = lp;
    sh.last_miss[lane] = -1;
    sh.newer[lane] = newer;
    if (lane >= kBitsetWarps) {     // the neutral entries: no warp there
      sh.tot[lane] = 0u;
      sh.info[lane] = 32;
      sh.end_cum[lane] = 0;
      sh.rset[lane] = sh.rmiss[lane] = 0u;
    }
    if (lane == 0) {
      sh.trips = sh.passes = 0;
      sh.num_active = prm.slot_counts[k];
      sh.lat = prm.lats[l];
      sh.stream = stream;
      sh.switches = prm.seed_sca ? prm.seed_sca[2] : 0;
    }
  }
  int sched_idx = prm.seed_sca ? prm.seed_sca[0] : 0;
  int q_cycles = prm.seed_sca ? prm.seed_sca[1] : 0;
  int steps_done = 0;
  cp_async_wait<0>();
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;                    // lanes below
  const unsigned gt = ~(lt | (1u << lane));                   // lanes above
  // the open trip; every thread computes it alike
  int p = 0, limit = 0, slot_p = 0, base = 0;
  int running = 0, committed = 0, n_miss = 0, n_cold = 0;
  while (steps_done < prm.total_steps) {
    if (base == 0) {
      p = sched[sched_idx];
      limit = min(prm.window, prm.total_steps - steps_done);
      slot_p = __shfl_sync(kFull, slot, p);
      running = q_cycles;
      committed = n_miss = n_cold = 0;
    }
    const int rows = min(kPassRows, limit - base);
    const int j = warp * 32 + lane;               // this thread's row
    const bool valid = j < rows;
    int t = -1, h = 0;
    if (valid) {
      int s = slot_p + base + j;
      if (s >= cap) s -= cap;
      t = ring_tag[p * cap + s];
      h = ring_cost[p * cap + s];
    }
    const int pos = prm.pos_base + steps_done + base + j;

    // phase 1, per warp: the row's tag bit, its tag's rows, its previous
    // in-warp occurrence k, OR-scans of the tag bits (both ways) and of
    // 1 << k; a row whose tag occurred earlier in the warp has its stack
    // distance already: the live rows between (each the last occurrence
    // of its tag so far), counted
    const bool tagged = t >= 0;
    const unsigned bit = tagged ? 1u << t : 0u;
    // the rows of this row's tag: six ballots on the bits of t + 1 (0..32;
    // quicker than __match_any_sync, which serialises on distinct values)
    const unsigned key = static_cast<unsigned>(t + 1);
    unsigned same = kFull;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const unsigned b = __ballot_sync(kFull, (key >> k) & 1u);
      same &= (key >> k) & 1u ? b : ~b;
    }
    const unsigned below = same & lt;
    const int kprev = tagged && below ? 31 - __clz(below) : -1;
    unsigned pre = or_prefix(bit);
    unsigned dead = or_prefix(kprev >= 0 ? 1u << kprev : 0u);
    unsigned suf = or_suffix(bit);
    const unsigned wset = __shfl_sync(kFull, pre, 31);
    // the exclusive forms (lane 0 has no lane below, 31 none above)
    pre = __shfl_up_sync(kFull, pre, 1);
    dead = __shfl_up_sync(kFull, dead, 1);
    suf = __shfl_down_sync(kFull, suf, 1);
    if (lane == 0) pre = dead = 0u;
    if (lane == 31) suf = 0u;
    const unsigned tagged_rows = __ballot_sync(kFull, tagged);
    if (tagged && (same & gt) == 0) sh.after[warp][t] = suf;
    sh.wset[warp] = wset;          // uniform: every lane stores the same
    int dist = kprev >= 0 ? __popc(lt & tagged_rows & ~dead &
                                   (kFull << (kprev + 1)))
                          : 0;
    __syncthreads();

    // phase 2: lane u of each warp walks the earlier warps for tag u: the
    // tags newer than u's last occurrence before this warp, and whether u
    // is cold here; a row without an in-warp occurrence takes its tag's
    // word, ORed with the tags of the rows before it in the warp
    unsigned newer = sh.newer[lane];
    unsigned seen = 0u;
    for (int x = 0; x < warp; ++x) {
      const unsigned wx = sh.wset[x];
      const unsigned has = (wx >> lane) & 1u;
      const unsigned ax = sh.after[x][lane];
      newer = has ? ax : newer | wx;
      seen |= has;
    }
    const int cold_u = !seen && sh.last_pos[lane] < 0;
    const int src = tagged ? t : 0;
    const unsigned newer_t = __shfl_sync(kFull, newer, src);
    const int cold_t = __shfl_sync(kFull, cold_u, src);
    bool cold = false;
    if (tagged && kprev < 0) {
      dist = __popc(newer_t | pre);
      cold = cold_t;
    }
    const bool miss = tagged && (cold || dist >= sh.num_active);
    unsigned incl = valid ? static_cast<unsigned>(h) + (miss ? sh.lat : 0u) +
                                (cold ? static_cast<unsigned>(prm.bs_extra)
                                      : 0u)
                          : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned a = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += a;
    }
    sh.tot[warp] = __shfl_sync(kFull, incl, 31);
    __syncthreads();

    // phase 3, per warp: the running cost of each row, the warp's first
    // expiry f, and what the commit needs of its rows up to f
    const unsigned tx = sh.tot[lane];
    const unsigned offs = __reduce_add_sync(kFull, lane < warp ? tx : 0u);
    const unsigned total = __reduce_add_sync(kFull, tx);
    const int cum = static_cast<int>(static_cast<unsigned>(running) + offs +
                                     incl);
    const unsigned expiring =
        __ballot_sync(kFull, valid && cum >= quanta[p]);
    const int f = expiring ? __ffs(expiring) - 1 : 32;
    const unsigned upto = f >= 31 ? kFull : (2u << f) - 1u;
    const bool in_f = (upto >> lane) & 1u;
    const unsigned miss_rows = __ballot_sync(kFull, miss);
    const unsigned cold_rows = __ballot_sync(kFull, cold);
    const unsigned rset = __reduce_or_sync(kFull, in_f ? bit : 0u);
    const unsigned rmiss = __reduce_or_sync(kFull, in_f && miss ? bit : 0u);
    const int ecum = __shfl_sync(kFull, cum, f & 31);
    sh.info[warp] = f | __popc(miss_rows & upto) << 8 |   // uniform
                    __popc(cold_rows & upto) << 16;
    sh.end_cum[warp] = ecum;
    sh.rset[warp] = rset;
    sh.rmiss[warp] = rmiss;
    cp_async_wait<1>();     // the refills issued two passes ago
    __syncthreads();

    // phase 4, every warp alike: the cut (the first warp holding an
    // expiry), the pass's counts; then each tag's final committed
    // occurrence writes its carry
    const int info = sh.info[lane];
    const unsigned exp_warps = __ballot_sync(kFull, (info & 0xff) < 32);
    const bool expiry = exp_warps != 0u;
    const int wc = expiry ? __ffs(exp_warps) - 1 : kBitsetWarps - 1;
    const bool in_cut = lane <= wc;
    const unsigned rs = in_cut ? sh.rset[lane] : 0u;
    const unsigned rm = kMaterialise && in_cut ? sh.rmiss[lane] : 0u;
    const unsigned touched = __reduce_or_sync(kFull, rs);
    const unsigned later = __reduce_or_sync(kFull, lane > warp ? rs : 0u);
    const unsigned later_miss =
        __reduce_or_sync(kFull, lane > warp ? rm : 0u);
    const int pass_miss =
        __reduce_add_sync(kFull, in_cut ? (info >> 8) & 0xff : 0);
    const int pass_cold =
        __reduce_add_sync(kFull, in_cut ? (info >> 16) & 0xff : 0);
    const int cut =
        expiry ? wc * 32 + (__shfl_sync(kFull, info, wc) & 0xff) + 1 : rows;
    const int end_cum = expiry ? sh.end_cum[wc]
                               : static_cast<int>(
                                     static_cast<unsigned>(running) + total);
    if (warp <= wc) {
      // this warp's committed rows: all of them, or those up to the cut
      const int fo = expiry && warp == wc ? f : 32;
      const unsigned mine = fo >= 31 ? kFull : (2u << fo) - 1u;
      const bool comm = valid && ((mine >> lane) & 1u);
      unsigned after = suf;     // tags after this row among the committed
      if (fo < 32) {
        after = __shfl_down_sync(kFull, or_suffix(comm ? bit : 0u), 1);
        if (lane == 31) after = 0u;
      }
      if (comm && tagged && (same & gt & mine) == 0u &&
          !((later >> t) & 1u)) {
        sh.last_pos[t] = pos;
        sh.newer[t] = after | later;
      }
      if (kMaterialise && comm && miss &&
          (same & miss_rows & gt & mine) == 0u &&
          !((later_miss >> t) & 1u))
        sh.last_miss[t] = pos;
    }
    // untouched tags: every warp ORs the same set in (idempotent)
    if (!((touched >> lane) & 1u)) sh.newer[lane] |= touched;
    committed += cut;
    n_miss += pass_miss;
    n_cold += pass_cold;
    running = end_cum;
    base += kPassRows;

    if (expiry || base >= limit) {
      // the trip's end: counters, scheduler state, and the refill of the
      // ring slots of the rows it consumed
      const int fetch_p = __shfl_sync(kFull, fetch, p);
      const int* gtag = prm.tags + sh.stream + static_cast<size_t>(p) * N;
      const int* gcost = prm.costs + sh.stream + static_cast<size_t>(p) * N;
      for (int i = tid; i < committed; i += kPassRows) {
        int s = slot_p + i;
        if (s >= cap) s -= cap;
        int from = fetch_p + i;
        if (from >= N) from %= N;
        cp_async4(ring_tag + p * cap + s, gtag + from);
        cp_async4(ring_cost + p * cap + s, gcost + from);
      }
      if (tid == p) {       // one writer; read back only after the loop
        pv[p] += committed;
        pv[P + p] = static_cast<int>(
            static_cast<unsigned>(pv[P + p]) +
            static_cast<unsigned>(running) - static_cast<unsigned>(q_cycles) +
            (expiry ? static_cast<unsigned>(prm.handler) : 0u));
        pv[2 * P + p] += committed;
        pv[3 * P + p] += n_miss;
        pv[4 * P + p] += n_cold;
        ++sh.trips;
        sh.switches += expiry ? 1 : 0;
      }
      if (lane == p) {
        slot += committed;
        if (slot >= cap) slot -= cap;
        fetch += committed;
        if (fetch >= N) fetch %= N;
      }
      if (expiry && ++sched_idx == prm.S) sched_idx = 0;
      steps_done += committed;
      q_cycles = expiry ? 0 : running;
      base = 0;
    }
    if (tid == 0) ++sh.passes;
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = tid; i < 5 * P; i += kPassRows)
    prm.out_vec[static_cast<size_t>(cell) * 5 * P + i] = pv[i];
  if (tid == 0) {
    int* sca = prm.out_sca + cell * 4;
    sca[0] = sched_idx;
    sca[1] = steps_done;
    sca[2] = q_cycles;
    sca[3] = sh.switches;
    if (prm.out_stats) {
      prm.out_stats[cell * 2] = sh.trips;
      prm.out_stats[cell * 2 + 1] = sh.passes;
    }
  }
  if (prm.out_last && tid < prm.T) {
    prm.out_last[static_cast<size_t>(cell) * prm.T + tid] = sh.last_pos[tid];
    prm.out_miss[static_cast<size_t>(cell) * prm.T + tid] =
        sh.last_miss[tid];
  }
}

bool bitset_route(int num_tags, int num_progs) {
  return num_tags <= kMaxTags && num_progs <= kMaxProgs;
}

// Rows of the longest trip: no trip reads past the run's end.
int trip_rows(int window, int total_steps) {
  return total_steps < window ? (total_steps > 1 ? total_steps : 1) : window;
}

}  // namespace

extern "C" {

// Shared memory of a block (dynamic and static) on the route the shapes
// select: the bitset route's stream rings (sized for the longest trip,
// min(window, total_steps) rows), schedule and per-program vectors, or the
// generic route's per-tag vectors and occurrence masks.
size_t window_distance_smem_bytes(int num_tags, int num_progs, int window,
                                  int total_steps, int sched_len) {
  if (bitset_route(num_tags, num_progs))
    return sizeof(int) * (2 * static_cast<size_t>(num_progs) *
                              ring_rows(trip_rows(window, total_steps)) +
                          sched_len + 6 * static_cast<size_t>(num_progs)) +
           sizeof(BitsetShared);
  return sizeof(int) * (static_cast<size_t>(num_tags) * (2 + kWords) +
                        5 * static_cast<size_t>(num_progs) + kWarps + 5);
}

// Runs C = Q*B*K*L cells, one CTA each, on `stream`, on the route the
// shapes select (written to *route: 1 bitset, 0 generic).  `out_stats`
// ((C, 2) trips and passes per cell) is written by the bitset route when
// given.  Returns the CUDA error of the launch (0 on success); never
// synchronises.
int window_distance_launch(
    const int* tags, const int* costs, const int* slot_counts,
    const int* lats, const int* quanta, const int* schedule,
    const int* seed_last, const int* seed_vec, const int* seed_sca,
    int* out_vec, int* out_sca, int* out_last, int* out_miss, int B, int P,
    int N, int Q, int K, int L, int S, int T, int handler, int bs_extra,
    int total_steps, int window, int pos_base, int materialise,
    void* stream, int* out_stats, int* route) {
  const bool bitset = bitset_route(T, P);
  *route = bitset ? 1 : 0;
  const int cells = Q * B * K * L;
  if (cells <= 0) return 0;
  const auto cuda_stream = static_cast<cudaStream_t>(stream);
  if (bitset) {
    Params prm{tags, costs, slot_counts, lats, quanta, schedule, seed_last,
               seed_vec, seed_sca, out_vec, out_sca, out_last, out_miss,
               B, P, N, Q, K, L, S, T, handler, bs_extra, total_steps,
               window, pos_base, out_stats,
               static_cast<int>(ring_rows(trip_rows(window, total_steps)))};
    const size_t smem =
        window_distance_smem_bytes(T, P, window, total_steps, S) -
        sizeof(BitsetShared);
    auto kernel = materialise ? window_kernel_bitset<true>
                              : window_kernel_bitset<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<cells, kPassRows, smem, cuda_stream>>>(prm);
    return static_cast<int>(cudaGetLastError());
  }
  Params prm{tags, costs, slot_counts, lats, quanta, schedule, seed_last,
             seed_vec, seed_sca, out_vec, out_sca, out_last, out_miss,
             B, P, N, Q, K, L, S, T, handler, bs_extra, total_steps, window,
             pos_base, nullptr, 0};
  const size_t smem = sizeof(int) * (static_cast<size_t>(T) * (2 + kWords) +
                                     5 * static_cast<size_t>(P));
  auto kernel = materialise ? window_kernel<true> : window_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cells, kThreads, smem, cuda_stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
