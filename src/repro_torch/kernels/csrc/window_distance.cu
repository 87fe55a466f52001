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
// num_tags int32 operations per access, a bound well under a millisecond;
// the kernel is instead a sequential chain of a few hundred window trips
// per cell, each a handful of block-wide barriers (scan, min, sums).  The
// design keeps that chain short and on-chip: the per-tag `last_pos` (and
// in materialise mode `last_miss`) vectors live in shared memory for the
// whole run, so no (W, num_tags) intermediate ever exists; a window longer
// than the block is walked in chunks of kThreads rows carrying the running
// cost and the per-tag state, and the walk stops at the chunk holding the
// quantum expiry instead of finishing the window.  Within a chunk, each
// tag's occurrences are a bitmask over rows, so an access's previous
// occurrence is one find-last-set and its stack distance a loop over tags
// that stops once it reaches the slot count.  The TPU's 128-lane /
// 8-sublane pads, its 2-D iota and its reps-fold trace tiling are gone:
// rows index the trace modulo trace_len.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_runtime.h>

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

}  // namespace

extern "C" int window_distance_threads() { return kThreads; }

extern "C" size_t window_distance_smem_bytes(int num_tags, int num_progs) {
  return sizeof(int) * (static_cast<size_t>(num_tags) * (2 + kWords) +
                        5 * static_cast<size_t>(num_progs));
}

// Runs C = Q*B*K*L cells, one CTA each, on `stream`.  Returns the CUDA
// error of the launch (0 on success); never synchronises.
extern "C" int window_distance_launch(
    const int* tags, const int* costs, const int* slot_counts,
    const int* lats, const int* quanta, const int* schedule,
    const int* seed_last, const int* seed_vec, const int* seed_sca,
    int* out_vec, int* out_sca, int* out_last, int* out_miss, int B, int P,
    int N, int Q, int K, int L, int S, int T, int handler, int bs_extra,
    int total_steps, int window, int pos_base, int materialise,
    void* stream) {
  Params prm{tags, costs, slot_counts, lats, quanta, schedule, seed_last,
             seed_vec, seed_sca, out_vec, out_sca, out_last, out_miss,
             B, P, N, Q, K, L, S, T, handler, bs_extra, total_steps, window,
             pos_base};
  const size_t smem = window_distance_smem_bytes(T, P);
  const int cells = Q * B * K * L;
  if (cells <= 0) return 0;
  auto kernel = materialise ? window_kernel<true> : window_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cells, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
