// RWKV6 (Finch) WKV recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.rwkv6_scan.rwkv6_scan` of the JAX
// package (def at rwkv6_scan.py:63, pallas_call at :76).  Per batch row
// and head, with r, k, v (B, T, H, N) (bf16 or f32), the log-decay logw
// (B, T, H, N) f32 (<= 0) and the bonus u (H, N) f32, and the state S
// (N x N, keyed [key i, value j]) starting from S0 (B, H, N, N) f32 (zero
// when none is given):
//   o_t[j] = sum_i r_t[i] S[i, j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i, j] <- exp(logw_t[i]) S[i, j] + k_t[i] v_t[j]
// writing o (B, T, H, N) f32 and the final state (B, H, N, N) f32.  This
// is `repro.models.rwkv6.recurrence_scan`, the function the JAX model
// computes at every T (its chunked form is the same function in another
// summation order); the Pallas kernel starts from zero and returns o only,
// the model needs both ends of the state.
//
// Two routes, chosen in the C entry point from the shapes and the
// operands' alignment alone (`chunked_possible`) and written back:
//
// * "chunked" (T >= 2 L, 16-byte aligned operands: every prefill) walks
//   sub-chunks of L = 16 tokens in state-passing form.  With cl / clp the
//   inclusive / exclusive log-decay cumsums from a sub-chunk's start:
//     inter:  o  = (r exp(clp)) @ S
//     intra:  o += A v, A[t, s] = sum_n r[t,n] k[s,n] exp(clp[t,n] -
//             cl[s,n]) for s < t, A[t, t] = sum_n r[t,n] u[n] k[t,n]
//     state:  S  = diag(exp(cl_L)) S + (k exp(cl_L - cl))^T v
//   Every decay factor is <= 1 and is taken inside the sub-chunk alone:
//   rwkv6's decays (logw ~ -1.65 a step at w0 = 0.5) would overflow f32 if
//   the decay of a whole 64-token chunk were factored as r exp(clp) times
//   k exp(-cl).  Each factor is the product of the per-step decays exp(logw)
//   it spans, multiplied up as the sequential recurrence does, never the
//   exponential of a difference of cumsums: at logw -20 a step the cumsums
//   reach -320 within a sub-chunk, where f32 keeps them only to ~3e-5, and
//   their difference would carry that error into factors near 1.  Two
//   kernels, one launch after the other:
//   - `rwkv6_kernel_chunked_prep`, one CTA per (sub-chunk, head, batch row),
//     all sub-chunks in parallel: everything that does not depend on the
//     state.  The decayed r and k and exp(cl_L) (half a column's rows a
//     thread) and A (a pair of its rows a warp, the keys across the lanes
//     and summed by shuffles), as bf16 hi + lo, into a record per
//     sub-chunk in a scratch the wrapper allocates (~10 KB; 40 MB at T
//     1024, H 64, bf16).
//   - `rwkv6_kernel_chunked`, the state pass: the state's value columns
//     evolve independently (S[:, j] depends on v[:, j] alone), so the grid
//     is (head, batch row, block of VC = 32 value columns), 128 CTAs at B
//     1, H 64, N 64, each holding its S[:, cols] in registers for the whole
//     of T.  Four loader warps keep four sub-chunks' records in flight
//     through a 6-stage cp.async ring (rows padded by 16 bytes so that
//     ldmatrix's eight rows fall in distinct banks); one state warp a block
//     of 8 value columns, all N keys, runs the three products on the
//     tensor cores (mma.sync m16n8k16), the f32 operands (the decayed r
//     and k, A, S, and v when it is f32) split into bf16 hi + lo and
//     summed as hi hi + hi lo + lo hi in f32 (~2^-17 relative a product,
//     against the 5e-4 the kernel is held to).  S stays in registers in
//     the accumulator layout of the state update's product (key rows,
//     value columns); the inter product takes it as its B operand, each
//     8 x 8 block of the bf16 hi and lo packs transposed in registers
//     (movmatrix).  The update's product, summed from zero, is added to S
//     in f32.  One CTA barrier a sub-chunk hands a stage from the loaders
//     to the state warps.
//   The ragged tail is zero-filled (logw 0, a decay of 1) and its rows are
//   not stored.
// * "step" (`rwkv6_kernel_step`, T < 2 L, e.g. T 1 at decode, or operands
//   that are not 16-byte aligned): one CTA per (head, batch row) with N
//   threads; thread j owns the value column S[:, j] in registers and walks
//   the steps, the inputs of kChunk steps staged in shared memory.
//
// What bounds it on this card: at B = 1, T = 1024, H = 64, N = 64 the
// function moves ~59 MB (four (T, H, N) inputs, o in f32, the state in and
// out), ~17.6 us at 3.35 TB/s, and does ~4 N^2 f32 operations a token and
// head (~1.07 GFLOP, ~16 us at the CUDA cores' 67 TFLOP/s).  The chunked
// route adds the records' round trip: ~40 MB written by the parallel pass
// and read once a column block by the state pass (~88 MB into shared
// memory at T 1024), and A's L (L - 1) / 2 N products a sub-chunk (~7.5 a
// token and key).  The state pass is bound by that stream (its loaders
// alone take most of its time), the parallel pass by its bytes and A.
// (On an H100 SXM, one kernel that computed A and the decayed r and k
// beside the state measured 2.5-3x slower: one or two warps an SM
// partition could not hide that work's latency.  Bulk copies (TMA) with
// mbarriers in place of the cp.async ring, key-split state warps, a value
// block of 64, or a deeper ring did not make the state pass faster.  The
// chunk-parallel alternative, a pass writing every chunk's start state to
// memory and a pass consuming it, adds ~16.8 MB of state traffic at T
// 1024 and a third launch; it was not chosen.)  The step route at B = 8,
// T = 1 moves ~9 MB, its state in and out.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Params {
  const T* r;
  const T* k;
  const T* v;
  const float* logw;                    // (B, T, H, N), all contiguous
  const float* u;                       // (H, N)
  const float* s0;                      // (B, H, N, N) or null
  float* o;                             // (B, T, H, N)
  float* s_out;                         // (B, H, N, N)
  int steps, H;                         // T, H
};

// ---------------------------------------------------------------------------
// step route: one CTA per (head, batch row), thread j on value column j
// ---------------------------------------------------------------------------

constexpr int kChunk = 8;               // time steps staged a barrier

template <typename T, int N>
__global__ void __launch_bounds__(N) rwkv6_kernel_step(Params<T> p) {
  // [buffer][step][r, k, w = exp(logw), v][i]
  __shared__ float stage[2][kChunk][4][N];
  __shared__ float ru[N];               // u of this head
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long row = static_cast<long long>(p.H) * N;   // a time step
  const long long head =
      (static_cast<long long>(b) * p.steps * p.H + h) * N + j;
  const long long state = (static_cast<long long>(b) * p.H + h) * N * N + j;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    S[i] = p.s0 != nullptr ? p.s0[state + i * N] : 0.f;
  ru[j] = p.u[h * N + j];

  float pre[4][kChunk];                 // element j of the next chunk
  auto fetch = [&](int t0) {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const bool ok = t0 + s < p.steps;
      const long long at = head + (t0 + s) * row;
      pre[0][s] = ok ? to_f32(p.r[at]) : 0.f;
      pre[1][s] = ok ? to_f32(p.k[at]) : 0.f;
      pre[2][s] = ok ? p.logw[at] : 0.f;
      pre[3][s] = ok ? to_f32(p.v[at]) : 0.f;
    }
  };

  fetch(0);
  int buf = 0;
  for (int t0 = 0; t0 < p.steps; t0 += kChunk, buf ^= 1) {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      stage[buf][s][0][j] = pre[0][s];
      stage[buf][s][1][j] = pre[1][s];
      stage[buf][s][2][j] = expf(pre[2][s]);
      stage[buf][s][3][j] = pre[3][s];
    }
    // publishes this buffer; the other one's readers (the chunk before)
    // are all past it
    __syncthreads();
    if (t0 + kChunk < p.steps) fetch(t0 + kChunk);

    const int n_s = min(kChunk, p.steps - t0);
    for (int s = 0; s < n_s; ++s) {
      const float* rs = stage[buf][s][0];
      const float* ks = stage[buf][s][1];
      const float* ws = stage[buf][s][2];
      const float vj = stage[buf][s][3][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float ri = rs[i], ki = ks[i];
        acc[i % 4] = fmaf(ri, S[i], acc[i % 4]);
        bonus[i % 4] = fmaf(ri * ru[i], ki, bonus[i % 4]);
        S[i] = fmaf(ws[i], S[i], ki * vj);
      }
      const float o = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                      ((bonus[0] + bonus[1]) + (bonus[2] + bonus[3])) * vj;
      p.o[head + (t0 + s) * row] = o;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p.s_out[state + i * N] = S[i];
}

// ---------------------------------------------------------------------------
// chunked route: sub-chunks of L tokens in state-passing form, mma.sync
// ---------------------------------------------------------------------------

constexpr int L = 16;                   // tokens a sub-chunk
constexpr int kPrepThreads = 32 * (L / 2);  // a pair of A's rows a warp
constexpr int kLoadWarps = 4;           // the sequential kernel's loaders
constexpr int kLoad = 32 * kLoadWarps;
constexpr int kStages = 6;              // sub-chunks in shared memory
constexpr int kAhead = kStages - 2;     // sub-chunks in flight

// The two roles reach their barriers from different instructions, so the
// barriers are the unaligned forms (bar.sync, which __syncthreads emits,
// is the aligned one: every thread of the CTA at the same instruction).
__device__ __forceinline__ void cta_sync() {    // every thread of the CTA
  asm volatile("barrier.sync 0;" ::: "memory");
}

// State warps: one a block of 8 value columns, holding S[:, cols] for all
// N keys.
template <int N, int VC>
constexpr int kChunkedThreads = kLoad + 32 * (VC / 8);

// The 8 x 8 bf16 matrix whose m8n8 fragment this lane holds (row lane / 4,
// columns 2 (lane % 4) and + 1, packed), transposed in registers.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// x as bf16 hi + lo, hi = rn(x), lo = rn(x - hi)
__device__ __forceinline__ void split(float x, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// One halving exchange over lanes 2W apart: the lane with that bit set
// keeps a[W..2W) (moved to a[0..W)), the other a[0..W), each adding its
// partner's copy.  W is a template argument so that a[] stays in
// registers.
template <int W, int K>
__device__ __forceinline__ void halve(float (&a)[K], int lane) {
  const bool upper = (lane & (2 * W)) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? a[i] : a[i + W];
    const float keep = upper ? a[i + W] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * W);
  }
}

template <int kQ>
__device__ __forceinline__ void load_keys(const float* src, float (&dst)[kQ]) {
  if constexpr (kQ == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
#pragma unroll
    for (int m = 0; m < kQ; ++m) dst[m] = src[m];
  }
}

// A's rows G and L-1-G (17 entries with the two diagonals) over the keys
// of this lane (kQ of them, n = lane kQ + m; none past N), summed over the
// warp, as bf16 hi + lo into ahi/alo [t][s].  Entry e is (G, G - e) for e
// <= G, else (L-1-G, L-1-G - (e - G - 1)): s descends from each row's
// diagonal (the bonus r u k), so exp(clp_t - cl_s), the product of the
// decays wf strictly between s and t, is multiplied up from 1.  G is a
// template argument so that every index is known when compiled.
template <int G, int N, int kQ>
__device__ __forceinline__ void a_rows(const float (*rf)[N + 4],
                                       const float (*kf)[N + 4],
                                       const float (*wf)[N + 4],
                                       const float (&uq)[kQ], int lane,
                                       __nv_bfloat16 (*ahi)[L + 8],
                                       __nv_bfloat16 (*alo)[L + 8]) {
  constexpr int T1 = G, T2 = L - 1 - G;
  const bool live = lane * kQ < N;
  const int n0 = live ? lane * kQ : 0;
  // this lane's keys of every row it reads, in registers first
  float r1[kQ], r2[kQ], kq[T2 + 1][kQ], wq[T2][kQ];
  load_keys<kQ>(&rf[T1][n0], r1);
  load_keys<kQ>(&rf[T2][n0], r2);
#pragma unroll
  for (int s = 0; s <= T2; ++s) load_keys<kQ>(&kf[s][n0], kq[s]);
#pragma unroll
  for (int s = 1; s < T2; ++s) load_keys<kQ>(&wf[s][n0], wq[s]);
  float a[17], run[kQ];
#pragma unroll
  for (int e = 0; e < 17; ++e) {
    const int t = e <= T1 ? T1 : T2, s = e <= T1 ? T1 - e : T2 - (e - T1 - 1);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kQ; ++m) {
      const float rk = (t == T1 ? r1[m] : r2[m]) * kq[s][m];
      float f;
      if (s == t) {
        run[m] = 1.f;
        f = uq[m];
      } else {
        if (s < t - 1) run[m] *= wq[s + 1][m];
        f = run[m];
      }
      acc = fmaf(rk, f, acc);
    }
    a[e] = live ? acc : 0.f;
  }
  // entries 0..15: halving exchanges leave lanes 2e and 2e + 1 with entry
  // e's partial sums, one butterfly step adds them; entry 16 by a full
  // butterfly
  halve<8>(a, lane);
  halve<4>(a, lane);
  halve<2>(a, lane);
  halve<1>(a, lane);
  a[0] += __shfl_xor_sync(0xffffffffu, a[0], 1);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    a[16] += __shfl_xor_sync(0xffffffffu, a[16], off);
  const int e = lane >> 1;
  const int t = e <= T1 ? T1 : T2, s = e <= T1 ? T1 - e : T2 - (e - T1 - 1);
  if ((lane & 1) == 0) split(a[0], ahi[t][s], alo[t][s]);
  if (lane == 1) split(a[16], ahi[T2][0], alo[T2][0]);   // entry 16
}

// What a sub-chunk hands from the parallel kernel to the sequential one,
// in device memory (one record per (batch row, head, sub-chunk)): the
// decayed r and k and A as bf16 hi + lo, exp(cl_L), and v's hi + lo when
// v is f32 (bf16 v is read from the input itself).
template <int N>
struct __align__(16) SubChunkBase {
  __nv_bfloat16 rhi[L][N], rlo[L][N];   // r exp(clp)
  __nv_bfloat16 khi[L][N], klo[L][N];   // k exp(cl_L - cl)
  __nv_bfloat16 ahi[L][L + 8], alo[L][L + 8];   // A [t][s], rows padded
  float d[N];                           // exp(cl_L)
};

template <int N, bool kSplitV>
struct __align__(16) SubChunkRec : SubChunkBase<N> {
  __nv_bfloat16 vhi[L][N], vlo[L][N];
};

template <int N>
struct __align__(16) SubChunkRec<N, false> : SubChunkBase<N> {};

template <typename T, int N>
using SubChunk = SubChunkRec<N, sizeof(T) == 4>;

// Everything of a sub-chunk that does not depend on the state, for every
// sub-chunk in parallel: one CTA per (sub-chunk, head, batch row).  The
// decays exp(logw) are taken once; the decayed r and k take half a
// column's rows a thread, each factor the product of the decays it spans;
// A takes a pair of its rows a warp (`a_rows`).
template <typename T, int N>
__global__ void __launch_bounds__(kPrepThreads)
rwkv6_kernel_chunked_prep(Params<T> p, SubChunk<T, N>* out) {
  __shared__ __align__(16) float rf[L][N + 4], kf[L][N + 4], wf[L][N + 4];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = static_cast<long long>(p.H) * N;
  const long long head = (static_cast<long long>(b) * p.steps * p.H + h) * N;
  SubChunk<T, N>& o =
      out[(static_cast<long long>(b) * p.H + h) * gridDim.x + c];
  for (int x = tid; x < L * N; x += kPrepThreads) {   // zero past T
    const int t = x / N, n = x % N, tt = c * L + t;
    const bool ok = tt < p.steps;
    const long long at = head + static_cast<long long>(ok ? tt : 0) * row + n;
    rf[t][n] = ok ? to_f32(p.r[at]) : 0.f;
    kf[t][n] = ok ? to_f32(p.k[at]) : 0.f;
    wf[t][n] = ok ? expf(p.logw[at]) : 1.f;   // the decay, <= 1
    if constexpr (sizeof(T) == 4)
      split(ok ? to_f32(p.v[at]) : 0.f, o.vhi[t][n], o.vlo[t][n]);
  }
  for (int x = tid; x < L * L; x += kPrepThreads) {   // A's upper triangle
    const int t = x / L, s = x % L;
    if (s > t) {
      o.ahi[t][s] = __float2bfloat16_rn(0.f);
      o.alo[t][s] = __float2bfloat16_rn(0.f);
    }
  }
  constexpr int kQ = N >= 32 ? N / 32 : 1;    // A's keys a lane
  float uq[kQ];
#pragma unroll
  for (int m = 0; m < kQ; ++m)
    uq[m] = lane * kQ + m < N ? p.u[h * N + lane * kQ + m] : 0.f;
  __syncthreads();

  if (tid < 4 * N) {
    // thread (key n, r or k, half of the rows): the decays before t (for
    // r) or after t (for k) multiplied up, the other half's product first
    // where its rows need it
    const int n = tid % N, role = (tid / N) & 1, half = tid / (2 * N);
    constexpr int H2 = L / 2;
    float run = 1.f;
    if (role == 0) {
      if (half == 1) {
#pragma unroll
        for (int t = 0; t < H2; ++t) run *= wf[t][n];
      }
#pragma unroll
      for (int t = half * H2; t < half * H2 + H2; ++t) {
        split(rf[t][n] * run, o.rhi[t][n], o.rlo[t][n]);
        run *= wf[t][n];
      }
    } else {
      if (half == 0) {
#pragma unroll
        for (int t = L - 1; t >= H2; --t) run *= wf[t][n];
      }
#pragma unroll
      for (int t = half * H2 + H2 - 1; t >= half * H2; --t) {
        split(kf[t][n] * run, o.khi[t][n], o.klo[t][n]);
        run *= wf[t][n];
      }
      if (half == 0) o.d[n] = run;
    }
  }
  switch (warp) {
#define RWKV6_A_ROWS(G)                                                    \
  case G:                                                                  \
    a_rows<G, N, kQ>(rf, kf, wf, uq, lane, o.ahi, o.alo);                  \
    break;
    RWKV6_A_ROWS(0) RWKV6_A_ROWS(1) RWKV6_A_ROWS(2) RWKV6_A_ROWS(3)
    RWKV6_A_ROWS(4) RWKV6_A_ROWS(5) RWKV6_A_ROWS(6) RWKV6_A_ROWS(7)
#undef RWKV6_A_ROWS
  }
}

// The sequential kernel's shared memory: kStages sub-chunks, rows padded by
// 16 bytes so that ldmatrix's eight rows fall in distinct banks.
template <typename T, int N, int VC>
struct __align__(16) ChunkSmem {
  struct Stage {
    __nv_bfloat16 rhi[L][N + 8], rlo[L][N + 8];
    __nv_bfloat16 khi[L][N + 8], klo[L][N + 8];
    __nv_bfloat16 ahi[L][L + 8], alo[L][L + 8];
    __nv_bfloat16 vhi[L][VC + 8], vlo[L][VC + 8];
    float d[N];
  } st[kStages];
};

template <typename T, int N, int VC>
__global__ void __launch_bounds__(kChunkedThreads<N, VC>)
rwkv6_kernel_chunked(Params<T> p, const SubChunk<T, N>* in) {
  using Smem = ChunkSmem<T, N, VC>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  constexpr bool kF32 = sizeof(T) == 4;
  const int h = blockIdx.x, b = blockIdx.y, col0 = blockIdx.z * VC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsub = (p.steps + L - 1) / L;
  const long long row = static_cast<long long>(p.H) * N;   // a time step
  const long long head = (static_cast<long long>(b) * p.steps * p.H + h) * N;

  if (warp < kLoadWarps) {
    // ---------------------------------------------------------- loaders
    // cp.async of sub-chunk c's record (and, for bf16 v, its rows of this
    // block's columns, zero past T) into stage c % kStages
    const SubChunk<T, N>* rec =
        in + (static_cast<long long>(b) * p.H + h) * nsub;
    auto fetch = [&](int c) {
      typename Smem::Stage& sb = sm.st[c % kStages];
      const SubChunk<T, N>& sc = rec[c];
      constexpr int kRow = N / 8, kA = (L + 8) / 8, kVr = VC / 8;
      for (int x = tid; x < 4 * L * kRow; x += kLoad) {
        const int a = x / (L * kRow), t = (x / kRow) % L, e = x % kRow;
        const __nv_bfloat16(*src)[N] = a == 0 ? sc.rhi : a == 1 ? sc.rlo
                                       : a == 2 ? sc.khi : sc.klo;
        __nv_bfloat16(*dst)[N + 8] = a == 0 ? sb.rhi : a == 1 ? sb.rlo
                                     : a == 2 ? sb.khi : sb.klo;
        cp_async16(&dst[t][8 * e], &src[t][8 * e], true);
      }
      for (int x = tid; x < 2 * L * kA; x += kLoad) {
        const int a = x / (L * kA), t = (x / kA) % L, e = x % kA;
        cp_async16(a == 0 ? &sb.ahi[t][8 * e] : &sb.alo[t][8 * e],
                   a == 0 ? &sc.ahi[t][8 * e] : &sc.alo[t][8 * e], true);
      }
      for (int x = tid; x < N / 4; x += kLoad)
        cp_async16(&sb.d[4 * x], &sc.d[4 * x], true);
      for (int x = tid; x < L * kVr; x += kLoad) {
        const int t = x / kVr, e = x % kVr;
        if constexpr (kF32) {
          cp_async16(&sb.vhi[t][8 * e], &sc.vhi[t][col0 + 8 * e], true);
          cp_async16(&sb.vlo[t][8 * e], &sc.vlo[t][col0 + 8 * e], true);
        } else {
          const int tt = c * L + t;
          const bool ok = tt < p.steps;
          cp_async16(&sb.vhi[t][8 * e],
                     p.v + head + static_cast<long long>(ok ? tt : 0) * row +
                         col0 + 8 * e,
                     ok);
        }
      }
    };
    // kAhead sub-chunks in flight: the stage being filled is never the
    // one the state warps read (kAhead <= kStages - 2)
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      if (c < nsub) fetch(c);
      cp_async_commit();
    }
    for (int c = 0; c <= nsub; ++c) {
      if (c + kAhead < nsub) fetch(c + kAhead);
      cp_async_commit();
      cp_async_wait<kAhead>();          // sub-chunk c has landed
      cta_sync();                       // hand it to the state warps
    }
    return;
  }

  // ------------------------------------------------------------- state
  // warp w: value columns jw.. jw + 7 of the block, all N keys.  S (key
  // rows i, value columns j) in the m16n8 accumulator layout: s[mt] holds
  // rows i = 16 mt + g, + 8 and columns j = 2 tig, + 1.  The inter product
  // wants S as its B operand (k = i, n = j), the transpose of that layout
  // in each 8 x 8 block: movmatrix transposes the bf16 hi and lo packs.
  constexpr int MT = N / 16;
  const int jw = (warp - kLoadWarps) * 8, g = lane >> 2, tig = lane & 3;
  float s[MT][4];
  const long long sbase = (static_cast<long long>(b) * p.H + h) * N * N +
                          col0 + jw;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mt + g + 8 * (e >> 1), j = 2 * tig + (e & 1);
      s[mt][e] = p.s0 != nullptr ? p.s0[sbase + i * N + j] : 0.f;
    }

  for (int c = 0; c <= nsub; ++c) {
    if (c > 0) {
      const int cc = c - 1, t0 = cc * L;
      const typename Smem::Stage& ob = sm.st[cc % kStages];
      // v (s x j) as the B operand of the state update and of the intra
      // product: matrices (s 0-7, j) and (s 8-15, j), transposed loads
      uint32_t vb[2], vbl[2];
      {
        const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x2_trans(vb, &ob.vhi[vrow][jw]);
        if constexpr (kF32) ldmatrix_x2_trans(vbl, &ob.vlo[vrow][jw]);
      }
      // the state update's k^T v (i x j), summed from zero on the tensor
      // cores: it does not depend on S, so its products go first and
      // overlap the inter product's.  A operand k^T (i x s) from k [s][i]:
      // matrices (s 0-7, i 0-7), (s 0-7, i 8-15), (s 8-15, i 0-7), (s 8-15,
      // i 8-15) of each 16 keys, transposed
      float upd[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ka[4], kla[4];
        const int mi = lane >> 3;
        const int krow = (lane & 7) + (mi >> 1) * 8,
                  kcol = 16 * mt + (mi & 1) * 8;
        ldmatrix_x4_trans(ka, &ob.khi[krow][kcol]);
        ldmatrix_x4_trans(kla, &ob.klo[krow][kcol]);
        float (&u4)[4] = upd[mt];
        u4[0] = u4[1] = u4[2] = u4[3] = 0.f;
        mma_bf16(u4, ka, vb[0], vb[1]);
        mma_bf16(u4, kla, vb[0], vb[1]);
        if constexpr (kF32) mma_bf16(u4, ka, vbl[0], vbl[1]);
      }

      // o (t x j) of this warp's columns, the hi hi / hi lo / lo hi
      // products summed apart (three short mma chains)
      float o[3][4] = {};
      // inter: o += (r exp(clp)) @ S
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t rh[4], rl[4];
        const int rrow = (lane & 7) + ((lane >> 3) & 1) * 8,
                  rcol = 16 * kk + (lane >> 4) * 8;
        ldmatrix_x4(rh, &ob.rhi[rrow][rcol]);
        ldmatrix_x4(rl, &ob.rlo[rrow][rcol]);
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {   // rows i 16 kk + 8 x .. + 7
          const float v0 = s[kk][2 * x], v1 = s[kk][2 * x + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v0 - hf.x,
                                                          v1 - hf.y);
          bh[x] = movmatrix_trans(*reinterpret_cast<const uint32_t*>(&hi));
          bl[x] = movmatrix_trans(*reinterpret_cast<const uint32_t*>(&lo));
        }
        mma_bf16(o[0], rh, bh[0], bh[1]);
        mma_bf16(o[1], rh, bl[0], bl[1]);
        mma_bf16(o[2], rl, bh[0], bh[1]);
      }
      // state: S = diag(exp(cl_L)) S + the product above, in f32
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float d0 = ob.d[16 * mt + g], d1 = ob.d[16 * mt + g + 8];
        s[mt][0] = fmaf(d0, s[mt][0], upd[mt][0]);
        s[mt][1] = fmaf(d0, s[mt][1], upd[mt][1]);
        s[mt][2] = fmaf(d1, s[mt][2], upd[mt][2]);
        s[mt][3] = fmaf(d1, s[mt][3], upd[mt][3]);
      }
      // intra: o += A v (A's diagonal is the bonus)
      {
        uint32_t ah[4], al[4];
        const int arow = (lane & 7) + ((lane >> 3) & 1) * 8,
                  acol = (lane >> 4) * 8;
        ldmatrix_x4(ah, &ob.ahi[arow][acol]);
        ldmatrix_x4(al, &ob.alo[arow][acol]);
        mma_bf16(o[0], ah, vb[0], vb[1]);
        mma_bf16(o[2], al, vb[0], vb[1]);
        if constexpr (kF32) mma_bf16(o[1], ah, vbl[0], vbl[1]);
      }
      // o rows t0 + g and t0 + g + 8 of this warp's columns
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + g + 8 * half, x = 2 * half;
        if (t < p.steps) {
          float* dst = p.o + head + static_cast<long long>(t) * row + col0 +
                       jw + 2 * tig;
          *reinterpret_cast<float2*>(dst) =
              make_float2((o[0][x] + o[1][x]) + o[2][x],
                          (o[0][x + 1] + o[1][x + 1]) + o[2][x + 1]);
        }
      }
    }
    cta_sync();                         // the buffer may be refilled
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mt + g + 8 * (e >> 1), j = 2 * tig + (e & 1);
      p.s_out[sbase + i * N + j] = s[mt][e];
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int N>
int launch_step(const Params<T>& p, int B, cudaStream_t stream) {
  const dim3 grid(p.H, B);
  rwkv6_kernel_step<T, N><<<grid, N, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_chunked(const Params<T>& p, int B, void* scratch,
                   cudaStream_t stream) {
  constexpr int VC = N < 32 ? N : 32;
  constexpr int kBytes = static_cast<int>(sizeof(ChunkSmem<T, N, VC>));
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_kernel_chunked<T, N, VC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nsub = (p.steps + L - 1) / L;
  auto rec = static_cast<SubChunk<T, N>*>(scratch);
  rwkv6_kernel_chunked_prep<T, N>
      <<<dim3(nsub, p.H, B), kPrepThreads, 0, stream>>>(p, rec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_kernel_chunked<T, N, VC>
      <<<dim3(p.H, B, N / VC), kChunkedThreads<N, VC>, kBytes, stream>>>(p,
                                                                         rec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params<T>& p, int B, int N, void* scratch,
             cudaStream_t stream) {
  if (scratch == nullptr) {
    if (N == 16) return launch_step<T, 16>(p, B, stream);
    if (N == 32) return launch_step<T, 32>(p, B, stream);
    if (N == 64) return launch_step<T, 64>(p, B, stream);
  } else {
    if (N == 16) return launch_chunked<T, 16>(p, B, scratch, stream);
    if (N == 32) return launch_chunked<T, 32>(p, B, scratch, stream);
    if (N == 64) return launch_chunked<T, 64>(p, B, scratch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
long long record_bytes(int N) {
  if (N == 16) return sizeof(SubChunk<T, 16>);
  if (N == 32) return sizeof(SubChunk<T, 32>);
  if (N == 64) return sizeof(SubChunk<T, 64>);
  return 0;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// Whether these operands may take the chunked route: 16-byte aligned r, k,
// v, logw and o (the sub-chunks are staged by 16-byte cp.async copies and
// o is stored in pairs), any T, N 16, 32 or 64.
static bool chunked_possible(const void* r, const void* k, const void* v,
                             const float* logw, const float* o, int N) {
  return (N == 16 || N == 32 || N == 64) && aligned16(r) && aligned16(k) &&
         aligned16(v) && aligned16(logw) && aligned16(o);
}

// Bytes of the chunked route's scratch (a record of every sub-chunk: the
// decayed r and k, A, exp(cl_L), and v split when f32), which the caller
// allocates (16-byte aligned); 0 where the route is not taken (T < 2 L).
// dtype 0 f32, 1 bf16.
extern "C" long long rwkv6_chunked_scratch_bytes(int dtype, int B, int T,
                                                 int H, int N) {
  if (T < 2 * L) return 0;
  const long long rec = dtype == 0 ? record_bytes<float>(N)
                                   : record_bytes<__nv_bfloat16>(N);
  return static_cast<long long>(B) * H * ((T + L - 1) / L) * rec;
}

// o (B, T, H, N) and s_out (B, H, N, N), f32, <- the WKV recurrence of r,
// k, v (dtype 0 f32, 1 bf16), logw (f32) and u (H, N) f32 from s0 (f32, or
// null for a zero state) on `stream`.  Every tensor is contiguous; N is 16,
// 32 or 64.  `scratch`: `rwkv6_chunked_scratch_bytes` (non-zero only at T
// >= 2 L), or null.  The route is chunked when `scratch` is given and
// `chunked_possible`, else step; it is written to *route (1
// chunked, 0 step).  Returns the CUDA error of the launches (0 on
// success); never synchronises.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* logw, const float* u,
                                 const float* s0, float* o, float* s_out,
                                 int dtype, int B, int T, int H, int N,
                                 void* scratch, void* stream, int* route) {
  const bool chunked = T >= 2 * L && scratch != nullptr &&
                       aligned16(scratch) &&
                       chunked_possible(r, k, v, logw, o, N);
  *route = chunked ? 1 : 0;
  if (B <= 0 || H <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  void* a = chunked ? scratch : nullptr;
  if (dtype == 0) {
    const Params<float> p{static_cast<const float*>(r),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v), logw, u, s0, o,
                          s_out, T, H};
    return dispatch<float>(p, B, N, a, s);
  }
  if (dtype == 1) {
    const Params<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(r),
                                  static_cast<const __nv_bfloat16*>(k),
                                  static_cast<const __nv_bfloat16*>(v), logw,
                                  u, s0, o, s_out, T, H};
    return dispatch<__nv_bfloat16>(p, B, N, a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
