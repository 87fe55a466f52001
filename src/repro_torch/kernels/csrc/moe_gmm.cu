// Grouped expert FFN, the MoE layer's expert compute, for Hopper (sm_90a).
//
// Replaces the TPU kernels `repro.kernels.moe_gmm.moe_gmm` (def at
// moe_gmm.py:187, pallas_calls at :198 and :214) and `moe_gmm_skip` (def at
// :127, pallas_calls at :142 and :164) of the JAX package.  For x (E, C, D),
// wg/wi (E, D, F) and wo (E, F, D), two launches, as the two pallas_calls:
//   stage A  h[e] = silu(x[e] @ wg[e]) * (x[e] @ wi[e])   (gated), or
//            h[e] = gelu_tanh(x[e] @ wg[e])                (ungated; wi is
//            not read), accumulated in f32 and stored in x's type, as the
//            Pallas kernel's h_ref is;
//   stage B  out[e] = h[e] @ wo[e], accumulated in f32, stored in x's type.
// With `counts` (E,) (the skip entry point), an expert with counts[e] <= 0
// reads no weights and writes exact zeros: the kernel reads the counts on
// the device, Hopper's form of the Pallas index-map redirect + pl.when.
//
// What bounds it on this card: bytes.  Every weight element of a live
// expert is read once (E D F elements a matrix, 26.8 GB for arctic-480b's
// 128 experts at a prefill, 3.3 GB for 16 live at a decode step) and does
// 2 C flops, C <= 32 on the model path: at most 32 flops a byte, far below
// the 295 bf16 flops a byte where the tensor cores would set the pace.
// So the design keeps HBM streaming and keeps the products off the CUDA
// cores' f32 rate (67 TFLOP/s: 9.6 ms at C 24, more than the 8 ms of the
// bytes).
//
// bf16 route (`moe_gmm_kernel_mma`, `moe_gmm_skip_kernel_mma`), taken when
// D and F are multiples of 8 and every operand is 16-byte aligned:
// * Work items.  An item is (expert, 128-column output tile), 256 threads
//   (8 warps) a CTA, 2 CTAs an SM.  Without counts the grid has one CTA
//   an item and the block scheduler balances them as CTAs finish.  With
//   counts the kernel is persistent (`blocks an SM x SMs` CTAs, CTA b
//   taking items b, b + grid, ...): each CTA first orders the experts
//   live first (a ballot scan of the counts into shared memory), so the
//   live items spread evenly over the CTAs and a dead expert costs a
//   zero-store of its tile, not a CTA launch.
// * Weight stream.  The item's weight columns (both wg and wi when gated,
//   so x is read once for the two) stream as bf16 through a ring of
//   32-deep k stages in shared memory with 16-byte cp.async copies that
//   ask L2 for the 256-byte block around each (a row's 256 bytes a tile),
//   with the matching 32-wide slice of the item's token rows (from L2):
//   4 stages gated, 7 ungated, so ~48 KB of weights are in flight per CTA
//   and ~96 KB per SM at every moment, enough to cover HBM's latency at
//   3.35 TB/s.  Rows padded 16 bytes: ldmatrix is conflict-free.
// * Products on the tensor cores, A and B swapped: h^T = W^T x^T, so the
//   item's 128 weight columns are the M side (one m16 tile a warp, read
//   with ldmatrix.trans from the column-contiguous [k][n] tile) and the
//   C <= 32 tokens the N side (1-4 n8 tiles, read with ldmatrix from the
//   [token][k] rows): mma.sync m16n8k16 bf16 -> f32, whose products are
//   exact.  Two-level sums: each 32-deep stage's products sum in the
//   tensor cores from a zeroed fragment, which then joins the f32
//   accumulators with one round-to-nearest add.  (Summed in the tensor
//   cores over all of K, whose additions do not round to nearest, many
//   more bf16 outputs landed a rounding away from the plain version's,
//   and arctic's kernel-vs-plain check flipped a near-tied route.)  C > 32
//   runs in passes of 32 rows, each streaming the weights again (off the
//   model path).
// * Epilogue in registers: silu(g) * i (or gelu_tanh(g)), rounded to
//   bf16, staged through shared memory to 16-byte stores of 8 columns.
// Its times beside the bound and three torch.bmm are in PERF.md (PR 16);
// in development runs 64-column tiles, deeper or shallower rings, a
// dynamic work queue, 256-column items for stage B, and TMA (1-D bulk
// copies of each row, or 2-D 128-byte-swizzled boxes into a deep ring at
// one CTA an SM) were no faster.
//
// f32 route (`moe_gmm_kernel_fma`, `moe_gmm_skip_kernel_fma`), for f32
// operands (TF32 tensor cores would not hold the f32 tolerance of 2e-5)
// and for bf16 rows that are not 16-byte aligned: one CTA per (64-column
// tile, expert), 128 threads, all C rows (in passes of up to 32); the
// tiles go to shared memory as f32 with 16-byte loads in 32-deep steps,
// unpipelined, and each thread accumulates RT rows x 4 columns (twice when
// gated) with f32 FMAs on the CUDA cores.
//
// Both routes: ragged C, D and F are masked (no divisibility beyond the
// bf16 route's multiple of 8 is assumed) and offsets are 64-bit (E D F is
// 4.46e9 elements at arctic-480b's width).  The route is chosen in the C
// entry point from the dtype, the shapes and the alignment only, and
// reported to the caller.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_io.cuh"
#include "mma_sync.cuh"

namespace {

using attn::IO;
using bf16 = __nv_bfloat16;

constexpr int kBK = 32;                              // contraction step

enum Epilogue { kSiluGate = 0, kGelu = 1, kNone = 2 };

template <typename T>
struct Stage {
  const T* a;          // (E, C, K) rows: x, or h
  const T* w1;         // (E, K, N): wg, or wo
  const T* w2;         // (E, K, N): wi when gated, else unused
  const int* counts;   // (E,) or null (every expert live)
  T* out;              // (E, C, N): h, or the output
  int E, C, K, N;
  bool vec_a, vec_w;   // 16-byte loads along the rows of a / w1, w2
  bool vec_o;          // 4-wide stores along the rows of out
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default, the tanh approximation
  const float k = 0.7978845608028654f;               // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

template <int EPI>
__device__ __forceinline__ float epilogue(float g, float i) {
  if (EPI == kSiluGate) return g / (1.f + expf(-g)) * i;
  if (EPI == kGelu) return gelu_tanh(g);
  return g;
}

// ---------------------------------------------------------------------------
// f32 route: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 128;
constexpr int kBN = 64;                              // output columns a CTA
constexpr int kColGroups = kBN / 4;                  // 4 columns a thread
constexpr int kRowGroups = kThreads / kColGroups;    // 8: a thread's rows
                                                     // are 8 apart
constexpr int kLdA = kBK + 4;                        // padded tile rows
constexpr int kLdW = kBN + 4;                        // (floats, 16B-aligned)

// tile[r * LD + c] = src[(row0 + r) * ld + col0 + c] as f32, for r < ROWS
// and c < COLS; zero where row0 + r >= rows or col0 + c >= cols.  Every
// thread of the CTA takes part.
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(float* tile, const T* src, int ld,
                                          int row0, int rows, int col0,
                                          int cols, bool vec) {
  constexpr int V = IO<T>::kVec;
  constexpr int kChunks = COLS / V;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    const int gr = row0 + r, gc = col0 + c;
    const T* p = src + static_cast<long long>(gr) * ld + gc;
    float v[V];
    if (gr < rows && vec && gc + V <= cols) {
      IO<T>::load(p, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = gr < rows && gc + j < cols ? IO<T>::load1(p + j) : 0.f;
    }
    float* dst = tile + r * LD + c;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
}

// One CTA's work: columns n0 .. n0 + 63 of out[e] for every row, RT rows
// a thread (8 RT rows a pass).
template <typename T, int RT, int EPI>
__device__ __forceinline__ void gmm_tile(const Stage<T>& s) {
  constexpr int kBR = kRowGroups * RT;
  constexpr bool kTwo = EPI == kSiluGate;
  __shared__ __align__(16) float As[kBR * kLdA];
  __shared__ __align__(16) float W1s[kBK * kLdW];
  __shared__ __align__(16) float W2s[kTwo ? kBK * kLdW : 4];
  const int e = blockIdx.y, n0 = blockIdx.x * kBN;
  const int cg = threadIdx.x % kColGroups, rg = threadIdx.x / kColGroups;
  const long long eo = e;
  T* out = s.out + eo * s.C * s.N;

  if (s.counts != nullptr && s.counts[e] <= 0) {   // empty: zeros, no read
    for (int i = threadIdx.x; i < s.C * kBN; i += kThreads) {
      const int r = i / kBN, c = n0 + i % kBN;
      if (c < s.N) IO<T>::store1(out + static_cast<long long>(r) * s.N + c,
                                 0.f);
    }
    return;
  }
  const T* a = s.a + eo * s.C * s.K;
  const T* w1 = s.w1 + eo * s.K * s.N;
  const T* w2 = kTwo ? s.w2 + eo * s.K * s.N : nullptr;

  for (int r0 = 0; r0 < s.C; r0 += kBR) {
    float acc1[RT][4], acc2[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < s.K; k0 += kBK) {
      __syncthreads();                  // the previous step's tiles are used
      load_tile<T, kBR, kBK, kLdA>(As, a, s.K, r0, s.C, k0, s.K, s.vec_a);
      load_tile<T, kBK, kBN, kLdW>(W1s, w1, s.N, k0, s.K, n0, s.N, s.vec_w);
      if (kTwo)
        load_tile<T, kBK, kBN, kLdW>(W2s, w2, s.N, k0, s.K, n0, s.N,
                                     s.vec_w);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 b1 =
            *reinterpret_cast<const float4*>(W1s + k * kLdW + 4 * cg);
        float4 b2 = b1;
        if (kTwo) b2 = *reinterpret_cast<const float4*>(W2s + k * kLdW +
                                                         4 * cg);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float av = As[(rg + kRowGroups * i) * kLdA + k];
          acc1[i][0] = fmaf(av, b1.x, acc1[i][0]);
          acc1[i][1] = fmaf(av, b1.y, acc1[i][1]);
          acc1[i][2] = fmaf(av, b1.z, acc1[i][2]);
          acc1[i][3] = fmaf(av, b1.w, acc1[i][3]);
          if (kTwo) {
            acc2[i][0] = fmaf(av, b2.x, acc2[i][0]);
            acc2[i][1] = fmaf(av, b2.y, acc2[i][1]);
            acc2[i][2] = fmaf(av, b2.z, acc2[i][2]);
            acc2[i][3] = fmaf(av, b2.w, acc2[i][3]);
          }
        }
      }
    }
    const int c = n0 + 4 * cg;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = r0 + rg + kRowGroups * i;
      if (r >= s.C || c >= s.N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = epilogue<EPI>(acc1[i][j], acc2[i][j]);
      T* o = out + static_cast<long long>(r) * s.N + c;
      if (s.vec_o && c + 4 <= s.N) {
        IO<T>::store4(o, v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && c + j < s.N; ++j) IO<T>::store1(o + j, v[j]);
      }
    }
  }
}

// Two names for one body, so that a profile tells the entry points apart.
template <typename T, int RT, int EPI>
__global__ void __launch_bounds__(kThreads) moe_gmm_kernel_fma(Stage<T> s) {
  gmm_tile<T, RT, EPI>(s);
}

template <typename T, int RT, int EPI>
__global__ void __launch_bounds__(kThreads)
moe_gmm_skip_kernel_fma(Stage<T> s) {
  gmm_tile<T, RT, EPI>(s);
}

template <typename T, int RT, int EPI>
cudaError_t launch(const Stage<T>& s, cudaStream_t stream) {
  const dim3 grid((s.N + kBN - 1) / kBN, s.E);
  if (s.counts != nullptr)
    moe_gmm_skip_kernel_fma<T, RT, EPI><<<grid, kThreads, 0, stream>>>(s);
  else
    moe_gmm_kernel_fma<T, RT, EPI><<<grid, kThreads, 0, stream>>>(s);
  return cudaGetLastError();
}

// Rows a thread: the fewest that cover C in one pass, at most 4 (32 rows).
template <typename T, int EPI>
cudaError_t by_rows(const Stage<T>& s, cudaStream_t stream) {
  if (s.C <= kRowGroups) return launch<T, 1, EPI>(s, stream);
  if (s.C <= 2 * kRowGroups) return launch<T, 2, EPI>(s, stream);
  if (s.C <= 3 * kRowGroups) return launch<T, 3, EPI>(s, stream);
  return launch<T, 4, EPI>(s, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 route: mma.sync on a pipelined bf16 weight stream
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;           // 8 warps, one m16 tile each
constexpr int kBN = 128;                // weight columns an item
constexpr int kLdW = kBN + 8;           // weight tile rows (bf16, +16 B)
constexpr int kLdX = kBK + 8;           // token tile rows
constexpr int kMaxExperts = 1024;       // the skip's expert order in smem

// Shared memory of one CTA: the ring of `kStages` stages (the weight
// tile(s), then 8 NT token rows), the output staging tile, and with
// counts the expert order.
template <int NT, bool TWO>
struct Cfg {
  static constexpr int kStages = TWO ? 4 : 7;
  static constexpr int kWElems = kBK * kLdW;
  static constexpr int kStageElems = (TWO ? 2 : 1) * kWElems + 8 * NT * kLdX;
  static constexpr int kOutElems = 8 * NT * kLdW;
  static constexpr size_t kBytes =
      2 * static_cast<size_t>(kStages * kStageElems + kOutElems);
  static size_t bytes(int order) { return kBytes + sizeof(int) * order; }
};

// Orders the E experts live first into `order` (live ascending, then the
// dead descending) and returns how many are live.  Every thread takes
// part, and every thread gets the count.
__device__ int order_experts(const int* counts, int E, int* order) {
  __shared__ int warp_live[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int live_before = 0;                  // live experts below this round
  for (int base = 0; base < E; base += kThreads) {
    const int e = base + tid;
    const bool live = e < E && counts[e] > 0;
    const unsigned ball = __ballot_sync(attn::kFull, live);
    if (lane == 0) warp_live[warp] = __popc(ball);
    __syncthreads();
    int before = live_before + __popc(ball & ((1u << lane) - 1u)), round = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before += warp_live[w];
      round += warp_live[w];
    }
    if (e < E) order[live ? before : E - 1 - (e - before)] = e;
    live_before += round;
    __syncthreads();                    // warp_live is rewritten
  }
  __syncthreads();                      // the order is complete
  return live_before;
}

// Columns n0 .. n0 + 63 of out[e], token rows r0 .. r0 + 8 NT - 1: the
// pipelined k loop and the epilogue.
template <int NT, int EPI>
__device__ __forceinline__ void gmm_pass(const Stage<bf16>& s, int e, int n0,
                                         int r0, bf16* ring, bf16* outs) {
  constexpr bool kTwo = EPI == kSiluGate;
  using C = Cfg<NT, kTwo>;
  constexpr int S = C::kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long eo = e;
  const bf16* a = s.a + eo * s.C * s.K;
  const bf16* w1 = s.w1 + eo * s.K * s.N;
  const bf16* w2 = kTwo ? s.w2 + eo * s.K * s.N : nullptr;
  const int nk = (s.K + kBK - 1) / kBK;

  // stage kt into ring slot `slot`: kBK rows x 64 columns of each weight,
  // 8 NT token rows x kBK; zeros past K, N and C (nothing read there)
  auto load = [&](int kt, int slot) {
    bf16* st = ring + slot * C::kStageElems;
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const bool ok = k0 + r < s.K && n0 + c < s.N;
      const long long off = ok ? static_cast<long long>(k0 + r) * s.N + n0 + c
                               : 0;
      cp_async16_l2_256(st + r * kLdW + c, w1 + off, ok);
      if (kTwo)
        cp_async16_l2_256(st + C::kWElems + r * kLdW + c, w2 + off, ok);
    }
    bf16* xs = st + (kTwo ? 2 : 1) * C::kWElems;
    for (int i = tid; i < 8 * NT * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = r0 + r < s.C && k0 + c < s.K;
      const long long off =
          ok ? static_cast<long long>(r0 + r) * s.K + k0 + c : 0;
      cp_async16_l2_256(xs + r * kLdX + c, a + off, ok);
    }
  };

  float acc1[NT][4], acc2[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) acc1[j][u] = acc2[j][u] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) load(t, t);
    cp_async_commit();
  }
  // this lane's ldmatrix rows: the weight tile's k row and column (A,
  // transposed), the token tile's row and k column (B)
  const int a_row = (lane & 7) + (lane >> 4) * 8;
  const int a_col = 16 * warp + ((lane >> 3) & 1) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();             // stage kt has landed
    __syncthreads();                    // ... for every thread; slot kt - 1
                                        // is free
    if (kt + S - 1 < nk) load(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();
    const bf16* W1 = ring + (kt % S) * C::kStageElems;
    const bf16* W2 = W1 + C::kWElems;
    const bf16* X = W1 + (kTwo ? 2 : 1) * C::kWElems;
    // the stage's products sum in the tensor cores from zero, then join
    // the f32 accumulators with one rounded add (see the header)
    float p1[NT][4], p2[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) p1[j][u] = p2[j][u] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a1[4], a2[4];
      ldmatrix_x4_trans(a1, W1 + (16 * kk + a_row) * kLdW + a_col);
      if (kTwo) ldmatrix_x4_trans(a2, W2 + (16 * kk + a_row) * kLdW + a_col);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j + 1 < NT) {
          uint32_t b[4];
          ldmatrix_x4(b, X + (8 * j + b_row) * kLdX + 16 * kk + b_col);
          mma_bf16(p1[j], a1, b[0], b[1]);
          mma_bf16(p1[j + 1], a1, b[2], b[3]);
          if (kTwo) {
            mma_bf16(p2[j], a2, b[0], b[1]);
            mma_bf16(p2[j + 1], a2, b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          ldmatrix_x2(b, X + (8 * j + (lane & 7)) * kLdX + 16 * kk + b_col);
          mma_bf16(p1[j], a1, b[0], b[1]);
          if (kTwo) mma_bf16(p2[j], a2, b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc1[j][u] += p1[j][u];
        if (kTwo) acc2[j][u] += p2[j][u];
      }
    }
  }
  cp_async_wait<0>();                   // only empty groups are left

  // epilogue: acc[j][u] is column 16 warp + lane / 4 (+ 8 for u >= 2) of
  // token row 8 j + 2 (lane % 4) (+ 1 for odd u); staged as bf16 rows
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      outs[(8 * j + 2 * q + (u & 1)) * kLdW + 16 * warp + g + 8 * (u >> 1)] =
          __float2bfloat16_rn(epilogue<EPI>(acc1[j][u], acc2[j][u]));
    }
  }
  __syncthreads();                      // the tile is staged; the ring free
  bf16* out = s.out + eo * s.C * s.N;
  for (int i = tid; i < 8 * NT * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    if (r0 + r < s.C && n0 + c < s.N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(r0 + r) * s.N +
                                n0 + c) =
          *reinterpret_cast<const uint4*>(outs + r * kLdW + c);
  }
  __syncthreads();                      // outs is rewritten by the next pass
}

template <int NT, int EPI>
__device__ __forceinline__ void gmm_items(const Stage<bf16>& s) {
  extern __shared__ float4 smem4[];
  using C = Cfg<NT, EPI == kSiluGate>;
  bf16* ring = reinterpret_cast<bf16*>(smem4);
  bf16* outs = ring + C::kStages * C::kStageElems;
  int* order = reinterpret_cast<int*>(outs + C::kOutElems);
  const int tiles = (s.N + kBN - 1) / kBN;
  const int n_live =
      s.counts != nullptr ? order_experts(s.counts, s.E, order) : s.E;
  const long long live_items = static_cast<long long>(n_live) * tiles;
  const long long items = static_cast<long long>(s.E) * tiles;
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const int slot = static_cast<int>(i / tiles);
    const int n0 = static_cast<int>(i % tiles) * kBN;
    const int e = s.counts != nullptr ? order[slot] : slot;
    if (i >= live_items) {              // a dead expert: zeros, no read
      bf16* out = s.out + static_cast<long long>(e) * s.C * s.N;
      for (int j = threadIdx.x; j < s.C * (kBN / 8); j += kThreads) {
        const int r = j / (kBN / 8), c = n0 + (j % (kBN / 8)) * 8;
        if (c < s.N)
          *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * s.N +
                                    c) = make_uint4(0, 0, 0, 0);
      }
      continue;
    }
    for (int r0 = 0; r0 < s.C; r0 += 8 * NT)
      gmm_pass<NT, EPI>(s, e, n0, r0, ring, outs);
  }
}

// Two names for one body, so that a profile tells the entry points apart.
template <int NT, int EPI>
__global__ void __launch_bounds__(kThreads, 2) moe_gmm_kernel_mma(
    Stage<bf16> s) {
  gmm_items<NT, EPI>(s);
}

template <int NT, int EPI>
__global__ void __launch_bounds__(kThreads, 2) moe_gmm_skip_kernel_mma(
    Stage<bf16> s) {
  gmm_items<NT, EPI>(s);
}

template <int NT, int EPI>
cudaError_t launch(const Stage<bf16>& s, cudaStream_t stream) {
  void (*kernel)(Stage<bf16>) = moe_gmm_kernel_mma<NT, EPI>;
  if (s.counts != nullptr) kernel = moe_gmm_skip_kernel_mma<NT, EPI>;
  const size_t smem =
      Cfg<NT, EPI == kSiluGate>::bytes(s.counts != nullptr ? s.E : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent with counts (a dead expert costs a zero-store, not a CTA);
  // without, one CTA an item, balanced by the block scheduler as CTAs end
  const long long items =
      static_cast<long long>(s.E) * ((s.N + kBN - 1) / kBN);
  const long long cap =
      s.counts != nullptr ? static_cast<long long>(per_sm) * sms : items;
  const int grid = static_cast<int>(items < cap ? items : cap);
  kernel<<<grid, kThreads, smem, stream>>>(s);
  return cudaGetLastError();
}

// Token tiles a pass: the fewest n8 tiles that cover C, at most 4.
template <int EPI>
cudaError_t by_rows(const Stage<bf16>& s, cudaStream_t stream) {
  if (s.C <= 8) return launch<1, EPI>(s, stream);
  if (s.C <= 16) return launch<2, EPI>(s, stream);
  if (s.C <= 24) return launch<3, EPI>(s, stream);
  return launch<4, EPI>(s, stream);
}

}  // namespace tc

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int run_fma(const void* x, const void* wg, const void* wi, const void* wo,
            const int* counts, void* h, void* out, int E, int C, int D,
            int F, bool gated, cudaStream_t stream) {
  constexpr int V = IO<T>::kVec;
  const T* tx = static_cast<const T*>(x);
  const T* twg = static_cast<const T*>(wg);
  const T* twi = gated ? static_cast<const T*>(wi) : nullptr;
  T* th = static_cast<T*>(h);
  const Stage<T> a{tx, twg, twi, counts, th, E, C, D, F,
                   aligned16(x) && D % V == 0,
                   aligned16(wg) && (!gated || aligned16(wi)) && F % V == 0,
                   aligned16(h) && F % 4 == 0};
  const cudaError_t err = gated ? simt::by_rows<T, kSiluGate>(a, stream)
                                : simt::by_rows<T, kGelu>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Stage<T> b{th, static_cast<const T*>(wo), nullptr, counts,
                   static_cast<T*>(out), E, C, F, D,
                   aligned16(h) && F % V == 0, aligned16(wo) && D % V == 0,
                   aligned16(out) && D % 4 == 0};
  return static_cast<int>(simt::by_rows<T, kNone>(b, stream));
}

int run_mma(const void* x, const void* wg, const void* wi, const void* wo,
            const int* counts, void* h, void* out, int E, int C, int D,
            int F, bool gated, cudaStream_t stream) {
  bf16* th = static_cast<bf16*>(h);
  const Stage<bf16> a{static_cast<const bf16*>(x),
                      static_cast<const bf16*>(wg),
                      gated ? static_cast<const bf16*>(wi) : nullptr,
                      counts, th, E, C, D, F, true, true, true};
  const cudaError_t err = gated ? tc::by_rows<kSiluGate>(a, stream)
                                : tc::by_rows<kGelu>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Stage<bf16> b{th, static_cast<const bf16*>(wo), nullptr, counts,
                      static_cast<bf16*>(out), E, C, F, D, true, true, true};
  return static_cast<int>(tc::by_rows<kNone>(b, stream));
}

// Whether these operands take the bf16 tensor-core route: bf16, D and F
// multiples of 8, every pointer 16-byte aligned, and with counts at most
// 1024 experts; the f32 FMA route takes the rest.
bool tensor_core_route(const void* x, const void* wg, const void* wi,
                       const void* wo, const int* counts, const void* h,
                       const void* out, int dtype, int E, int D, int F,
                       int gated) {
  return dtype == 1 && D % 8 == 0 && F % 8 == 0 && aligned16(x) &&
         aligned16(wg) && (gated == 0 || aligned16(wi)) && aligned16(wo) &&
         aligned16(h) && aligned16(out) &&
         (counts == nullptr || E <= tc::kMaxExperts);
}

}  // namespace

// out (E, C, D) <- the grouped expert FFN of x (E, C, D) through wg, wi
// (E, D, F) and wo (E, F, D), on `stream`, using h (E, C, F) as the
// intermediate; all contiguous, of one dtype (0 f32, 1 bf16).  `counts`
// (E,) int32, or null for every expert live.  `gated` 0 reads no wi.
// Writes the route it takes to *route: 1 the bf16 tensor-core route, 0
// the f32 FMA route (`tensor_core_route`).  Returns the CUDA error of the
// launches (0 on success); never synchronises.
extern "C" int moe_gmm_launch(const void* x, const void* wg, const void* wi,
                              const void* wo, const int* counts, void* h,
                              void* out, int dtype, int E, int C, int D,
                              int F, int gated, void* stream, int* route) {
  *route = tensor_core_route(x, wg, wi, wo, counts, h, out, dtype, E, D, F,
                             gated);
  if (E <= 0 || C <= 0 || D <= 0) return 0;
  if (F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (*route == 1)
    return run_mma(x, wg, wi, wo, counts, h, out, E, C, D, F, gated != 0, s);
  if (dtype == 0)
    return run_fma<float>(x, wg, wi, wo, counts, h, out, E, C, D, F,
                          gated != 0, s);
  if (dtype == 1)
    return run_fma<bf16>(x, wg, wi, wo, counts, h, out, E, C, D, F,
                         gated != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
