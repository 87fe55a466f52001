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
// reads no weights and writes exact zeros: the CTA reads its count first
// and returns, Hopper's form of the Pallas index-map redirect + pl.when.
//
// Layout: one CTA per (64-column output tile, expert), 128 threads, holding
// all C rows of its expert (in passes of up to 32 rows), so every weight
// element is read from device memory once a pass: with C <= 32, as on the
// model path (8 rows at a batch-8 decode step, at most 32 for a 1,500-token
// prefill), the kernel moves the bytes of its bound.  The contraction runs
// in 32-deep steps: the A rows (x or h) and the weight tile(s) are read
// with 16-byte loads along their contiguous axis into shared memory as f32;
// each thread accumulates RT rows x 4 columns (twice when gated) in
// registers.  Ragged C, D and F are masked: no divisibility is assumed.
// Offsets are 64-bit (E D F is 4.46e9 elements at arctic-480b's width).
//
// What bounds it on this card: bytes at a decode step (E D F weight
// elements of the live experts at 3.35 TB/s, 2 C = 16 flops a weight
// element), and, as written, its own f32 FMAs on the CUDA cores at a
// prefill: 6 C D F E flops at C = 24 take 9.6 ms at the 67 TFLOP/s f32
// rate against 8 ms for the bytes.  Tensor cores (wgmma on TMA-fed bf16
// tiles) and a pipelined load are the later fix.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_io.cuh"

namespace {

using attn::IO;

constexpr int kThreads = 128;
constexpr int kBN = 64;                              // output columns a CTA
constexpr int kBK = 32;                              // contraction step
constexpr int kColGroups = kBN / 4;                  // 4 columns a thread
constexpr int kRowGroups = kThreads / kColGroups;    // 8: a thread's rows
                                                     // are 8 apart
constexpr int kLdA = kBK + 4;                        // padded tile rows
constexpr int kLdW = kBN + 4;                        // (floats, 16B-aligned)

enum Epilogue { kSiluGate = 0, kGelu = 1, kNone = 2 };

template <typename T>
struct Stage {
  const T* a;          // (E, C, K) rows: x, or h
  const T* w1;         // (E, K, N): wg, or wo
  const T* w2;         // (E, K, N): wi when gated, else unused
  const int* counts;   // (E,) or null (every expert live)
  T* out;              // (E, C, N): h, or the output
  int C, K, N;
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
__global__ void __launch_bounds__(kThreads) moe_gmm_kernel(Stage<T> s) {
  gmm_tile<T, RT, EPI>(s);
}

template <typename T, int RT, int EPI>
__global__ void __launch_bounds__(kThreads) moe_gmm_skip_kernel(Stage<T> s) {
  gmm_tile<T, RT, EPI>(s);
}

template <typename T, int RT, int EPI>
cudaError_t launch(const Stage<T>& s, int E, cudaStream_t stream) {
  const dim3 grid((s.N + kBN - 1) / kBN, E);
  if (s.counts != nullptr)
    moe_gmm_skip_kernel<T, RT, EPI><<<grid, kThreads, 0, stream>>>(s);
  else
    moe_gmm_kernel<T, RT, EPI><<<grid, kThreads, 0, stream>>>(s);
  return cudaGetLastError();
}

// Rows a thread: the fewest that cover C in one pass, at most 4 (32 rows).
template <typename T, int EPI>
cudaError_t by_rows(const Stage<T>& s, int E, cudaStream_t stream) {
  if (s.C <= kRowGroups) return launch<T, 1, EPI>(s, E, stream);
  if (s.C <= 2 * kRowGroups) return launch<T, 2, EPI>(s, E, stream);
  if (s.C <= 3 * kRowGroups) return launch<T, 3, EPI>(s, E, stream);
  return launch<T, 4, EPI>(s, E, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int run(const void* x, const void* wg, const void* wi, const void* wo,
        const int* counts, void* h, void* out, int E, int C, int D, int F,
        bool gated, cudaStream_t stream) {
  constexpr int V = IO<T>::kVec;
  const T* tx = static_cast<const T*>(x);
  const T* twg = static_cast<const T*>(wg);
  const T* twi = gated ? static_cast<const T*>(wi) : nullptr;
  T* th = static_cast<T*>(h);
  const Stage<T> a{tx, twg, twi, counts, th, C, D, F,
                   aligned16(x) && D % V == 0,
                   aligned16(wg) && (!gated || aligned16(wi)) && F % V == 0,
                   aligned16(h) && F % 4 == 0};
  const cudaError_t err = gated ? by_rows<T, kSiluGate>(a, E, stream)
                                : by_rows<T, kGelu>(a, E, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Stage<T> b{th, static_cast<const T*>(wo), nullptr, counts,
                   static_cast<T*>(out), C, F, D,
                   aligned16(h) && F % V == 0, aligned16(wo) && D % V == 0,
                   aligned16(out) && D % 4 == 0};
  return static_cast<int>(by_rows<T, kNone>(b, E, stream));
}

}  // namespace

// out (E, C, D) <- the grouped expert FFN of x (E, C, D) through wg, wi
// (E, D, F) and wo (E, F, D), on `stream`, using h (E, C, F) as the
// intermediate; all contiguous, of one dtype (0 f32, 1 bf16).  `counts`
// (E,) int32, or null for every expert live.  `gated` 0 reads no wi.
// Returns the CUDA error of the launches (0 on success); never
// synchronises.
extern "C" int moe_gmm_launch(const void* x, const void* wg, const void* wi,
                              const void* wo, const int* counts, void* h,
                              void* out, int dtype, int E, int C, int D,
                              int F, int gated, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0) return 0;
  if (F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, wg, wi, wo, counts, h, out, E, C, D, F, gated != 0,
                      s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, wg, wi, wo, counts, h, out, E, C, D, F,
                              gated != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
