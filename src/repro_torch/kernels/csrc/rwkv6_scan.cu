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
// Layout: one CTA per (head, batch row) with N threads; thread j owns the
// value column S[:, j], N f32 in registers, so the step needs no reduction
// between threads.  The inputs of kChunk time steps (thread j loads
// element j of r, k, v and logw of each) are staged in shared memory,
// double-buffered: the loads of the next chunk are in flight in registers
// while the current one is computed, and one barrier a chunk publishes
// them.  Every thread reads the staged r, k, exp(logw) of a step as
// broadcasts.  Instantiated for N = 16, 32 and 64.
//
// What bounds it on this card: at B = 1, T = 1024, H = 64, N = 64 it moves
// ~59 MB (four (T, H, N) inputs, o in f32, the state in and out), ~17.6
// us at 3.35 TB/s, and does ~4 N^2 f32 operations a token and head, ~1.07
// GFLOP, ~16 us at the 67 TFLOP/s of the CUDA cores.  As written it is
// bound by neither: each CTA walks all T steps alone, a step's dot product
// is a chain of N / 4 FMAs on each of four accumulators, and at B = 1 it
// fills 64 CTAs of 64 threads.  The chunked form on tensor cores (intra-
// chunk products as wgmma tiles, the state carried chunk to chunk) is
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;               // time steps staged a barrier

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

template <typename T, int N>
__global__ void __launch_bounds__(N) rwkv6_kernel(Params<T> p) {
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

template <typename T, int N>
int launch(const Params<T>& p, int B, cudaStream_t stream) {
  const dim3 grid(p.H, B);
  rwkv6_kernel<T, N><<<grid, N, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, float* o, float* s_out, int B,
             int T_, int H, int N, cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(r), static_cast<const T*>(k),
              static_cast<const T*>(v), logw, u, s0, o, s_out, T_, H};
  if (N == 16) return launch<T, 16>(p, B, stream);
  if (N == 32) return launch<T, 32>(p, B, stream);
  if (N == 64) return launch<T, 64>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// o (B, T, H, N) and s_out (B, H, N, N), f32, <- the WKV recurrence of r,
// k, v (dtype 0 f32, 1 bf16), logw (f32) and u (H, N) f32 from s0 (f32, or
// null for a zero state) on `stream`.  Every tensor is contiguous; N is 16,
// 32 or 64.  Returns the CUDA error of the launch (0 on success); never
// synchronises.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* logw, const float* u,
                                 const float* s0, float* o, float* s_out,
                                 int dtype, int B, int T, int H, int N,
                                 void* stream) {
  if (B <= 0 || H <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, logw, u, s0, o, s_out, B, T, H, N, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, B, T, H,
                                   N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
