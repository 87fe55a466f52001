// RG-LRU recurrence (RecurrentGemma's recurrent block), for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.rglru_scan.rglru_scan` of the JAX
// package (def at rglru_scan.py:57, pallas_call at :71).  For the conv
// output u (B, T, W) and the per-channel gate parameters w_r, b_r, w_i,
// b_i, lam (W,) f32, with every gate in f32 as `_gates` computes it:
//   r_t = sigmoid(u_t w_r + b_r),  i_t = sigmoid(u_t w_i + b_i)
//   log a_t = -8 softplus(lam) r_t,  a_t = exp(log a_t)
//   b_t = sqrt(max(1 - exp(2 log a_t), 1e-12)) (i_t u_t)
//   h_t = a_t h_{t-1} + b_t
// from h_0 = h0 (B, W) (zero when none is given), writing h (B, T, W) f32
// and the final state h_last (B, W) f32.  The Pallas kernel starts from
// zero and returns h only; the model needs both ends of the state, so the
// port's kernel takes and returns them (the same function the JAX model's
// associative scan and `rglru_step` compute, in another summation order).
//
// Layout: one thread per (batch row, channel), consecutive threads on
// consecutive channels, so each time step's u and h rows are read and
// written as whole coalesced lines.  The five gate parameters and
// -8 softplus(lam) (stable for any lam: max(x, 0) + log1p(exp(-|x|))) sit
// in registers.  The loop over t is unrolled by kUnroll: the u loads and
// the gate arithmetic of those steps do not depend on h, so they are in
// flight while the one dependent FMA chain h = a h + b runs.  u is read
// in its own type (bf16 or f32) through its (batch, time) strides and
// converted in registers: no host-side copy.
//
// What bounds it on this card: bytes.  Each u element is read once and
// each h element written once (f32): at B = 1, T = 1024, W = 4096 that is
// 8.4 MB of bf16 u and 16.8 MB of h, ~7.5 us at 3.35 TB/s; the gates are
// ~30 flops an element.  At B = 1 this design fills only W / 128 = 32
// CTAs of 128 threads on 132 SMs, and each thread walks all T steps: a
// chunked two-pass scan over time (chunk-local scans with a zero start,
// then a pass that carries each chunk's start state through its cumulative
// decay) would fill the card and is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr float kC = 8.0f;              // C_RGLRU

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Gates {
  float wr, br, wi, bi, neg_c_sp;       // neg_c_sp = -8 softplus(lam)

  __device__ float step(float u, float h) const {
    const float r = 1.f / (1.f + expf(-(u * wr + br)));
    const float i = 1.f / (1.f + expf(-(u * wi + bi)));
    const float log_a = neg_c_sp * r;
    const float a = expf(log_a);
    const float b = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (i * u);
    return fmaf(a, h, b);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ u, long long usb, long long ust,
             const float* __restrict__ w_r, const float* __restrict__ b_r,
             const float* __restrict__ w_i, const float* __restrict__ b_i,
             const float* __restrict__ lam, const float* __restrict__ h0,
             float* __restrict__ h, float* __restrict__ h_last, int T_,
             int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  const float l = lam[c];
  const Gates g{w_r[c], b_r[c], w_i[c], b_i[c],
                -kC * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))))};
  float hv = h0 != nullptr ? h0[static_cast<long long>(b) * W + c] : 0.f;
  const T* up = u + b * usb + c;
  float* hp = h + static_cast<long long>(b) * T_ * W + c;

  int t = 0;
  for (; t + kUnroll <= T_; t += kUnroll) {
    float uv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) uv[j] = to_f32(up[(t + j) * ust]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      hv = g.step(uv[j], hv);
      hp[static_cast<long long>(t + j) * W] = hv;
    }
  }
  for (; t < T_; ++t) {
    hv = g.step(to_f32(up[t * ust]), hv);
    hp[static_cast<long long>(t) * W] = hv;
  }
  h_last[static_cast<long long>(b) * W + c] = hv;
}

template <typename T>
int launch(const void* u, int B, int T_, int W, long long usb,
           long long ust, const float* const* params, const float* h0,
           float* h, float* h_last, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), usb, ust, params[0], params[1], params[2],
      params[3], params[4], h0, h, h_last, T_, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h (B, T, W) and h_last (B, W), both f32 and contiguous, <- the RG-LRU
// scan of u on `stream`.  u's last dimension is contiguous; `usb`/`ust`
// are its batch and time strides in elements.  `params` holds the five
// (W,) f32 gate vectors w_r, b_r, w_i, b_i, lam; h0 (B, W) f32 contiguous,
// or null for a zero start.  dtype: 0 f32, 1 bf16.  Returns the CUDA error
// of the launch (0 on success); never synchronises.
extern "C" int rglru_scan_launch(const void* u, int dtype, int B, int T,
                                 int W, long long usb, long long ust,
                                 const float* const* params,
                                 const float* h0, float* h, float* h_last,
                                 void* stream) {
  if (B <= 0 || W <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, B, T, W, usb, ust, params, h0, h, h_last, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, B, T, W, usb, ust, params, h0, h,
                                 h_last, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
