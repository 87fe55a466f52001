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
// Every kernel runs one thread per (batch row, channel), consecutive
// threads on consecutive channels, so each time step's u and h rows are
// read and written as whole coalesced lines; the five gate parameters and
// -8 softplus(lam) (stable for any lam: max(x, 0) + log1p(exp(-|x|))) sit
// in registers; loops over t are unrolled by kUnroll, so the u loads and
// the gate arithmetic of those steps (which do not depend on h) are in
// flight while the one dependent FMA chain h = a h + b runs.  u is read in
// its own type (bf16 or f32) through its (batch, time) strides and
// converted in registers: no host-side copy.
//
// Two routes, chosen in the C entry point from the shapes alone and
// written back:
//
// * "chunked" (T > kChunk = 64: every prefill) scans chunks of 64 steps in
//   parallel, on a grid of (W / 128, B, chunks): 512 CTAs at B 1, T 1024,
//   W 4096.  Pass 1 (`rglru_kernel_chunk_aggregate`, every chunk but the
//   last) reads the chunk's u and writes only its aggregate, (A, B) with
//   A = prod a_t and B the chunk's scan from zero, to a (B, chunks - 1, W,
//   2) f32 scratch the wrapper allocates.  Pass 2 (`rglru_kernel_chunk_
//   scan`) carries h to the chunk's start through the aggregates before it
//   (h = A h + B, at most chunks - 1 FMAs a channel, the 0.5 MB of
//   aggregates read from L2: the three-pass form's carry pass folded into
//   the rescan, one launch fewer), then rescans the chunk from that true
//   start with the gates and the FMA chain of the step route, writing h;
//   the last chunk writes h_last.  Only the start state arrives through
//   composed aggregates, so the result stays within f32 rounding of the
//   sequential scan; a product of decays only underflows, never overflows
//   (no factor 1 / prod a appears).  The ragged tail is a shorter last
//   chunk.  (A one-pass scan with decoupled look-back, each chunk waiting
//   on the carry its predecessor publishes, reads u once but needs flags
//   and an in-order ticket across CTAs; not chosen for a first design.)
// * "step" (`rglru_kernel_step`, T <= 64, e.g. T 1 at decode): one thread
//   per (batch row, channel) walks all of T.
//
// What bounds it on this card: at B = 1, T = 1024, W = 4096 the function
// reads 8.4 MB of bf16 u and writes 16.8 MB of h (f32), ~7.5 us at 3.35
// TB/s; the gates are ~22 f32 operations an element, ~6 of them on the
// special function units (two sigmoids, two exponentials, a square root;
// 16 results a clock and SM), which at one pass over T take about as long
// as the bytes.  The chunked route reads u twice and computes the gates
// twice (pass 1 for the aggregates): ~34 MB and twice the special-function
// work, against the step route's 32 CTAs of 128 threads, which leave 100
// of 132 SMs empty at B = 1 and walk all of T one step at a time.  The
// decoupled look-back would save pass 1's gate work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr int kChunk = 64;              // steps a chunk (chunked route)
constexpr float kC = 8.0f;              // C_RGLRU

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Gates {
  float wr, br, wi, bi, neg_c_sp;       // neg_c_sp = -8 softplus(lam)

  __device__ Gates(const float* const* prm, int c) {
    const float l = prm[4][c];
    wr = prm[0][c];
    br = prm[1][c];
    wi = prm[2][c];
    bi = prm[3][c];
    neg_c_sp = -kC * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  }

  // a_t and b_t of one step
  __device__ float2 ab(float u) const {
    const float r = 1.f / (1.f + expf(-(u * wr + br)));
    const float i = 1.f / (1.f + expf(-(u * wi + bi)));
    const float log_a = neg_c_sp * r;
    const float a = expf(log_a);
    const float b = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (i * u);
    return make_float2(a, b);
  }
};

struct Args {
  const void* u;
  long long usb, ust;                   // u's batch and time strides
  const float* prm[5];                  // w_r, b_r, w_i, b_i, lam
  const float* h0;                      // (B, W) or null
  float* h;                             // (B, T, W)
  float* h_last;                        // (B, W)
  float2* agg;                          // (B, chunks - 1, W): (A, B)
  int T, W;
};

// Walk steps [t0, t1) of channel c from hv: with `write`, store each h_t;
// with `prod`, also multiply the decays into *prod.  Returns the last h.
template <typename T, bool kWrite, bool kProd>
__device__ __forceinline__ float walk(const Args& a, const Gates& g, int b,
                                      int c, int t0, int t1, float hv,
                                      float* prod) {
  const T* up = static_cast<const T*>(a.u) + b * a.usb + c;
  float* hp = a.h + static_cast<long long>(b) * a.T * a.W + c;
  float pr = 1.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float uv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) uv[j] = to_f32(up[(t + j) * a.ust]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const float2 ab = g.ab(uv[j]);
      hv = fmaf(ab.x, hv, ab.y);
      if (kProd) pr *= ab.x;
      if (kWrite) hp[static_cast<long long>(t + j) * a.W] = hv;
    }
  }
  for (; t < t1; ++t) {
    const float2 ab = g.ab(to_f32(up[t * a.ust]));
    hv = fmaf(ab.x, hv, ab.y);
    if (kProd) pr *= ab.x;
    if (kWrite) hp[static_cast<long long>(t) * a.W] = hv;
  }
  if (kProd) *prod = pr;
  return hv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel_step(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  if (c >= a.W) return;
  const Gates g(a.prm, c);
  const long long bc = static_cast<long long>(b) * a.W + c;
  const float h0 = a.h0 != nullptr ? a.h0[bc] : 0.f;
  a.h_last[bc] = walk<T, true, false>(a, g, b, c, 0, a.T, h0, nullptr);
}

// pass 1: (prod a, the scan from zero) of chunk blockIdx.z
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel_chunk_aggregate(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y,
            chunk = blockIdx.z;
  if (c >= a.W) return;
  const Gates g(a.prm, c);
  const int t0 = chunk * kChunk;
  float prod;
  const float part = walk<T, false, true>(a, g, b, c, t0, t0 + kChunk, 0.f,
                                          &prod);
  const int chunks = (a.T + kChunk - 1) / kChunk;
  a.agg[(static_cast<long long>(b) * (chunks - 1) + chunk) * a.W + c] =
      make_float2(prod, part);
}

// pass 2: carry h through the aggregates of the chunks before, rescan
template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel_chunk_scan(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y,
            chunk = blockIdx.z;
  if (c >= a.W) return;
  const long long bc = static_cast<long long>(b) * a.W + c;
  const int chunks = (a.T + kChunk - 1) / kChunk;
  float hv = a.h0 != nullptr ? a.h0[bc] : 0.f;
  const float2* ag = a.agg + static_cast<long long>(b) * (chunks - 1) * a.W +
                     c;
  for (int j = 0; j < chunk; ++j) {
    const float2 x = ag[static_cast<long long>(j) * a.W];
    hv = fmaf(x.x, hv, x.y);
  }
  const Gates g(a.prm, c);
  const int t0 = chunk * kChunk, t1 = min(t0 + kChunk, a.T);
  hv = walk<T, true, false>(a, g, b, c, t0, t1, hv, nullptr);
  if (chunk == chunks - 1) a.h_last[bc] = hv;
}

template <typename T>
int launch(const Args& a, int B, bool chunked, cudaStream_t stream) {
  const int wb = (a.W + kThreads - 1) / kThreads;
  if (!chunked) {
    rglru_kernel_step<T><<<dim3(wb, B), kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (a.T + kChunk - 1) / kChunk;
  rglru_kernel_chunk_aggregate<T>
      <<<dim3(wb, B, chunks - 1), kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_kernel_chunk_scan<T><<<dim3(wb, B, chunks), kThreads, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the chunked route's scratch (each chunk's aggregate but the
// last's), which the caller allocates; 0 where the route is not taken (T
// <= 64).
extern "C" long long rglru_chunked_scratch_bytes(int B, int T, int W) {
  const int chunks = (T + kChunk - 1) / kChunk;
  return chunks > 1 ? 8LL * B * (chunks - 1) * W : 0;
}

// h (B, T, W) and h_last (B, W), both f32 and contiguous, <- the RG-LRU
// scan of u on `stream`.  u's last dimension is contiguous; `usb`/`ust`
// are its batch and time strides in elements.  `params` holds the five
// (W,) f32 gate vectors w_r, b_r, w_i, b_i, lam; h0 (B, W) f32 contiguous,
// or null for a zero start.  dtype: 0 f32, 1 bf16.  `agg`: the scratch of
// `rglru_chunked_scratch_bytes` ((B, ceil(T / 64) - 1, W) pairs of f32),
// or null.  The route is chunked when T > 64 and `agg` is given, else
// step; it is written to *route (1 chunked, 0 step).  Returns the CUDA
// error of the launches (0 on success); never synchronises.
extern "C" int rglru_scan_launch(const void* u, int dtype, int B, int T,
                                 int W, long long usb, long long ust,
                                 const float* const* params,
                                 const float* h0, float* h, float* h_last,
                                 float* agg, void* stream, int* route) {
  const bool chunked = T > kChunk && agg != nullptr;
  *route = chunked ? 1 : 0;
  if (B <= 0 || W <= 0) return 0;
  Args a{u, usb, ust, {params[0], params[1], params[2], params[3], params[4]},
         h0, h, h_last, reinterpret_cast<float2*>(agg), T, W};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, chunked, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, chunked, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
