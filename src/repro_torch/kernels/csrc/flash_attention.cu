// Causal / windowed GQA flash attention (prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.flash_attention.flash_attention`
// of the JAX package (def at flash_attention.py:81, pallas_call at :100):
// o = softmax(q k^T * dh^-0.5, masked) v for q (B, Tq, H, D) and k/v
// (B, Tk, KH, D), query head h reading kv head h / (H / KH); key kp is
// visible to query qp when kp < Tk, qp >= kp (causal) and kp > qp - window
// (window > 0).  Positions of q and k both start at 0.  Masked scores are
// -1e30 and the softmax is online over key tiles with f32 running (m, l,
// acc) per row, exactly the Pallas kernel's arithmetic: q is scaled in
// f32, out = acc / max(l, 1e-30), cast to q's type.
//
// Layout: one CTA per (64-row q tile, q head, batch row), 256 threads,
// four threads to a q row.  The CTA stages its q tile (scaled) and, one
// after another, 64-key tiles of k and v into shared memory as f32,
// reading the strided (B, T, heads, D) tensors in place with 16-byte
// loads.  A thread scores its row against 16 of the tile's keys, the
// row's max and sum are reduced over the four threads with shuffles, and
// each thread keeps D/4 of the row's output columns in registers (64 at
// D = 256, RecurrentGemma's head dim).  The three tiles take (64 + 2 x 64)
// (D + 4) floats of shared memory: 199,680 bytes at D = 256, of the
// 232,448 a Hopper block may use, so one CTA an SM at that width.  Key
// tiles wholly above the causal diagonal or wholly older than the window
// are never loaded; the ragged tail of q and k (T need not be a multiple
// of 64) is masked, not asserted away as the Pallas kernel does (:89).
//
// What bounds it on this card: operations.  Causal prefill does about
// 2 B H T^2 D flops (4 per visible (q, k) pair and column) on 4 B T (H +
// 2 KH) D bytes of q/k/v/o; at T = 1024 that is ~330 flops a byte, above
// the H100's 295 bf16 flops per byte.  This kernel runs them as f32 FMAs
// on the CUDA cores (67 TFLOP/s peak, not the tensor cores' 989), which
// keeps it simple and exact for f32 inputs; moving the two products onto
// wgmma with TMA-fed tiles is the next step (see PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_io.cuh"

namespace {

using attn::kFull;
using attn::kNegInf;
using attn::kPad;

constexpr int kBQ = 64;                 // q rows per CTA
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBQ;    // threads per q row (4)
constexpr int kKeys = kBK / kTPR;       // keys each thread scores (16)

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;                                 // (B, Tq, H, D), contiguous
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  int Tq, Tk, H, KH, causal, window;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params<T> p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kPad;
  float* Qs = reinterpret_cast<float*>(smem4);   // kBQ x LD
  float* Ks = Qs + kBQ * LD;                     // kBK x LD
  float* Vs = Ks + kBK * LD;                     // kBK x LD

  const int q_lo = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x / kTPR, c = threadIdx.x % kTPR;
  const int qpos = q_lo + r;

  attn::load_rows<T, D, kThreads>(Qs, p.q + b * p.qsb + h * p.qsh, p.qst,
                                  q_lo, kBQ, p.Tq, p.scale);
  const T* kbase = p.k + b * p.ksb + kh * p.ksh;
  const T* vbase = p.v + b * p.vsb + kh * p.vsh;

  // the key tiles any row of this q tile can see
  const int nk = (p.Tk + kBK - 1) / kBK;
  int kb_end = nk;
  if (p.causal) kb_end = min(nk, min(q_lo + kBQ - 1, p.Tq - 1) / kBK + 1);
  int kb_begin = 0;
  if (p.window > 0 && q_lo - p.window + 1 > 0)
    kb_begin = (q_lo - p.window + 1) / kBK;

  float m_i = kNegInf, l_i = 0.f;       // l_i: this thread's keys only
  float acc[D / 4];                     // columns 4 (c + kTPR i) + 0..3
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k_lo = kb * kBK;
    __syncthreads();                    // the previous tile is consumed
    attn::load_rows<T, D, kThreads>(Ks, kbase, p.kst, k_lo, kBK, p.Tk, 1.f);
    attn::load_rows<T, D, kThreads>(Vs, vbase, p.vst, k_lo, kBK, p.Tk, 1.f);
    __syncthreads();

    // scores of row r against keys c + kTPR jj
    float s[kKeys];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (c + kTPR * jj) * LD + d);
        s[jj] = fmaf(qv.x, kv.x, s[jj]);
        s[jj] = fmaf(qv.y, kv.y, s[jj]);
        s[jj] = fmaf(qv.z, kv.z, s[jj]);
        s[jj] = fmaf(qv.w, kv.w, s[jj]);
      }
    }

    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int kp = k_lo + c + kTPR * jj;
      bool ok = kp < p.Tk;
      if (p.causal) ok = ok && qpos >= kp;
      if (p.window > 0) ok = ok && kp > qpos - p.window;
      if (!ok) s[jj] = kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      ls += s[jj];
    }
    l_i = l_i * corr + ls;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= corr;

    // acc += p v: key c' + kTPR jj's probability lives in lane c' of the row
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
#pragma unroll
      for (int cc = 0; cc < kTPR; ++cc) {
        const float pj =
            __shfl_sync(kFull, s[jj], (lane & ~(kTPR - 1)) | cc);
        const float* vrow = Vs + (cc + kTPR * jj) * LD;
#pragma unroll
        for (int i = 0; i < D / 16; ++i) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vrow + 4 * (c + kTPR * i));
          acc[4 * i] = fmaf(pj, vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(pj, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pj, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pj, vv.w, acc[4 * i + 3]);
        }
      }
    }
  }

  float l = l_i;
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  if (qpos < p.Tq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = p.o + ((static_cast<long long>(b) * p.Tq + qpos) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      attn::IO<T>::store4(orow + 4 * (c + kTPR * i), acc[4 * i] / den,
                          acc[4 * i + 1] / den, acc[4 * i + 2] / den,
                          acc[4 * i + 3] / den);
    }
  }
}

template <typename T, int D>
int launch(const Params<T>& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ + 2 * kBK) * (D + kPad);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Tq, int Tk, int H, int KH, int D, const long long* st,
             int causal, int window, float scale, cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<T*>(o),
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
              Tq, Tk, H, KH, causal, window, scale};
  if (D == 64) return launch<T, 64>(p, B, stream);
  if (D == 128) return launch<T, 128>(p, B, stream);
  if (D == 256) return launch<T, 256>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// o (B, Tq, H, D) contiguous <- attention of q over k/v on `stream`.
// `strides` holds the (batch, position, head) element strides of q, k, v
// in that order; the last dimension of each is contiguous.  dtype: 0 f32,
// 1 bf16; D: 64, 128 or 256.  Returns the CUDA error of the launch (0 on
// success); never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Tq, int Tk, int H, int KH,
                                      int D, const long long* strides,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Tq, Tk, H, KH, D, strides, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Tq, Tk, H, KH, D, strides,
                                   causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
