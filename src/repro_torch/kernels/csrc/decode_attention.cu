// Decode attention: one query token per row against a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.decode_attention.decode_attention`
// of the JAX package (def at decode_attention.py:61, pallas_call at :78):
// for q (B, H, D) and caches (B, S, KH, D), each of the G = H / KH query
// heads of kv head kh attends over cache positions < kv_len[b], with the
// Pallas kernel's arithmetic: q scaled in f32, scores of positions past
// kv_len set to -1e30 inside a tile, an online softmax over key tiles with
// f32 (m, l, acc) per head, out = acc / max(l, 1e-30) in q's type.  With
// kv_len == 0 no tile is visited and the output is 0, as the Pallas kernel
// gives (every block skipped, l = 0); kv_len is clamped to [0, S].
//
// Layout: one CTA per (kv head, batch row), 128 threads.  The G query
// rows of the kv head are staged once; then 64-position tiles of k and v,
// up to kv_len[b] only, are read with 16-byte loads into shared memory as
// f32, so all G query heads share each k/v row read.  Scores (G x 64) and
// the per-head softmax statistics live in shared memory, one warp per head
// for the max and sum; the G x D output accumulates in shared memory, each
// thread owning fixed entries.
//
// What bounds it on this card: bytes.  The cache rows up to kv_len (2 KH D
// elements per position and batch row), plus q and o, at 3.35 TB/s; the
// flops are 4 per (position, head, column), ~1 per byte.  With B = 8 and
// KH = 8 the grid is 64 CTAs on 132 SMs, and each CTA walks its whole
// kv_len alone: splitting the KV axis across CTAs (flash-decoding, with a
// second pass to merge the partial (m, l, acc)) is later work.
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

constexpr int kBK = 64;                 // cache positions per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
static_assert(kBK == 64, "the softmax pass reads two scores a lane");

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const int* kv_len;                    // (B,)
  T* o;                                 // (B, H, D), contiguous
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int H, KH, S;
  float scale;
};

__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  // q rows, k and v tiles, scores, output accumulator, (m, l, corr)
  return static_cast<size_t>(G) * (D + kPad) + 2 * kBK * (D + kPad) +
         static_cast<size_t>(G) * kBK + static_cast<size_t>(G) * D + 3 * G;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params<T> p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kPad;
  const int G = p.H / p.KH;
  const int kh = blockIdx.x, b = blockIdx.y;
  float* Qs = reinterpret_cast<float*>(smem4);   // G x LD
  float* Ks = Qs + G * LD;                       // kBK x LD
  float* Vs = Ks + kBK * LD;                     // kBK x LD
  float* Ps = Vs + kBK * LD;                     // G x kBK
  float* Acc = Ps + G * kBK;                     // G x D
  float* Ms = Acc + G * D;                       // G
  float* Ls = Ms + G;                            // G
  float* Cs = Ls + G;                            // G
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(p.kv_len[b], p.S));

  attn::load_rows<T, D, kThreads>(Qs, p.q + b * p.qsb + kh * G * p.qsh,
                                  p.qsh, 0, G, G, p.scale);
  for (int i = tid; i < G * D; i += kThreads) Acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  const T* kbase = p.k + b * p.ksb + kh * p.ksh;
  const T* vbase = p.v + b * p.vsb + kh * p.vsh;

  for (int k_lo = 0; k_lo < len; k_lo += kBK) {
    __syncthreads();                    // the previous tile is consumed
    attn::load_rows<T, D, kThreads>(Ks, kbase, p.kss, k_lo, kBK, len, 1.f);
    attn::load_rows<T, D, kThreads>(Vs, vbase, p.vss, k_lo, kBK, len, 1.f);
    __syncthreads();

    for (int idx = tid; idx < G * kBK; idx += kThreads) {
      const int g = idx / kBK, j = idx % kBK;
      const float* qr = Qs + g * LD;
      const float* kr = Ks + j * LD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      Ps[idx] = k_lo + j < len ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pr = Ps + g * kBK;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    const int jn = min(kBK, len - k_lo);
    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      const float* pr = Ps + g * kBK;
      float a = 0.f;
      for (int j = 0; j < jn; ++j) a = fmaf(pr[j], Vs[j * LD + d], a);
      Acc[idx] = Acc[idx] * Cs[g] + a;
    }
  }
  __syncthreads();

  T* orow = p.o + (static_cast<long long>(b) * p.H + kh * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    attn::IO<T>::store1(orow + idx, Acc[idx] / fmaxf(Ls[idx / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const Params<T>& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.H / p.KH, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.KH, B);
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int H, int KH, int S, int D,
             const long long* st, float scale, cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), kv_len, static_cast<T*>(o),
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
              H, KH, S, scale};
  if (D == 64) return launch<T, 64>(p, B, stream);
  if (D == 128) return launch<T, 128>(p, B, stream);
  if (D == 256) return launch<T, 256>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory one CTA needs for G query heads per kv head.
extern "C" size_t decode_attention_smem_bytes(int G, int D) {
  return sizeof(float) * smem_floats(G, D);
}

// o (B, H, D) contiguous <- attention of q over the first kv_len[b]
// positions of k/v on `stream`.  `strides` holds q's (batch, head) and
// k's and v's (batch, position, head) element strides, in that order; the
// last dimension of each is contiguous.  dtype: 0 f32, 1 bf16; D: 64,
// 128 or 256.  Returns the CUDA error of the launch (0 on success); never
// synchronises.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* o, int dtype, int B, int H,
                                       int KH, int S, int D,
                                       const long long* strides, float scale,
                                       void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, kv_len, o, B, H, KH, S, D, strides,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, o, B, H, KH, S, D,
                                   strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
