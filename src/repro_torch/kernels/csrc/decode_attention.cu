// Decode attention: one query token per row against a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.decode_attention.decode_attention`
// of the JAX package (def at decode_attention.py:61, pallas_call at :78):
// for q (B, H, D) and caches (B, S, KH, D), each of the G = H / KH query
// heads of kv head kh attends over cache positions < kv_len[b], with the
// Pallas kernel's arithmetic: scores scaled in f32, positions past kv_len
// masked to -1e30, an online softmax with f32 (m, l, acc) per head, out =
// acc / max(l, 1e-30) in q's type.  kv_len is clamped to [0, S]; with
// kv_len == 0 no position is read and the output is 0, as the Pallas
// kernel gives (every block skipped, l = 0).
//
// What bounds it on this card: bytes.  The cache rows up to kv_len (2 KH D
// elements per position and batch row), plus q and o, at 3.35 TB/s; the
// flops are 4 per (position, head, column), ~2 per byte in bf16.  The
// design keeps every SM reading:
//
// * Split-KV (flash-decoding).  The grid is (splits, KH x row groups, B):
//   each CTA takes `chunk` positions (a multiple of the 64-position tile)
//   of one (batch row, kv head), so B x KH rows of work become enough CTAs
//   to cover the 132 SMs (the wrapper sizes splits from B, KH and S
//   alone, never from kv_len, which stays on the device).  Each CTA reads
//   kv_len[b] itself; a split that starts at or past it writes an empty
//   partial (m = -1e30, l = 0) and returns.  A CTA writes its partial
//   (m, l, unnormalised acc) per query head to f32 scratch, and a second
//   kernel (`decode_kernel_merge`) rescales and sums the splits of each
//   (batch row, head) and writes o; with every split empty (kv_len 0) it
//   writes 0.  One C entry point launches both.
// * bf16 route (`decode_kernel_mma`): 64-position tiles of k and v staged
//   in shared memory as bf16 with cp.async, double-buffered, reading only
//   positions below kv_len (the rest zero-filled), rows padded 16 bytes so
//   ldmatrix is conflict-free.  The G query rows of the kv head, padded to
//   16 (groups of 16 past G = 16), are the M side of mma.sync m16n8k16 bf16
//   -> f32 products on the tensor cores: each of the 4 warps scores its 16
//   positions of the tile (S = Q K^T), keeps its own online softmax in
//   registers, and multiplies P (split in registers into bf16 P_hi +
//   P_lo, two products, so P V stays near f32; the accumulator layout is
//   the A-operand layout) by its 16 rows of v (ldmatrix.trans).  The
//   warps' (m, l, acc) merge in shared memory at the end of the split.
// * f32 route (`decode_kernel_fma`): the same splits, with f32 tiles and
//   FMA products on the CUDA cores (one thread an element of the G x 64
//   scores and of the G x D accumulator), exact to f32 rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_io.cuh"
#include "mma_sync.cuh"

namespace {

using attn::kFull;
using attn::kNegInf;
using attn::kPad;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                 // cache positions per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // query rows of an mma tile
constexpr int kBPad = 8;                // bf16 row padding (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBK == 16 * kWarps, "each warp takes 16 positions a tile");

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const int* kv_len;                    // (B,)
  float* acc;                           // (B, KH, splits, G, D) partials
  float* m;                             // (B, KH, splits, G), base 2
  float* l;                             // (B, KH, splits, G)
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int H, KH, S, splits, chunk;
  float scale_log2;                     // dh^-0.5 * log2(e)
};

// ---------------------------------------------------------------------------
// f32 route: FMA products on the CUDA cores
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t fma_smem_floats(int G, int D) {
  // q rows, k and v tiles, scores, output accumulator, (m, l, corr)
  return static_cast<size_t>(G) * (D + kPad) + 2 * kBK * (D + kPad) +
         static_cast<size_t>(G) * kBK + static_cast<size_t>(G) * D + 3 * G;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel_fma(Params<float> p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kPad;
  const int G = p.H / p.KH;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(p.kv_len[b], p.S));
  const int s_lo = split * p.chunk;
  const long long prow =
      (static_cast<long long>(b * p.KH + kh) * p.splits + split) * G;
  if (s_lo >= len) {
    for (int g = tid; g < G; g += kThreads) {
      p.m[prow + g] = kNegInf;
      p.l[prow + g] = 0.f;
    }
    return;
  }
  const int s_hi = min(s_lo + p.chunk, len);
  float* Qs = reinterpret_cast<float*>(smem4);   // G x LD
  float* Ks = Qs + G * LD;                       // kBK x LD
  float* Vs = Ks + kBK * LD;                     // kBK x LD
  float* Ps = Vs + kBK * LD;                     // G x kBK
  float* Acc = Ps + G * kBK;                     // G x D
  float* Ms = Acc + G * D;                       // G
  float* Ls = Ms + G;                            // G
  float* Cs = Ls + G;                            // G

  attn::load_rows<float, D, kThreads>(Qs, p.q + b * p.qsb + kh * G * p.qsh,
                                      p.qsh, 0, G, G, p.scale_log2);
  for (int i = tid; i < G * D; i += kThreads) Acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  const float* kbase = p.k + b * p.ksb + kh * p.ksh;
  const float* vbase = p.v + b * p.vsb + kh * p.vsh;

  for (int k_lo = s_lo; k_lo < s_hi; k_lo += kBK) {
    __syncthreads();                    // the previous tile is consumed
    attn::load_rows<float, D, kThreads>(Ks, kbase, p.kss, k_lo, kBK, s_hi,
                                        1.f);
    attn::load_rows<float, D, kThreads>(Vs, vbase, p.vss, k_lo, kBK, s_hi,
                                        1.f);
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
      Ps[idx] = k_lo + j < s_hi ? s : kNegInf;
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
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    const int jn = min(kBK, s_hi - k_lo);
    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      const float* pr = Ps + g * kBK;
      float a = 0.f;
      for (int j = 0; j < jn; ++j) a = fmaf(pr[j], Vs[j * LD + d], a);
      Acc[idx] = Acc[idx] * Cs[g] + a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * D; idx += kThreads)
    p.acc[prow * D + idx] = Acc[idx];
  for (int g = tid; g < G; g += kThreads) {
    p.m[prow + g] = Ms[g];
    p.l[prow + g] = Ls[g];
  }
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync on bf16 tiles
// ---------------------------------------------------------------------------

// shared memory of the bf16 route: q rows, two stages of k and v tiles
// (bf16, rows padded), the warps' (m, l); the tiles' space then holds the
// warps' f32 accumulators for the merge
__host__ __device__ constexpr size_t mma_smem_bytes(int D) {
  return 2 * static_cast<size_t>(kRows + 2 * 2 * kBK) * (D + kBPad) +
         2 * sizeof(float) * kWarps * kRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel_mma(Params<bf16> p) {
  extern __shared__ float4 smem4[];
  constexpr int LD = D + kBPad;
  static_assert(2 * 2 * kBK * LD * 2 >= kWarps * kRows * D * 4,
                "the tiles' space holds the warps' accumulators");
  const int G = p.H / p.KH, groups = (G + kRows - 1) / kRows;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / groups, g0 = (blockIdx.y % groups) * kRows;
  const int rows = min(kRows, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(p.kv_len[b], p.S));
  const int s_lo = split * p.chunk;
  const long long prow =
      (static_cast<long long>(b * p.KH + kh) * p.splits + split) * G + g0;
  if (s_lo >= len) {
    if (tid < rows) {
      p.m[prow + tid] = kNegInf;
      p.l[prow + tid] = 0.f;
    }
    return;
  }
  const int s_hi = min(s_lo + p.chunk, len);
  bf16* Qs = reinterpret_cast<bf16*>(smem4);     // kRows x LD
  bf16* Ks = Qs + kRows * LD;                    // 2 x kBK x LD
  bf16* Vs = Ks + 2 * kBK * LD;                  // 2 x kBK x LD
  float* Mw = reinterpret_cast<float*>(Vs + 2 * kBK * LD);  // kWarps x 16
  float* Lw = Mw + kWarps * kRows;
  float* Red = reinterpret_cast<float*>(Ks);     // kWarps x 16 x D, last

  // this group's query rows, zero past G
  const bf16* qbase = p.q + b * p.qsb + (kh * G + g0) * p.qsh;
  for (int i = tid; i < kRows * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows) val = *reinterpret_cast<const uint4*>(qbase + r * p.qsh + c);
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  const bf16* kbase = p.k + b * p.ksb + kh * p.ksh;
  const bf16* vbase = p.v + b * p.vsb + kh * p.vsh;
  auto load_tile = [&](int t_lo, int stage) {
    bf16* kd = Ks + stage * kBK * LD;
    bf16* vd = Vs + stage * kBK * LD;
    for (int i = tid; i < kBK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = t_lo + r < s_hi;
      const long long pos = ok ? t_lo + r : s_lo;   // any valid address
      cp_async16(kd + r * LD + c, kbase + pos * p.kss + c, ok);
      cp_async16(vd + r * LD + c, vbase + pos * p.vss + c, ok);
    }
    cp_async_commit();
  };

  // this lane's rows (r0, r0 + 8) and positions of its warp's 16
  const int r0 = lane >> 2, cq = 2 * (lane & 3);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int nt = (s_hi - s_lo + kBK - 1) / kBK;
  load_tile(s_lo, 0);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load_tile(s_lo + (t + 1) * kBK, (t + 1) & 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + ((t & 1) * kBK + 16 * warp) * LD;
    const bf16* Vt = Vs + ((t & 1) * kBK + 16 * warp) * LD;

    // S (16 rows x this warp's 16 positions) = Q K^T
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, Qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         16 * kk + (lane >> 4) * 8);
      ldmatrix_x4(bk, Kt + ((lane >> 4) * 8 + (lane & 7)) * LD + 16 * kk +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], a, bk[0], bk[1]);
      mma_bf16(sc[1], a, bk[2], bk[3]);
    }

    // scale (f32, base 2), mask past the split's end, online softmax
    const int p0 = s_lo + t * kBK + 16 * warp + cq;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = p0 + 8 * j + (e & 1) < s_hi
                            ? sc[j][e] * p.scale_log2 : kNegInf;
        sc[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn0);
      sc[j][1] = exp2f(sc[j][1] - mn0);
      sc[j][2] = exp2f(sc[j][2] - mn1);
      sc[j][3] = exp2f(sc[j][3] - mn1);
      ls0 += sc[j][0] + sc[j][1];
      ls1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
    // P as bf16 P_hi + P_lo, straight from the accumulator layout into the
    // A operand (P in bf16 alone adds 2^-9 relative error a weight)
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = sc[u >> 1][2 * (u & 1)], b = sc[u >> 1][2 * (u & 1) + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      ph[u] = *reinterpret_cast<const uint32_t*>(&h);
      pl[u] = attn::pack_bf16(a - hf.x, b - hf.y);
    }

    // acc (16 x D) = acc * corr + P V, 16 columns of v a step
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                16 * n + (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&c)[4] = acc[2 * n + h];
        c[0] *= c0;
        c[1] *= c0;
        c[2] *= c1;
        c[3] *= c1;
        mma_bf16(c, ph, bv[2 * h], bv[2 * h + 1]);
        mma_bf16(c, pl, bv[2 * h], bv[2 * h + 1]);
      }
    }
    __syncthreads();                    // the stage may be refilled
  }

  // merge the four warps' (m, l, acc) of each row
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  if ((lane & 3) == 0) {
    Mw[warp * kRows + r0] = m0;
    Mw[warp * kRows + r0 + 8] = m1;
    Lw[warp * kRows + r0] = l0;
    Lw[warp * kRows + r0 + 8] = l1;
  }
  __syncthreads();
  float top0 = kNegInf, top1 = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    top0 = fmaxf(top0, Mw[w * kRows + r0]);
    top1 = fmaxf(top1, Mw[w * kRows + r0 + 8]);
  }
  const float f0 = exp2f(m0 - top0), f1 = exp2f(m1 - top1);
  float* red = Red + warp * kRows * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + cq;
    *reinterpret_cast<float2*>(red + r0 * D + col) =
        make_float2(acc[n][0] * f0, acc[n][1] * f0);
    *reinterpret_cast<float2*>(red + (r0 + 8) * D + col) =
        make_float2(acc[n][2] * f1, acc[n][3] * f1);
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += Red[w * kRows * D + i];
    p.acc[prow * D + i] = s;
  }
  if (tid < rows) {
    float top = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) top = fmaxf(top, Mw[w * kRows + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      l += Lw[w * kRows + tid] * exp2f(Mw[w * kRows + tid] - top);
    p.m[prow + tid] = top;
    p.l[prow + tid] = l;
  }
}

// ---------------------------------------------------------------------------
// the merge of the splits
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 128;

template <typename T>
struct MergeParams {
  const float* acc;
  const float* m;
  const float* l;
  T* o;                                 // (B, H, D), contiguous
  int H, KH, D, splits;
};

// One CTA per (query head, batch row): o = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = 2^(m_s - max m) over the non-empty splits (l_s > 0); 0 when
// every split is empty.  The split weights are computed once, in
// parallel, into shared memory (splits floats); then each thread sums its
// columns over the splits with independent loads.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_kernel_merge(MergeParams<T> p) {
  extern __shared__ float wts[];        // splits weights, then the scale
  __shared__ float red[kMergeThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.KH, kh = h / G, g = h % G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 =
      static_cast<long long>(b * p.KH + kh) * p.splits * G + g;

  float top = kNegInf;
  for (int s = tid; s < p.splits; s += kMergeThreads) {
    const float m = p.m[row0 + s * G], l = p.l[row0 + s * G];
    wts[s] = l > 0.f ? m : kNegInf;
    if (l > 0.f) top = fmaxf(top, m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = fmaxf(top, __shfl_xor_sync(kFull, top, off));
  if (lane == 0) red[warp] = top;
  __syncthreads();
  top = red[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) top = fmaxf(top, red[w]);
  __syncthreads();                      // red is reused below

  float den = 0.f;
  for (int s = tid; s < p.splits; s += kMergeThreads) {
    const float l = p.l[row0 + s * G];
    const float w = l > 0.f ? exp2f(wts[s] - top) : 0.f;
    wts[s] = w;
    den += w * l;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(kFull, den, off);
  if (lane == 0) red[warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) den += red[w];
  den = fmaxf(den, 1e-30f);

  T* orow = p.o + (static_cast<long long>(b) * p.H + h) * p.D;
  const float* acc = p.acc + row0 * p.D;
  const long long step = static_cast<long long>(G) * p.D;
  for (int d = tid; d < p.D; d += kMergeThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) {
      const float w = wts[s];
      if (w != 0.f) a += w * acc[s * step + d];
    }
    attn::IO<T>::store1(orow + d, a / den);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_split(const Params<T>& p, int B, cudaStream_t stream) {
  const int G = p.H / p.KH;
  void (*kernel)(Params<T>);
  size_t smem;
  int groups;
  if constexpr (sizeof(T) == 4) {
    kernel = decode_kernel_fma<D>;
    smem = sizeof(float) * fma_smem_floats(G, D);
    groups = 1;
  } else {
    kernel = decode_kernel_mma<D>;
    smem = mma_smem_bytes(D);
    groups = (G + kRows - 1) / kRows;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.splits, p.KH * groups, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, float* scratch, int B, int H, int KH, int S, int D,
             const long long* st, int splits, int chunk, float scale,
             cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * splits;
  float* acc = scratch;
  float* m = acc + rows * D;
  float* l = m + rows;
  Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), kv_len, acc, m, l,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
              H, KH, S, splits, chunk, scale * kLog2e};
  int err;
  if (D == 64) err = launch_split<T, 64>(p, B, stream);
  else if (D == 128) err = launch_split<T, 128>(p, B, stream);
  else if (D == 256) err = launch_split<T, 256>(p, B, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const MergeParams<T> mp{acc, m, l, static_cast<T*>(o), H, KH, D, splits};
  decode_kernel_merge<T><<<dim3(H, B), kMergeThreads,
                           sizeof(float) * splits, stream>>>(mp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one split CTA needs for G query heads per kv
// head at head dim D, for dtype 0 (f32) or 1 (bf16; any G, in groups of
// 16 rows).
extern "C" size_t decode_attention_smem_bytes(int G, int D, int dtype) {
  if (dtype == 0) return sizeof(float) * fma_smem_floats(G, D);
  return mma_smem_bytes(D);
}

// o (B, H, D) contiguous <- attention of q over the first kv_len[b]
// positions of k/v on `stream`: the split kernel over `splits` ranges of
// `chunk` positions (a multiple of 64, splits x chunk >= S), then the
// merge.  `scratch` holds B H splits (D + 2) floats for the partials.
// `strides` holds q's (batch, head) and k's and v's (batch, position,
// head) element strides, in that order; the last dimension of each is
// contiguous.  dtype: 0 f32, 1 bf16; D: 64, 128 or 256.  Returns the CUDA
// error of the launches (0 on success); never synchronises.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       void* o, float* scratch, int dtype,
                                       int B, int H, int KH, int S, int D,
                                       const long long* strides, int splits,
                                       int chunk, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || splits <= 0 || chunk <= 0 ||
      chunk % kBK != 0 || static_cast<long long>(splits) * chunk < S ||
      splits > 48 * 1024 / 4)           // the merge's weights in shared memory
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, kv_len, o, scratch, B, H, KH, S, D,
                           strides, splits, chunk, scale, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, kv_len, o, scratch, B, H, KH, S, D,
                          strides, splits, chunk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
