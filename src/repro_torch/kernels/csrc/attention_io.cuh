// Loads and stores shared by the attention kernels (flash_attention.cu,
// decode_attention.cu) and the expert FFN (moe_gmm.cu): 16-byte reads of
// bf16 or f32 rows of a strided (..., rows, ..., D) tensor into an f32 tile
// in shared memory, single-element reads for ragged edges, 4-wide or
// single stores of f32 results in the tensor's own type, and the packing
// of f32 pairs into the bf16 operand registers of the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;   // the JAX package's NEG_INF
constexpr int kPad = 4;             // tile row padding (floats): rows stay
                                    // 16-byte aligned and land on
                                    // different banks
constexpr unsigned kFull = 0xffffffffu;

// Two f32 values rounded to one bf16 pair (lo in the low half), as the
// tensor cores' 16-bit operand registers hold them.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <typename T>
struct IO;

template <>
struct IO<float> {
  static constexpr int kVec = 4;    // elements per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store4(float* p, float a, float b, float c,
                                float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
  __device__ static void store1(float* p, float a) { *p = a; }
};

template <>
struct IO<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store4(__nv_bfloat16* p, float a, float b, float c,
                                float d) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
  __device__ static void store1(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16_rn(a);
  }
};

// Copies `rows` rows (row0 .. row0 + rows - 1, `stride` elements apart) of
// D contiguous elements at `base` into `tile` (rows x (D + kPad) floats),
// times `mul`; rows at or past `valid` are zero.  Every thread of the
// block (kThreads of them) takes part.  Needs 16-byte aligned rows.
template <typename T, int D, int kThreads>
__device__ void load_rows(float* tile, const T* base, long long stride,
                          int row0, int rows, int valid, float mul) {
  constexpr int V = IO<T>::kVec;
  constexpr int kChunks = D / V;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * V;
    float vals[V];
    if (row0 + r < valid) {
      IO<T>::load(base + static_cast<long long>(row0 + r) * stride + col,
                  vals);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
    float* dst = tile + r * (D + kPad) + col;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(vals[e] * mul, vals[e + 1] * mul, vals[e + 2] * mul,
                      vals[e + 3] * mul);
    }
  }
}

}  // namespace attn
