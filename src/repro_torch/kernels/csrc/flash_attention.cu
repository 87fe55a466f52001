// Causal / windowed GQA flash attention (prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro.kernels.flash_attention.flash_attention`
// of the JAX package (def at flash_attention.py:81, pallas_call at :100):
// o = softmax(q k^T * dh^-0.5, masked) v for q (B, Tq, H, D) and k/v
// (B, Tk, KH, D), query head h reading kv head h / (H / KH); key kp is
// visible to query qp when kp < Tk, qp >= kp (causal) and kp > qp - window
// (window > 0).  Positions of k start at 0, those of q at q_off (0 for a
// whole prompt; a sequence-parallel rank's first row's position for its
// block of the queries against the whole K/V): the mask and the tile
// bounds read q row r at position r + q_off.  Masked scores are
// -1e30 and the softmax is online over key tiles with f32 running (m, l,
// acc) per row, as in the Pallas kernel; out = acc / max(l, 1e-30), cast
// to q's type.  A row that sees no key (with a window, when Tq >= Tk +
// window) gives exact 0 in both routes, as the decode kernel does for
// kv_len 0 (the plain version, like JAX's block scan, gives a mean over
// its zero-padded blocks there).  Key tiles wholly above the causal
// diagonal or wholly older than the window are never loaded; the ragged
// tail of q and k (T need not be a multiple of a tile) is masked, not
// asserted away as the Pallas kernel does (:89).
//
// What bounds it on this card: operations.  Causal prefill does about
// 2 B H T^2 D flops (4 per visible (q, k) pair and column) on 2 B T (H +
// 2 KH) D bytes of bf16 q/k/v/o; at T = 1024 that is ~660 flops a byte,
// above the H100's 295 bf16 flops per byte, so the tensor cores (989
// TFLOP/s) set the pace, not the memory.
//
// bf16 route (`flash_kernel_wgmma`), the design for that bound: one CTA per
// (128-row q tile, q head, batch row): two consumer warpgroups and a
// producer warpgroup of which one warp works, 384 threads.  One producer
// thread loads the q tile once and then the key and value tiles through
// TMA, bf16 and 128-byte swizzled, into a 2-stage ring in shared memory
// guarded by full/empty mbarrier pairs.  The consumer warpgroups take 64 q
// rows each: S = Q K^T runs as wgmma m64nNk16 with both operands in shared
// memory and S in registers; the online softmax stays in registers (f32 m
// and l, the maxima taken on raw scores, then P = 2^(s dh^-0.5 log2 e - m
// dh^-0.5 log2 e) as one FFMA and one ex2 a score, the scale applied in
// f32, never to q in bf16); P is split in registers into bf16 P_hi + P_lo,
// where the accumulator layout of S is already wgmma's A-operand layout,
// and O += P_hi V + P_lo V runs as two wgmmas with A from registers and V
// from shared memory as the transposed (MN-major) operand.  (P in bf16
// alone would add ~1e-3 relative error to O beside bf16's own 1.6e-3,
// enough to flip near-tied routes of an MoE layer downstream; the second P
// V product adds half again to the flops.)  The two warpgroups run out of
// step, so one's softmax overlaps the other's products.  Registers: the
// producer warpgroup gives most of its own up (setmaxnreg, 40) for the
// consumers (232), but ptxas compiles the consumer code to the 168 a thread
// of the launch bounds (65,536 / 384); the D = 256 output accumulator alone
// is 128 of them, so S is zeroed before each product (its old values die),
// P is packed before O is rescaled, and no loop but the mbarrier waits'
// runs inside the tile loop.  Tiles: 128 keys at head dim 64 and 128; 64 at
// head dim 256, where q (64 KB) and two stages of k and v (128 KB) fill
// 197,688 of the 232,448 bytes a block may use.  The q tiles run heaviest
// first (the last tile of a causal prompt sees the most keys), so the
// causal tail does not set the time.  A tile no row of a warpgroup can see
// is released unread once it has landed.  The TMA descriptors are built on
// the host per call from the strided views, through the driver entry point
// that the runtime hands out (no -lcuda); TMA fills rows past T with zeros,
// which the kp < Tk mask then drops.
//
// f32 route (`flash_kernel_f32`): the CUDA-core kernel, exact to f32
// rounding (TF32 or bf16 tensor cores would not hold the f32 tolerance of
// 2e-5).  One CTA per (64-row q tile, q head, batch row), 256 threads,
// four to a q row; q (scaled in f32), k and v tiles staged in shared
// memory as f32 with 16-byte loads; f32 FMAs on the CUDA cores (67
// TFLOP/s).  (64 + 2 x 64) (D + 4) floats of shared memory: 199,680 bytes
// at D = 256, one CTA an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC; the plain C entry point is bound with ctypes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_io.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 route: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

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
  int Tq, Tk, H, KH, causal, window, q_off;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel_f32(Params<T> p) {
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
  const int row = q_lo + r, qpos = row + p.q_off;

  attn::load_rows<T, D, kThreads>(Qs, p.q + b * p.qsb + h * p.qsh, p.qst,
                                  q_lo, kBQ, p.Tq, p.scale);
  const T* kbase = p.k + b * p.ksb + kh * p.ksh;
  const T* vbase = p.v + b * p.vsb + kh * p.vsh;

  // the key tiles any row of this q tile can see
  const int nk = (p.Tk + kBK - 1) / kBK;
  const int p_lo = q_lo + p.q_off;
  int kb_end = nk;
  if (p.causal)
    kb_end = min(nk, (min(q_lo + kBQ - 1, p.Tq - 1) + p.q_off) / kBK + 1);
  int kb_begin = 0;
  if (p.window > 0 && p_lo - p.window + 1 > 0)
    kb_begin = (p_lo - p.window + 1) / kBK;

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
    // a row that has seen no key yet (m still -1e30) takes P = 0, as the
    // bf16 route does: a row that sees no key at all gives 0
    const bool none = m_new == kNegInf;
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      s[jj] = none ? 0.f : expf(s[jj] - m_new);
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
  if (row < p.Tq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = p.o + ((static_cast<long long>(b) * p.Tq + row) * p.H + h) * D;
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
      flash_kernel_f32<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Tq + kBQ - 1) / kBQ, p.H, B);
  flash_kernel_f32<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
             int Tq, int Tk, int H, int KH, int D, const long long* st,
             int causal, int window, int q_off, float scale,
             cudaStream_t stream) {
  Params<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<T*>(o),
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
              Tq, Tk, H, KH, causal, window, q_off, scale};
  if (D == 64) return launch<T, 64>(p, B, stream);
  if (D == 128) return launch<T, 128>(p, B, stream);
  if (D == 256) return launch<T, 256>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 route: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

namespace tc {

using attn::kNegInf;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;               // q rows per CTA
constexpr int kConsumers = 256;        // two warpgroups of 64 q rows
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kStages = 2;
// 384 threads start at 168 registers (65,536 / 384); the producer
// warpgroup drops to 40 and the consumers take the 16,384 it frees:
// 128 x 40 + 256 x 232 = 384 x 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;     // keys per tile
  static constexpr int kBlocks = D / 64;             // 128-byte columns
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = BK * D * 2;        // one k or v tile
  static constexpr int kBars = 1 + 3 * kStages;      // q, full k/v, empty
  // 1 KB of slack to align the swizzled tiles to 1 KB
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

struct Shape {
  bf16* o;                             // (B, Tq, H, D), contiguous
  int Tq, Tk, H, KH, causal, window, q_off;
  float scale_log2;                    // dh^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return attn::pack_bf16(lo, hi);
}

// (a, b) as a bf16 pair `hi` plus the bf16 pair `lo` of what it misses.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - hf.x, b - hf.y);
}

// S = Q K^T (64 x BK) of one key tile, issued and committed, not awaited:
// K-major operands, 16 columns of D a step.  sc is zeroed first: the
// asm operands are read-write, and the previous tile's scores must not
// stay live across P V (at D = 256 they would not fit beside O and P).
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const bf16* Qw,
                                         const bf16* Kt) {
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        hopper::desc_sw128(Qw + (kk / 4) * kBQ * 64 + (kk % 4) * 16, 16, 1024);
    const uint64_t db =
        hopper::desc_sw128(Kt + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, 1024);
    hopper::Wgmma<BK>::ss(sc, da, db, kk > 0);
  }
  hopper::wgmma_commit();
}

// O += (P_hi + P_lo) V of one key tile, issued and committed, not
// awaited: P's two bf16 parts from registers, V the MN-major operand (D
// wide), 16 keys a step.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&hi)[BK / 16][4],
                                         uint32_t (&lo)[BK / 16][4],
                                         const bf16* Vt) {
  hopper::fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    hopper::fence_regs(hi[kk]);
    hopper::fence_regs(lo[kk]);
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db =
        hopper::desc_sw128(Vt + kk * 16 * 64, BK * 128, 1024);
    hopper::Wgmma<D>::rs(o, hi[kk], db);
    hopper::Wgmma<D>::rs(o, lo[kk], db);
  }
  hopper::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const Shape p) {
  using C = Tile<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  // each tile: kBlocks column blocks of (rows x 64) bf16, 128 B a row
  bf16* Qs = reinterpret_cast<bf16*>(base);          // kBQ rows
  bf16* Ks = Qs + kBQ * D;                           // kStages x BK rows
  bf16* Vs = Ks + kStages * BK * D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * BK * D);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KH);

  // the key tiles any row of this q tile can see
  const int nk = (p.Tk + BK - 1) / BK;
  const int p_lo = q_lo + p.q_off;
  int kb_end = nk;
  if (p.causal)
    kb_end = min(nk, (min(q_lo + kBQ - 1, p.Tq - 1) + p.q_off) / BK + 1);
  int kb_begin = 0;
  if (p.window > 0 && p_lo - p.window + 1 > 0)
    kb_begin = (p_lo - p.window + 1) / BK;
  const int n = kb_end - kb_begin;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform by construction (a shuffle from lane 0)
  const int wg =
      __shfl_sync(attn::kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == kConsumers / 128) {
    // ---- producer: one thread issues every TMA load ----
    hopper::regs_release<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
      hopper::mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kBlocks; ++c)
        hopper::tma_load_4d(Qs + c * kBQ * 64, &qmap, q_full, 64 * c, q_lo,
                            h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const int k_lo = (kb_begin + i) * BK;
        hopper::mbar_expect_tx(&k_full[s], C::kKVBytes);
        for (int c = 0; c < C::kBlocks; ++c)
          hopper::tma_load_4d(Ks + (s * C::kBlocks + c) * BK * 64, &kmap,
                              &k_full[s], 64 * c, k_lo, kh, b);
        hopper::mbar_expect_tx(&v_full[s], C::kKVBytes);
        for (int c = 0; c < C::kBlocks; ++c)
          hopper::tma_load_4d(Vs + (s * C::kBlocks + c) * BK * 64, &vmap,
                              &v_full[s], 64 * c, k_lo, kh, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    hopper::regs_claim<kConsumerRegs>();
    const int t = threadIdx.x;
    const int cw = wg;                            // consumer warpgroup
    const int warp = (t / 32) % 4, lane = t % 32;
    // the positions of this warpgroup's first and last rows
    const int q_min = q_lo + 64 * cw + p.q_off, q_max = q_min + 63;
    // this thread's rows r0 and r0 + 8, and columns cq, cq + 1 of each
    // 8-column block of S and O (the wgmma accumulator layout); rp its
    // position
    const int r0 = q_lo + 64 * cw + 16 * warp + lane / 4;
    const int rp = r0 + p.q_off;
    const int cq = 2 * (lane % 4);
    const bf16* Qw = Qs + 64 * cw * 64;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const float sl2 = p.scale_log2;

    hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      const int k_lo = (kb_begin + i) * BK;
      // a tile no row of this warpgroup sees (above the diagonal, or older
      // than the window) is released unread, once it has arrived: its stage
      // may not be refilled before the other warpgroup is done with it
      if ((p.causal && k_lo > q_max) ||
          (p.window > 0 && k_lo + BK - 1 <= q_min - p.window)) {
        hopper::mbar_wait(&k_full[s], par);
        hopper::mbar_wait(&v_full[s], par);
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
      float sc[BK / 2];
      hopper::mbar_wait(&k_full[s], par);
      issue_qk<D, BK>(sc, Qw, Ks + s * C::kBlocks * BK * 64);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // raw row maxima, masked where the tile crosses an edge: keys
      // [lo, hi) of row r0 and [lo8, hi8) of row r0 + 8, as offsets from
      // this thread's first column
      float mx0 = kNegInf, mx1 = kNegInf;
      if (k_lo + BK > p.Tk || (p.causal && k_lo + BK - 1 > q_min) ||
          (p.window > 0 && k_lo <= q_max - p.window)) {
        const int k0 = k_lo + cq;
        const int lo = (p.window > 0 ? rp - p.window + 1 : 0) - k0;
        const int hi = (p.causal ? min(p.Tk, rp + 1) : p.Tk) - k0;
        const int lo8 = lo + (p.window > 0 ? 8 : 0);
        const int hi8 = (p.causal ? min(p.Tk, rp + 9) : p.Tk) - k0;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = 8 * j + (e & 1);
            const bool ok =
                e < 2 ? kp >= lo && kp < hi : kp >= lo8 && kp < hi8;
            if (!ok) sc[4 * j + e] = kNegInf;
          }
        }
      }
      {
        // two independent chains a row (a warp's latency is barely hidden)
        float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx[j & 1] = fmaxf(mx[j & 1], fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx[2 + (j & 1)] =
              fmaxf(mx[2 + (j & 1)], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = fmaxf(mx[0], mx[1]);
        mx1 = fmaxf(mx[2], mx[3]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(attn::kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(attn::kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(attn::kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(attn::kFull, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = hopper::ex2((m0 - mn0) * sl2);
      const float c1 = hopper::ex2((m1 - mn1) * sl2);
      m0 = mn0;
      m1 = mn1;
      // a row that has seen no key yet (m still -1e30) takes P = 0, not
      // the rounding residue of -1e30 x scale twice
      const float b0 = mn0 == kNegInf ? 0.f : -mn0 * sl2;
      const float b1 = mn1 == kNegInf ? 0.f : -mn1 * sl2;

      // P = 2^(s dh^-0.5 log2 e - m ...), one FFMA and one ex2 a score,
      // split into bf16 P_hi + P_lo (P to ~16 bits: bf16 P alone adds
      // 2^-9 relative error a weight, enough to flip near-tied MoE routes
      // downstream), straight into wgmma's A layout: k-step kk of P V
      // reads the accumulator entries 8 kk .. 8 kk + 7
      // (the row sums accumulate in column order: arctic's kernel-vs-plain
      // check flips a near-tied MoE route on a reordering of them)
      float ls0 = 0.f, ls1 = 0.f;
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          e[u] = hopper::ex2(fmaf(sc[8 * kk + u], sl2, (u & 2) ? b1 : b0));
          if (u & 2) ls1 += e[u]; else ls0 += e[u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) split(e[2 * u], e[2 * u + 1],
                                          ph[kk][u], pl[kk][u]);
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
      // rows whose maximum did not move have c = 1 exactly: a warp whose
      // rows all kept theirs skips the rescale
      if (__any_sync(attn::kFull, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= c0;
          o[4 * j + 1] *= c0;
          o[4 * j + 2] *= c1;
          o[4 * j + 3] *= c1;
        }
      }

      hopper::mbar_wait(&v_full[s], par);
      issue_pv<D, BK>(o, ph, pl, Vs + s * C::kBlocks * BK * 64);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[s]);
    }

    l0 += __shfl_xor_sync(attn::kFull, l0, 1);
    l0 += __shfl_xor_sync(attn::kFull, l0, 2);
    l1 += __shfl_xor_sync(attn::kFull, l1, 1);
    l1 += __shfl_xor_sync(attn::kFull, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    bf16* o0 = p.o + ((static_cast<long long>(b) * p.Tq + r0) * p.H + h) * D;
    bf16* o1 = o0 + 8LL * p.H * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      if (r0 < p.Tq)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack(o[4 * j] / den0, o[4 * j + 1] / den0);
      if (r0 + 8 < p.Tq)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (D, T, heads, B) bf16 view at `ptr` with element strides (st, sh,
// sb) of T, heads and B, read as boxes of 64 columns x `rows` positions of
// one head, 128-byte swizzled; positions past T read as zeros.
CUresult make_map(CUtensorMap* map, const void* ptr, int D, int T,
                  int heads, int B, long long st, long long sh, long long sb,
                  int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A failed descriptor returns kMapError + its CUresult.
constexpr int kMapError = 10000;

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int KH, const long long* st, int causal,
           int window, int q_off, float scale, cudaStream_t stream) {
  using C = Tile<D>;
  // (an empty k/v loads no tile; its descriptor only needs to be valid)
  const int tk = Tk > 0 ? Tk : 1;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(&qm, q, D, Tq, H, B, st[1], st[2], st[0], kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(&km, k, D, tk, KH, B, st[4], st[5], st[3], C::BK);
  if (r == CUDA_SUCCESS)
    r = make_map(&vm, v, D, tk, KH, B, st[7], st[8], st[6], C::BK);
  if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape p{static_cast<bf16*>(o), Tq, Tk, H, KH, causal, window,
                q_off, scale * kLog2e};
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_kernel_wgmma<D><<<grid, kThreads, C::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Tq, int Tk, int H, int KH, int D, const long long* st,
             int causal, int window, int q_off, float scale,
             cudaStream_t stream) {
  if (D == 64)
    return launch<64>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, window,
                      q_off, scale, stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, window,
                       q_off, scale, stream);
  if (D == 256)
    return launch<256>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, window,
                       q_off, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// Dynamic shared memory one CTA of the route for `dtype` (0 f32, 1 bf16)
// takes at head dim D; 0 for what the kernel does not take.
extern "C" size_t flash_attention_smem_bytes(int D, int dtype) {
  if (D != 64 && D != 128 && D != 256) return 0;
  if (dtype == 0)
    return sizeof(float) * (simt::kBQ + 2 * simt::kBK) * (D + attn::kPad);
  if (dtype == 1)
    return D == 64 ? tc::Tile<64>::kSmem
                   : D == 128 ? tc::Tile<128>::kSmem : tc::Tile<256>::kSmem;
  return 0;
}

// o (B, Tq, H, D) contiguous <- attention of q over k/v on `stream`.
// `strides` holds the (batch, position, head) element strides of q, k, v
// in that order; the last dimension of each is contiguous.  dtype: 0 f32,
// 1 bf16; D: 64, 128 or 256; q_off >= 0 the position of q's first row.
// Returns the CUDA error of the launch (0 on success), or 10000 + the
// CUresult of a TMA descriptor the driver refused; never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Tq, int Tk, int H, int KH,
                                      int D, const long long* strides,
                                      int causal, int window, int q_off,
                                      float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch_f32<float>(q, k, v, o, B, Tq, Tk, H, KH, D,
                                    strides, causal, window, q_off, scale,
                                    s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, B, Tq, Tk, H, KH, D, strides, causal,
                        window, q_off, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
