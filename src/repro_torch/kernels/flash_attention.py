"""Prefill attention: Hopper flash kernel and its plain version.

PyTorch port of the JAX package's attention for a whole sequence: the
pure-JAX block scan `repro.models.layers.flash_attention` (the path the
JAX models run) and the Pallas kernel
`repro.kernels.flash_attention.flash_attention` it stands in for.

* `flash_attention_plain` is the block scan of `layers.py:119-183`: KV
  blocks of `block` keys carrying f32 (m, l, acc) flash statistics, with
  `q_offset`, `kv_len`, `kv_start` and `window` masks; q is scaled in its
  own dtype, then cast to f32, as there.  It runs on any device.
* the CUDA kernel `csrc/flash_attention.cu` for `sm_90a` (causal or not,
  sliding window, GQA, any sequence length, head dim 64/128/256): bf16
  on the tensor cores (`wgmma` on TMA-fed tiles, the scores scaled by
  dh^-0.5 in f32, P split into bf16 hi + lo parts for P V), f32 on the
  CUDA cores (q scaled in f32, as the Pallas kernel does).  With bf16 inputs and head
  dim 128 either rounds differently from the plain version, which scales
  q in bf16 (the scales of dims 64 and 256 are powers of two).  Built
  with `nvcc` at first use, bound with ctypes; the TMA descriptors are
  encoded in the C entry point through the driver entry point the CUDA
  runtime hands out, so the build needs nothing but `nvcc`.

`flash_attention` owns the choice: CUDA tensors launch the kernel (and
count it in `flash_attention.launches`) or raise, CPU tensors run the
plain version; `use_kernel="plain"` forces the plain version anywhere.
Where autograd records, the kernel's backward is the plain version's
vector-Jacobian product (`common.KernelVjp`): the JAX models train
through the pure-JAX block scan and no Pallas backward exists.
`cost` is the kernel's count for a cost counter (`analysis.cost`) and
its bound: 4 B H Dh FLOPs a visible (query, key) pair, q, k, v read and
the output written once.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import common

__all__ = ["flash_attention", "flash_attention_plain", "smem_bytes", "build",
           "cost", "visible_pairs", "NEG_INF"]

NEG_INF = -1e30
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block: int = 512, q_offset: int = 0,
                          kv_len: torch.Tensor | None = None,
                          kv_start: torch.Tensor | None = None):
    """Memory-bounded multi-head attention, the plain block scan.

    q: (B, Tq, H, Dh);  k/v: (B, Tk, K, Dh) with H = K * q_per_kv.
    `q_offset` is the absolute position of q[0] (decode / chunked
    prefill).  `window`>0 masks keys older than `window` positions.
    `kv_len` (B,) masks invalid cache tail; `kv_start` (B,) masks keys
    before it.  Returns (B, Tq, H, Dh) in q's dtype.
    """
    b, tq, h, dh = q.shape
    _, tk, kh, _ = k.shape
    g = h // kh
    dev = q.device
    qr = (q * dh ** -0.5).reshape(b, tq, kh, g, dh).float()
    qpos = q_offset + torch.arange(tq, device=dev)
    pad = -tk % block
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, tq, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, tq, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, tq, kh, g, dh), dtype=torch.float32, device=dev)
    for lo in range(0, tk, block):
        kpos = lo + torch.arange(block, device=dev)
        s = torch.einsum("btkgd,bskd->btkgs", qr,
                         kp[:, lo:lo + block].float())
        mask = torch.ones((tq, block), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        mask &= (kpos < tk)[None, :]
        mask = mask[None]
        if kv_len is not None:
            mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
        if kv_start is not None:
            mask = mask & (kpos[None, None, :] >= kv_start[:, None, None])
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "btkgs,bskd->btkgd", p, vp[:, lo:lo + block].float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, tq, h, dh).to(q.dtype)


def visible_pairs(tq: int, tk: int, causal: bool = True,
                  window: int = 0) -> int:
    """(query, key) pairs a prompt attends: query i (from position 0)
    sees keys up to i, within `window`, when causal; all tk otherwise."""
    if not causal:
        return tq * tk
    cap = min(tk, window) if window else tk
    if tq <= cap:
        return tq * (tq + 1) // 2
    return cap * (cap + 1) // 2 + (tq - cap) * cap


def cost(b: int, tq: int, tk: int, h: int, kh: int, dh: int,
         dtype: torch.dtype, *, causal: bool = True, window: int = 0) -> dict:
    """The kernel's count (`analysis.cost.work`): 4 B H Dh FLOPs a visible
    pair (the two products) in `dtype`'s class, and q, k, v read and the
    output written once."""
    elem = torch.empty((), dtype=dtype).element_size()
    return _cost.work(4 * b * h * dh * visible_pairs(tq, tk, causal, window),
                      _cost.dtype_class(dtype),
                      elem * b * (2 * tq * h + 2 * tk * kh) * dh)


def _work(q, k, v, *, causal: bool, window: int) -> dict:
    b, tq, h, dh = q.shape
    return cost(b, tq, k.shape[1], h, k.shape[2], dh, q.dtype, causal=causal,
                window=window)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/flash_attention.cu` into `kernels/build/` (once per
    source content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [ci] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ci, ci, ctypes.c_float, vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_smem_bytes.argtypes = [ci, ci]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t


def smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one CTA of the kernel takes at `head_dim`
    for `dtype` (bf16: q and two stages of k and v tiles; f32: the
    CUDA-core kernel's f32 tiles), as the source computes it."""
    lib = common.library(SOURCE, _declare)
    return lib.flash_attention_smem_bytes(head_dim, _DTYPES[dtype])


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype != q.dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    if t.dim() != 4 or t.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name} has shape {tuple(t.shape)}: expected "
                         f"(B, T, heads, {q.shape[-1]})")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) or \
            t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dimension and "
                         f"16-byte aligned rows (strides {t.stride()})")


def _launch(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    the current stream."""
    b, tq, h, dh = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes bf16 or f32, not {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {HEAD_DIMS}, not {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    if k.shape != v.shape or k.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match, with batch {b}")
    tk, kh = k.shape[1], k.shape[2]
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    lib = common.library(SOURCE, _declare)
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, tq, tk, h, kh, dh, strides, int(bool(causal)),
        int(window), dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block: int = 512, q_offset: int = 0,
                    kv_len: torch.Tensor | None = None,
                    kv_start: torch.Tensor | None = None, use_kernel=None):
    """Multi-head attention of q (B, Tq, H, Dh) over k/v (B, Tk, K, Dh)
    (see `flash_attention_plain` for the arguments).

    CUDA tensors launch the flash kernel, which covers the prefill form
    (`q_offset` 0, no `kv_len`/`kv_start`), as the Pallas kernel does;
    the other form raises `NotImplementedError` on CUDA.  CPU tensors, or
    `use_kernel="plain"`, run `flash_attention_plain`;
    `use_kernel="kernel"` raises on CPU.  Under autograd the kernel's
    output takes the plain version's gradient (`common.with_plain_vjp`,
    counted in `flash_attention.backward_recomputes`).  Under a cost
    counter CPU and meta tensors take the kernel's route
    (`common.stand_in`)."""
    how = common.route(use_kernel, q.device)
    if how == "plain":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block=block, q_offset=q_offset,
                                     kv_len=kv_len, kv_start=kv_start)
    if q_offset or kv_len is not None or kv_start is not None:
        raise NotImplementedError(
            "the flash kernel takes q_offset=0 and no kv_len/kv_start, as "
            "the Pallas kernel does: attend over the whole sequence with "
            "causal=True and a window instead")
    if how == "stand-in":
        plain = functools.partial(flash_attention_plain, causal=causal,
                                  window=window, block=block)
        return common.with_plain_vjp(flash_attention, common.stand_in(
            "flash_attention", functools.partial(
                _work, causal=causal, window=window), plain,
            lambda q, k, v: torch.empty_like(q)), plain, q, k, v)
    return _with_plain_vjp(q, k, v, causal=causal, window=window,
                           block=block)


def _with_plain_vjp(q, k, v, *, causal: bool, window: int, block: int):
    """The kernel, with `flash_attention_plain`'s gradient."""
    return common.with_plain_vjp(
        flash_attention,
        functools.partial(_kernel, causal=causal, window=window),
        functools.partial(flash_attention_plain, causal=causal,
                          window=window, block=block), q, k, v)


def _kernel(q, k, v, *, causal: bool, window: int) -> torch.Tensor:
    with _cost.kernel("flash_attention", lambda: _work(
            q, k, v, causal=causal, window=window)):
        out = _launch(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.backward_recomputes = 0
