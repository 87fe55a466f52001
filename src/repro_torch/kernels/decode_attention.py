"""Decode attention: Hopper kernel and its plain version.

PyTorch port of the JAX package's Pallas kernel
`repro.kernels.decode_attention.decode_attention`: one query token per
batch row, q (B, H, Dh), against caches (B, S, KH, Dh), each row
attending over its first `kv_len[b]` positions, the G = H / KH query
heads of a kv head sharing its cache rows.

Every version follows the Pallas kernel, not `repro.kernels.ref`: the
scores are scaled in f32, and a row with `kv_len == 0` gives 0 (every
block skipped, l = 0) where `ref.decode_attention_ref` gives the mean of
v (the softmax of an all-masked row is uniform).  The model path always
has kv_len >= 1.

* `decode_attention_plain`: the whole cache at once, masked; any device.
* `decode_attention_split_plain`: the kernel's split-and-merge
  arithmetic in plain PyTorch (`split_plan`'s ranges of the cache, one
  partial (m, l, acc) each, then the merge), for the tests.
* the CUDA kernel `csrc/decode_attention.cu` for `sm_90a` (head dim
  64/128/256, bf16/f32): split-KV across CTAs (`split_plan`, from the
  shapes alone: kv_len never leaves the device), bf16 tiles and tensor-core
  products (f32 on the CUDA cores), then a merge kernel; one C call
  launches both.  Built with `nvcc` at first use, bound with ctypes.

`decode_attention` owns the choice: CUDA tensors launch the kernel (and
count it in `decode_attention.launches`) or raise, CPU tensors run the
plain version; `use_kernel="plain"` forces the plain version anywhere.
`cost` is the kernel's count for a cost counter (`analysis.cost`) and
its bound.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.analysis import cost as _cost
from repro_torch.kernels import common

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_split_plain", "split_plan", "scratch",
           "smem_bytes", "build", "cost"]

NEG_INF = -1e30
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "decode_attention.cu")
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dynamic shared memory a Hopper block may use
_SMEM_LIMIT = 232_448
# cache positions of the kernel's tile: a split covers whole tiles
TILE = 64
# CTAs the split rule aims at: two on each of the H100's 132 SMs
_TARGET_CTAS = 2 * 132


def decode_attention_plain(q, k_cache, v_cache, kv_len):
    """q: (B, H, dh) one token; k/v_cache: (B, S, KH, dh); kv_len: (B,)
    number of valid positions.  Returns (B, H, dh) in q's dtype."""
    b, h, dh = q.shape
    _, s, kh, _ = k_cache.shape
    g = h // kh
    qr = q.float().reshape(b, kh, g, dh) * dh ** -0.5
    sc = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    valid = (torch.arange(s, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])[:, None, None, :]
    sc = torch.where(valid, sc, NEG_INF)
    m = sc.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - m), 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return o.reshape(b, h, dh).to(q.dtype)


def split_plan(batch: int, kv_heads: int, seq: int) -> tuple[int, int]:
    """(splits, positions per split) of the decode kernel's KV axis for a
    cache of `seq` positions: enough splits that batch x kv_heads x splits
    CTAs fill the card twice over, each a whole number of 64-position
    tiles.  It reads the shapes only, never kv_len (which stays on the
    device: the splits past a row's kv_len return at once)."""
    for name, n in (("batch", batch), ("kv_heads", kv_heads), ("seq", seq)):
        if type(n) is not int:
            raise TypeError(f"split_plan takes int shapes, not {name}="
                            f"{type(n).__name__}")
    tiles = max(1, -(-seq // TILE))
    want = max(1, -(-_TARGET_CTAS // max(1, batch * kv_heads)))
    per = max(1, tiles // want)          # tiles a split: at least `want`
    return -(-tiles // per), per * TILE


def decode_attention_split_plain(q, k_cache, v_cache, kv_len):
    """`decode_attention` as the kernel computes it: the cache cut into
    `split_plan`'s ranges, each giving a partial (m, l, acc) per head over
    its positions below kv_len (an empty range gives m = -1e30, l = 0),
    then the merge o = sum w acc / max(sum w l, 1e-30), w = exp(m - max m)
    over the non-empty ranges.  In f32, on any device."""
    b, h, dh = q.shape
    _, s, kh, _ = k_cache.shape
    g = h // kh
    splits, chunk = split_plan(b, kh, s)
    qr = q.float().reshape(b, kh, g, dh)
    lens = kv_len.to(q.device).clamp(0, s)
    m_all, l_all, acc_all = [], [], []
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, s)
        pos = torch.arange(lo, hi, device=q.device)
        valid = (pos[None, :] < lens[:, None])[:, None, None, :]
        sc = torch.einsum("bkgd,bskd->bkgs", qr,
                          k_cache[:, lo:hi].float()) * dh ** -0.5
        sc = torch.where(valid, sc, NEG_INF)
        m = sc.amax(-1)
        p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
        empty = (lens <= lo)[:, None, None]
        m_all.append(torch.where(empty, NEG_INF, m))
        l_all.append(torch.where(empty, 0.0, p.sum(-1)))
        acc_all.append(torch.einsum("bkgs,bskd->bkgd", p,
                                    v_cache[:, lo:hi].float()))
    m, l, acc = (torch.stack(x) for x in (m_all, l_all, acc_all))
    live = l > 0
    top = torch.where(live, m, NEG_INF).amax(0)
    w = torch.where(live, torch.exp(m - top), 0.0)
    den = torch.clamp((w * l).sum(0), min=1e-30)
    o = (w[..., None] * acc).sum(0) / den[..., None]
    return o.reshape(b, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> str:
    """Compile `csrc/decode_attention.cu` into `kernels/build/` (once per
    source content) and return the shared library's path."""
    return common.build(SOURCE, verbose)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = (
        [vp] * 6 + [ci] * 6 + [ctypes.POINTER(ctypes.c_longlong), ci, ci,
                               ctypes.c_float, vp])
    lib.decode_attention_launch.restype = ci
    lib.decode_attention_smem_bytes.argtypes = [ci, ci, ci]
    lib.decode_attention_smem_bytes.restype = ctypes.c_size_t


def smem_bytes(group: int, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one split CTA takes for `group` query heads
    per kv head at `head_dim` in `dtype`, as the source computes it."""
    lib = common.library(SOURCE, _declare)
    return lib.decode_attention_smem_bytes(group, head_dim, _DTYPES[dtype])


def scratch(q: torch.Tensor, seq: int, kv_heads: int):
    """(splits, chunk, f32 scratch) for a decode step of q (B, H, D) over
    a `seq`-position cache of `kv_heads` heads: the partial (acc, m, l) of
    every (batch row, head, split), allocated, never read on the host."""
    b, h, dh = q.shape
    splits, chunk = split_plan(b, kv_heads, seq)
    return splits, chunk, torch.empty(b * h * splits * (dh + 2),
                                      dtype=torch.float32, device=q.device)


def _check_rows(name: str, t: torch.Tensor, q: torch.Tensor,
                ndim: int) -> None:
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype != q.dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    if t.dim() != ndim or t.shape[-1] != q.shape[-1]:
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or \
            t.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dimension and "
                         f"16-byte aligned rows (strides {t.stride()})")


@common.on_tensor_device
def _launch(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    the current stream."""
    b, h, dh = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode kernel takes bf16 or f32, not {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode kernel takes head dim {HEAD_DIMS}, "
                         f"not {dh}")
    _check_rows("q", q, q, 3)
    _check_rows("k_cache", k_cache, q, 4)
    _check_rows("v_cache", v_cache, q, 4)
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b:
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} must match, with batch {b}")
    s, kh = k_cache.shape[1], k_cache.shape[2]
    if kh < 1 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if (kv_len.device != q.device or kv_len.dtype != torch.int32
            or tuple(kv_len.shape) != (b,) or not kv_len.is_contiguous()):
        raise ValueError(f"kv_len must be a contiguous ({b},) int32 tensor "
                         f"on {q.device}")
    lib = common.library(SOURCE, _declare)
    smem = lib.decode_attention_smem_bytes(h // kh, dh, _DTYPES[q.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{h // kh} query heads per kv head need {smem} "
                         f"bytes of shared memory, above the {_SMEM_LIMIT} "
                         f"a Hopper block holds")
    splits, chunk, part = scratch(q, s, kh)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2],
                                      *k_cache.stride()[:3],
                                      *v_cache.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), part.data_ptr(),
        _DTYPES[q.dtype], b, h, kh, s, dh, strides, splits, chunk,
        dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err}")
    return out


def cost(b: int, h: int, kh: int, dh: int, n_len: int,
         dtype: torch.dtype) -> dict:
    """The kernel's count (`analysis.cost.work`) over `n_len` valid cache
    positions in all (the sum of kv_len): 4 H Dh FLOPs a position (the two
    products) in `dtype`'s class; those positions' keys and values, q,
    the output and the int32 kv_len moved once."""
    elem = torch.empty((), dtype=dtype).element_size()
    return _cost.work(4 * n_len * h * dh, _cost.dtype_class(dtype),
                      elem * (2 * n_len * kh * dh + 2 * b * h * dh) + 4 * b)


def _work(q, k_cache, v_cache, kv_len) -> dict:
    """`cost` of a call over the whole cache (a count reads no values)."""
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    return cost(b, h, kh, dh, b * s, q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *, use_kernel=None):
    """Attention of one token per row, q (B, H, dh), over the first
    `kv_len[b]` positions of k/v_cache (B, S, KH, dh).  Returns (B, H,
    dh).  CUDA tensors launch the decode kernel; CPU tensors, or
    `use_kernel="plain"`, run `decode_attention_plain`;
    `use_kernel="kernel"` raises on CPU, and the kernel, which lies on
    no training path, raises where autograd would record.  Under a cost
    counter CPU and meta tensors take the kernel's route
    (`common.stand_in`)."""
    how = common.route(use_kernel, q.device)
    if how == "plain":
        return decode_attention_plain(q, k_cache, v_cache, kv_len)
    common.no_vjp("decode_attention", q, k_cache, v_cache)
    if how == "stand-in":
        return common.stand_in("decode_attention", _work,
                               decode_attention_plain,
                               lambda q, *_: torch.empty_like(q))(
            q, k_cache, v_cache, kv_len)
    with _cost.kernel("decode_attention", lambda: _work(
            q, k_cache, v_cache, kv_len)):
        out = _launch(q, k_cache, v_cache, kv_len)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
