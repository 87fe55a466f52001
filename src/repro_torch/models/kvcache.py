"""KV cache of global attention and its single-device decode attention.

PyTorch port of the full-cache half of `repro.models.kvcache`.  One
decode step writes each row's new K/V into its slot `pos`, then attends
over positions `<= pos`: `kv_len = clamp(pos + 1, 0, S)` handed to
`repro_torch.kernels.decode_attention`, which launches the decode kernel
on CUDA tensors and runs its plain version on CPU tensors.

Unlike the JAX package, the write is in place: a decode step updates the
cache it is given (the serving batch's cache is the whole KV state of
every row, rewritten one token at a time).

Not here: the sequence-sharded flash-decode (`decode_attention_sharded`,
a TPU-mesh `shard_map` with a psum combine) has no meaning on one card,
and the circular window cache of local attention (`init_window_cache`,
`window_decode_attention`) comes with the recurrentgemma slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec

__all__ = ["init_full_cache", "decode_attention_local", "decode_attention"]


def init_full_cache(cfg, batch: int, length: int, device="cuda"):
    kh, dh = cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    return {"k": torch.zeros((batch, length, kh, dh), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, length, kh, dh), dtype=dt,
                             device=device)}


def _write_slot(buf, new, idx):
    """buf: (B,S,K,dh); new: (B,K,dh); idx: (B,) — one-slot write per batch
    row, in place, tolerant of out-of-range idx (writes the existing value
    back, so nothing changes)."""
    b, s = buf.shape[:2]
    rows = torch.arange(b, device=buf.device)
    idx_c = idx.long().clamp(0, s - 1)
    in_range = ((idx >= 0) & (idx < s))[:, None, None]
    buf[rows, idx_c] = torch.where(in_range, new.to(buf.dtype),
                                   buf[rows, idx_c])
    return buf


def decode_attention_local(q, cache, k_new, v_new, pos, cfg,
                           use_kernel=None):
    """q: (B,1,H,dh); cache k/v: (B,S,K,dh); pos: (B,) absolute position of
    the new token.  Returns (out (B,1,H,dh), the updated cache)."""
    b, _, h, dh = q.shape
    s = cache["k"].shape[1]
    ck = _write_slot(cache["k"], k_new[:, 0], pos)
    cv = _write_slot(cache["v"], v_new[:, 0], pos)
    kv_len = (pos.to(torch.int32) + 1).clamp(0, s)
    o = _dec.decode_attention(q[:, 0], ck, cv, kv_len, use_kernel=use_kernel)
    return o.reshape(b, 1, h, dh), {"k": ck, "v": cv}


def decode_attention(q, cache, k_new, v_new, pos, cfg, mesh=None,
                     use_kernel=None):
    if mesh is not None:
        raise NotImplementedError(
            "the sequence-sharded decode attention is TPU-mesh code with no "
            "counterpart on one card; pass mesh=None")
    return decode_attention_local(q, cache, k_new, v_new, pos, cfg,
                                  use_kernel)
