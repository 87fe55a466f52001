"""KV caches, full (global attention) and circular-window (local
attention), and their single-device decode attention.

PyTorch port of `repro.models.kvcache`.  One decode step writes each
row's new K/V into its slot, then attends over the valid slots with
`repro_torch.kernels.decode_attention`, which launches the decode kernel
on CUDA tensors and runs its plain version on CPU tensors:

* full cache: slot `pos`, valid positions `<= pos`, so `kv_len =
  clamp(pos + 1, 0, S)`;
* window cache (RecurrentGemma's local attention, `window` slots): slot
  `pos % window`.  The JAX package masks the slots whose absolute
  position is negative: for pos < window those are the slots past pos,
  after that none.  So the valid slots are always the prefix of length
  `min(pos + 1, window)`, and the kernel attends over it as over a full
  cache's prefix; the softmax does not care in which order the ring
  holds the positions.

Unlike the JAX package, the write is in place: a decode step updates the
cache it is given (the serving batch's cache is the whole KV state of
every row, rewritten one token at a time).

Not here: the sequence-sharded flash-decode (`decode_attention_sharded`,
a TPU-mesh `shard_map` with a psum combine) has no meaning on one card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec

__all__ = ["init_full_cache", "init_window_cache", "decode_attention_local",
           "decode_attention", "window_decode_attention"]


def init_full_cache(cfg, batch: int, length: int, device="cuda"):
    kh, dh = cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    return {"k": torch.zeros((batch, length, kh, dh), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, length, kh, dh), dtype=dt,
                             device=device)}


def init_window_cache(cfg, batch: int, device="cuda"):
    return init_full_cache(cfg, batch, cfg.window, device)


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


def window_decode_attention(q, cache, k_new, v_new, pos, cfg,
                            use_kernel=None):
    """Rolling-buffer local attention; buffer slot = abs_pos % window.
    q: (B,1,H,dh); cache k/v: (B,window,K,dh); pos: (B,).  Returns (out
    (B,1,H,dh), the updated cache)."""
    b, _, h, dh = q.shape
    w = cfg.window
    slot = torch.remainder(pos, w)
    ck = _write_slot(cache["k"], k_new[:, 0], slot)
    cv = _write_slot(cache["v"], v_new[:, 0], slot)
    kv_len = (pos.to(torch.int32) + 1).clamp(0, w)
    o = _dec.decode_attention(q[:, 0], ck, cv, kv_len, use_kernel=use_kernel)
    return o.reshape(b, 1, h, dh), {"k": ck, "v": cv}
