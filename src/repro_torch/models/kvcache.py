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

Over a mesh (`decode_attention(..., mesh=...)`), the full cache is
sharded batch -> data axes, sequence -> `model`, and one decode step
runs the reference's flash-decode combine (`decode_attention_sharded`):
the rank whose sequence block holds a row's position writes the token,
every rank computes its block's partial statistics (m, l, o) in f32, and
the blocks merge by one max and two sums over `model`: the collective is
O(B H dh), never O(S).  It is the reference's einsum body in plain
torch (the reference runs no kernel there either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec

__all__ = ["init_full_cache", "init_window_cache", "decode_attention_local",
           "decode_attention_sharded", "decode_attention",
           "window_decode_attention"]

NEG_INF = -1e30


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


def decode_attention_sharded(q, cache, k_new, v_new, pos, cfg, mesh,
                             data_axes=("data",), model_axis="model"):
    """The sequence-sharded flash-decode on this rank's blocks: q, k_new,
    v_new (B_loc, 1, ...) and pos (B_loc,) are its rows of the batch
    (split over `data_axes`), cache k/v (B_loc, S_loc, K, dh) its block of
    the (B, S) cache (sequence split over `model_axis`).  Writes the
    token into the block that holds `pos`, in place, and returns (this
    rank's rows of the output (B_loc, 1, H, dh), the cache)."""
    b, _, h, dh = q.shape
    kh = cfg.num_kv_heads
    g = h // kh
    ck, cv = cache["k"], cache["v"]
    s_loc = ck.shape[1]
    lo = mesh.axis_index(model_axis) * s_loc
    # the token goes where its position lies, outside the combine
    local = (pos.long() - lo).to(pos.dtype)
    _write_slot(ck, k_new[:, 0], local)
    _write_slot(cv, v_new[:, 0], local)
    qr = (q[:, 0].reshape(b, kh, g, dh) * dh ** -0.5).float()
    sc = torch.einsum("bkgd,bskd->bkgs", qr, ck.float())
    valid = (lo + torch.arange(s_loc, device=q.device))[None, :] \
        <= pos.long()[:, None]
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    # partial flash statistics + logsumexp-weighted combine
    m_loc = sc.amax(-1)                                      # (B,K,G)
    p = torch.exp(sc - m_loc[..., None])
    l_loc = p.sum(-1)
    o_loc = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    m_glob = mesh.all_reduce(m_loc, model_axis, "max")
    corr = torch.exp(m_loc - m_glob)
    l_glob = mesh.all_reduce(l_loc * corr, model_axis)
    o_glob = mesh.all_reduce(o_loc * corr[..., None], model_axis)
    o = o_glob / torch.clamp(l_glob[..., None], min=1e-30)
    return o.reshape(b, 1, h, dh).to(q.dtype), {"k": ck, "v": cv}


def decode_attention(q, cache, k_new, v_new, pos, cfg, mesh=None,
                     use_kernel=None, data_axes=("data",)):
    """`decode_attention_local` (the decode kernel on the card), or over
    `mesh` (a `launch.mesh.Mesh`) `decode_attention_sharded`."""
    if mesh is None:
        return decode_attention_local(q, cache, k_new, v_new, pos, cfg,
                                      use_kernel)
    from repro_torch.launch.mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh or "
                        f"None, not {type(mesh).__name__}")
    return decode_attention_sharded(q, cache, k_new, v_new, pos, cfg, mesh,
                                    data_axes)


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
