"""Carrying weights and caches between the JAX package and the port.

Both packages keep the same tree: `embed`, `segments[si][j]{ln1, ln2,
attn{wq, wk, wv, wo[, bq, bk, bv]}, mlp{wi[, wg], wo}}` for an attention
block, `{ln1, ln2, attn{...}, moe{router, wi, wg, wo}[, dense{wi[, wg],
wo}]}` for a moe block, with a leading stacked layer axis, `final_norm`,
`head` (untied archs); caches are
`[si][j]{k, v}` of (n, B, S, KH, Dh).  A test hands the JAX package's tree
over as numpy (`jax.tree_util.tree_map(np.asarray, params)`, bf16 leaves
arriving as ml_dtypes' bfloat16) and `params_from_numpy` maps it leaf for
leaf onto tensors.

`numpy_params` draws one tree with numpy alone, so that both packages can
load the same weights on a machine that has only one of them (the card's
machine has no JAX).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import segments, tree_map

__all__ = ["params_from_numpy", "cache_from_numpy", "numpy_params",
           "to_tensor"]

# leaves that stay float32 whatever the working dtype, as `init_params`
# makes them in both packages
_F32_LEAVES = ("ln1", "ln2", "final_norm", "router")


def to_tensor(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """One numpy array as a tensor on `device` (bfloat16 arrays of
    ml_dtypes included), cast to `dtype` if given."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # e.g. np.asarray of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(tree, device, dtype, name=""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype, name) for v in tree]
    keep = dtype is None or name in _F32_LEAVES
    return to_tensor(tree, device, None if keep else dtype)


def params_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None):
    """The port's parameter tree from a nested dict/list of numpy arrays,
    leaf for leaf.  `dtype` (e.g. the config's working dtype) casts every
    leaf but the norm scales and the MoE router, which stay float32; None
    keeps each leaf's own dtype."""
    return _convert(tree, resolve_device(device), dtype)


def cache_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None):
    """The port's cache from a nested list/dict of numpy arrays."""
    dev = resolve_device(device)
    return tree_map(lambda a: to_tensor(a, dev, dtype), tree)


def _mlp(normal, cfg, d: int, f: int) -> dict:
    if cfg.mlp in ("swiglu", "gelu_glu"):
        return {"wi": normal((d, f), d ** -0.5),
                "wg": normal((d, f), d ** -0.5),
                "wo": normal((f, d), f ** -0.5)}
    return {"wi": normal((d, f), d ** -0.5),
            "wo": normal((f, d), f ** -0.5)}


def _block(rng, cfg, n: int, btype: str) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f, e = cfg.d_ff, cfg.num_experts

    def normal(shape, scale):
        return rng.standard_normal((n, *shape), dtype=np.float32) * \
            np.float32(scale)

    attn = {"wq": normal((d, h * dh), d ** -0.5),
            "wk": normal((d, kh * dh), d ** -0.5),
            "wv": normal((d, kh * dh), d ** -0.5),
            "wo": normal((h * dh, d), (h * dh) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=np.zeros((n, h * dh), np.float32),
                    bk=np.zeros((n, kh * dh), np.float32),
                    bv=np.zeros((n, kh * dh), np.float32))
    p = {"ln1": np.zeros((n, d), np.float32),
         "ln2": np.zeros((n, d), np.float32), "attn": attn}
    if btype == "attn":
        p["mlp"] = _mlp(normal, cfg, d, f)
        return p
    p["moe"] = {"router": normal((d, e), d ** -0.5),
                "wi": normal((e, d, f), d ** -0.5),
                "wg": normal((e, d, f), d ** -0.5),
                "wo": normal((e, f, d), f ** -0.5)}
    if cfg.dense_ff_residual:
        p["dense"] = _mlp(normal, cfg, d, cfg.dense_ff_residual)
    return p


def numpy_params(cfg, seed: int) -> dict:
    """A float32 parameter tree drawn with `np.random.default_rng(seed)`,
    in a fixed leaf order: embed; then per segment, per block, each leaf
    stacked over the segment's layers: the attention's wq, wk, wv, wo,
    then an attn block's MLP wi, wg, wo, or a moe block's router, expert
    wi, wg, wo and its dense residual MLP's wi, wg, wo; then head.  The
    scales are those of `init_params`: N(0, 1) times fan_in^-0.5, zero
    norm scales and biases.  Load it with `params_from_numpy(tree,
    device, cfg.torch_dtype)`, or into the JAX package with the same
    casts (the router stays float32 in both)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    tree: dict = {}
    if cfg.embed_inputs:
        tree["embed"] = rng.standard_normal((cfg.vocab, d),
                                            dtype=np.float32) * \
            np.float32(d ** -0.5)
    segs = []
    for types, n in segments(cfg):
        seg = []
        for t in types:
            if t not in ("attn", "moe"):
                raise NotImplementedError(
                    f"numpy_params covers the attention and MoE archs, not "
                    f"block type {t!r}")
            seg.append(_block(rng, cfg, n, t))
        segs.append(seg)
    tree["segments"] = segs
    tree["final_norm"] = np.zeros((d,), np.float32)
    if not cfg.tie_embeddings:
        tree["head"] = rng.standard_normal((d, cfg.vocab),
                                           dtype=np.float32) * \
            np.float32(d ** -0.5)
    return tree
