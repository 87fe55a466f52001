"""Carrying weights and caches between the JAX package and the port.

Both packages keep the same tree: `embed`, `segments[si][j]{ln1, ln2,
attn{wq, wk, wv, wo[, bq, bk, bv]}, mlp{wi[, wg], wo}}` for an attention
block (global or local), `{ln1, ln2, attn{...}, moe{router, wi, wg,
wo}[, dense{wi[, wg], wo}]}` for a moe block, `{ln1, ln2, rec{wx, wgate,
wout, conv, w_r, b_r, w_i, b_i, lam}, mlp{...}}` for a rec block, `{ln1,
ln2, mu, lora_a, lora_b, wr, wk, wv, wg, w0, u, ln_o, ln_o_b, wo, mu_cm,
ck, cv, cr}` for an rwkv block, with a leading stacked layer axis,
`final_norm`, `head` (untied archs); caches are `[si][j]{k, v}` of (n, B,
S, KH, Dh) (S = window for local attention), `{h, conv}` for rec and
`{s, shift_tm, shift_cm}` for rwkv blocks.  A test hands the JAX package's tree
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
from repro_torch.models.rwkv6 import LORA_RANK
from repro_torch.models.transformer import segments

__all__ = ["params_from_numpy", "cache_from_numpy", "numpy_params",
           "to_tensor"]

# leaves that stay float32 whatever the working dtype, as `init_params`
# makes them in both packages: norm scales, the MoE router, the RG-LRU
# gate parameters, RWKV6's shift mixes, decay bias, bonus and head norm
_F32_LEAVES = ("ln1", "ln2", "final_norm", "router",
               "w_r", "b_r", "w_i", "b_i", "lam",
               "mu", "w0", "u", "ln_o", "ln_o_b", "mu_cm")
# cache leaves that are float32 state whatever the working dtype
_F32_STATE = ("h", "conv", "s", "shift_tm", "shift_cm")


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


def _convert(tree, device, dtype, keep: tuple[str, ...], name=""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, keep, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype, keep, name) for v in tree]
    return to_tensor(tree, device,
                     None if dtype is None or name in keep else dtype)


def params_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None):
    """The port's parameter tree from a nested dict/list of numpy arrays,
    leaf for leaf.  `dtype` (e.g. the config's working dtype) casts every
    leaf but those the JAX package keeps float32 (`_F32_LEAVES`: norm
    scales, the MoE router, the recurrent blocks' gate and decay
    parameters); None keeps each leaf's own dtype."""
    return _convert(tree, resolve_device(device), dtype, _F32_LEAVES)


def cache_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None):
    """The port's cache from a nested list/dict of numpy arrays (K/V of
    global and window caches, the recurrent blocks' states).  `dtype`
    casts the K/V leaves; the states stay float32; None keeps each
    leaf's own dtype."""
    return _convert(tree, resolve_device(device), dtype, _F32_STATE)


def _mlp(normal, cfg, d: int, f: int) -> dict:
    if cfg.mlp in ("swiglu", "gelu_glu"):
        return {"wi": normal((d, f), d ** -0.5),
                "wg": normal((d, f), d ** -0.5),
                "wo": normal((f, d), f ** -0.5)}
    return {"wi": normal((d, f), d ** -0.5),
            "wo": normal((f, d), f ** -0.5)}


def _attention(normal, cfg, n: int) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": normal((d, h * dh), d ** -0.5),
            "wk": normal((d, kh * dh), d ** -0.5),
            "wv": normal((d, kh * dh), d ** -0.5),
            "wo": normal((h * dh, d), (h * dh) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=np.zeros((n, h * dh), np.float32),
                    bk=np.zeros((n, kh * dh), np.float32),
                    bv=np.zeros((n, kh * dh), np.float32))
    return attn


def _rec(normal, cfg, n: int) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    zeros = np.zeros((n, w), np.float32)
    return {"wx": normal((d, w), d ** -0.5),
            "wgate": normal((d, w), d ** -0.5),
            "wout": normal((w, d), w ** -0.5),
            "conv": normal((cfg.conv_width, w), 0.1),
            "w_r": zeros, "b_r": zeros.copy(), "w_i": zeros.copy(),
            "b_i": zeros.copy(),
            "lam": np.tile(np.linspace(2.0, 6.0, w, dtype=np.float32),
                           (n, 1))}


def _rwkv(normal, cfg, n: int) -> dict:
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    h = d // hd
    full = lambda shape, x: np.full((n, *shape), x, np.float32)
    return {"mu": full((5, d), 0.5),
            "lora_a": normal((d, LORA_RANK), d ** -0.5),
            "lora_b": normal((LORA_RANK, 5 * d), 0.1 * LORA_RANK ** -0.5),
            "wr": normal((d, d), d ** -0.5),
            "wk": normal((d, d), d ** -0.5),
            "wv": normal((d, d), d ** -0.5),
            "wg": normal((d, d), d ** -0.5),
            "w0": full((d,), 0.5),
            "u": normal((h, hd), 0.1),
            "ln_o": full((h, hd), 1.0),
            "ln_o_b": full((h, hd), 0.0),
            "wo": normal((d, d), d ** -0.5),
            "mu_cm": full((2, d), 0.5),
            "ck": normal((d, f), d ** -0.5),
            "cv": normal((f, d), f ** -0.5),
            "cr": normal((d, d), d ** -0.5)}


def _block(rng, cfg, n: int, btype: str) -> dict:
    d = cfg.d_model

    def normal(shape, scale):
        return rng.standard_normal((n, *shape), dtype=np.float32) * \
            np.float32(scale)

    p = {"ln1": np.zeros((n, d), np.float32),
         "ln2": np.zeros((n, d), np.float32)}
    if btype == "rwkv":
        p.update(_rwkv(normal, cfg, n))
        return p
    if btype == "rec":
        p["rec"] = _rec(normal, cfg, n)
        p["mlp"] = _mlp(normal, cfg, d, cfg.d_ff)
        return p
    p["attn"] = _attention(normal, cfg, n)
    if btype in ("attn", "lattn"):
        p["mlp"] = _mlp(normal, cfg, d, cfg.d_ff)
        return p
    e, f = cfg.num_experts, cfg.d_ff
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
    stacked over the segment's layers: an attention block's (global or
    local) wq, wk, wv, wo and its MLP's wi, wg, wo; a moe block's wq, wk,
    wv, wo, router, expert wi, wg, wo and its dense residual MLP's wi, wg,
    wo; a rec block's wx, wgate, wout, conv and its MLP's wi, wg, wo; an
    rwkv block's lora_a, lora_b, wr, wk, wv, wg, u, wo, ck, cv, cr; then
    head.  The scales are those of `init_params`: N(0, 1) times
    fan_in^-0.5 (0.1 for a rec block's conv and an rwkv block's bonus u,
    0.1 x 32^-0.5 for lora_b), zero norm scales and biases, and the
    constant leaves `init_params` sets (lam = linspace(2, 6), mu and w0
    = 0.5, ln_o = 1, zero gate parameters).  Load it with
    `params_from_numpy(tree, device, cfg.torch_dtype)`, or into the JAX
    package with the same casts (the leaves `_F32_LEAVES` names stay
    float32 in both)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    tree: dict = {}
    if cfg.embed_inputs:
        tree["embed"] = rng.standard_normal((cfg.vocab, d),
                                            dtype=np.float32) * \
            np.float32(d ** -0.5)
    tree["segments"] = [[_block(rng, cfg, n, t) for t in types]
                        for types, n in segments(cfg)]
    tree["final_norm"] = np.zeros((d,), np.float32)
    if not cfg.tie_embeddings:
        tree["head"] = rng.standard_normal((d, cfg.vocab),
                                           dtype=np.float32) * \
            np.float32(d ** -0.5)
    return tree
