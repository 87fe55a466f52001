"""Shared model layers: norms, RoPE/M-RoPE, MLPs, flash attention.

PyTorch port of `repro.models.layers`.  Design rules (framework-wide):
  * all matmuls run in the config dtype (bf16 on the card), all
    reductions (softmax, norm statistics) accumulate in f32;
  * attention never materialises an O(T^2) score tensor: on CPU tensors
    `flash_attention` is the plain block scan carrying (m, l, acc) flash
    statistics, on CUDA tensors the hand-written flash kernel
    (`repro_torch.kernels.flash_attention`, which owns that choice);
  * a sliding `window` reduces the visible KV range to the causal band.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis import cost
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention

__all__ = ["NEG_INF", "rmsnorm", "init_rmsnorm", "rope_freqs", "apply_rope",
           "apply_mrope", "init_mlp", "apply_mlp", "flash_attention",
           "attention_ref", "init_attention", "qkv"]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def init_rmsnorm(d: int, device="cuda"):
    return torch.zeros((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE and Qwen2-VL's 3D M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _device_freqs(head_dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    """`rope_freqs` as f32 on `device`, copied there once: a copy from
    host memory waits for the device's queue to drain, and every layer
    of every decode step needs it.  A constant: a cost counter does not
    count its making."""
    with cost.uncounted():
        return torch.as_tensor(rope_freqs(head_dim, theta),
                               dtype=torch.float32, device=device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, Dh) rotated by angles (..., T, 1, Dh/2), in f32."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., T, H, Dh); positions: broadcastable to (..., T)."""
    freqs = _device_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs        # (..., T, Dh/2)
    return _rotate(x, ang[..., None, :])


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]):
    """Qwen2-VL multimodal RoPE: positions3 (..., T, 3) = (t, h, w) ids;
    the head_dim/2 frequency bands are split into `sections` (t|h|w)."""
    dh = x.shape[-1]
    assert sum(sections) == dh // 2, (sections, dh)
    freqs = _device_freqs(dh, theta, x.device)
    pos = positions3.float()[..., _mrope_select(sections, x.device)]
    return _rotate(x, (pos * freqs)[..., None, :])


@functools.lru_cache(maxsize=None)
def _mrope_select(sections: tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """Which of the three position streams drives each frequency band,
    on `device` once (a constant, as `_device_freqs`)."""
    with cost.uncounted():
        return torch.as_tensor(
            [i for i, s in enumerate(sections) for _ in range(s)],
            device=device)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None,
             device="cuda"):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    s_in, s_out = d ** -0.5, f ** -0.5
    if cfg.mlp in ("swiglu", "gelu_glu"):
        return {
            "wi": _normal(gen, (d, f), dt, device) * s_in,
            "wg": _normal(gen, (d, f), dt, device) * s_in,
            "wo": _normal(gen, (f, d), dt, device) * s_out,
        }
    return {
        "wi": _normal(gen, (d, f), dt, device) * s_in,
        "wo": _normal(gen, (f, d), dt, device) * s_out,
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg):
    if cfg.mlp in ("swiglu", "gelu_glu"):
        act = F.silu if cfg.mlp == "swiglu" else _gelu
        h = act(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = _gelu(x @ p["wi"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  kv_len=None):
    """Naive O(T^2) oracle (tests only)."""
    b, tq, h, dh = q.shape
    _, tk, kh, _ = k.shape
    g = h // kh
    dev = q.device
    qr = q.reshape(b, tq, kh, g, dh).float() * dh ** -0.5
    s = torch.einsum("btkgd,bskd->btkgs", qr, k.float())
    qpos = q_offset + torch.arange(tq, device=dev)
    kpos = torch.arange(tk, device=dev)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    mask = mask[None]
    if kv_len is not None:
        mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return o.reshape(b, tq, h, dh).to(q.dtype)


def init_attention(gen: torch.Generator, cfg, device="cuda"):
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    p = {
        "wq": _normal(gen, (d, h * dh), dt, device) * d ** -0.5,
        "wk": _normal(gen, (d, kh * dh), dt, device) * d ** -0.5,
        "wv": _normal(gen, (d, kh * dh), dt, device) * d ** -0.5,
        "wo": _normal(gen, (h * dh, d), dt, device) * (h * dh) ** -0.5,
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kh * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kh * dh,), dtype=dt, device=device)
    return p


def qkv(p, x, cfg, positions):
    """Project + position-encode. positions: (B,T) ids or (B,T,3) for mrope."""
    b, t, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v
