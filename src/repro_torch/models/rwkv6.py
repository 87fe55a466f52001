"""RWKV6 "Finch" blocks: PyTorch port of `repro.models.rwkv6`,
data-dependent decay linear attention + channel mix.

Time-mix recurrence (per head, key dim N):
    o_t   = r_t @ (S + diag(u) k_t v_t^T)
    S     <- diag(w_t) S + k_t v_t^T
with per-channel data-dependent decay w_t = exp(-exp(d_t)).

The JAX model runs the recurrence as `recurrence_chunked` when T % 64 ==
0 and as the per-token `recurrence_scan` otherwise and at decode; here it
is one call of `repro_torch.kernels.rwkv6_scan.rwkv6_scan` at every T (the
WKV kernel on CUDA tensors, `recurrence_scan`'s loop on CPU tensors), from
the state of the cache: the same function, in another summation order.

The ddlerp token-shift LoRAs of the reference implementation are kept in
reduced form (single low-rank delta per projection stream), with the JAX
package's casts: the LoRA input is f32 (bf16 x times f32 mu), the mixed
streams are x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv6_scan as _scan

__all__ = ["LORA_RANK", "init_rwkv_block", "time_mix_inputs", "time_mix",
           "channel_mix_terms", "channel_mix", "init_rwkv_state"]

LORA_RANK = 32


def init_rwkv_block(gen: torch.Generator, cfg, device="cuda"):
    """One layer's random weights: the JAX package's leaves, shapes,
    dtypes and scales (mu, w0, u, ln_o, ln_o_b, mu_cm f32 whatever
    `cfg.dtype`)."""
    d, n, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    h = d // n
    dt = cfg.torch_dtype
    s = d ** -0.5

    def mat(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device) * scale

    f32 = dict(dtype=torch.float32, device=device)
    return {
        # --- time mix ---
        "mu": torch.full((5, d), 0.5, **f32),   # r,k,v,w,g shift mixes
        "lora_a": mat((d, LORA_RANK), s),
        "lora_b": mat((LORA_RANK, 5 * d), LORA_RANK ** -0.5) * 0.1,
        "wr": mat((d, d), s),
        "wk": mat((d, d), s),
        "wv": mat((d, d), s),
        "wg": mat((d, d), s),
        "w0": torch.full((d,), 0.5, **f32),     # decay bias
        "u": torch.randn((h, n), generator=gen, **f32) * 0.1,   # bonus
        "ln_o": torch.ones((h, n), **f32),      # per-head groupnorm
        "ln_o_b": torch.zeros((h, n), **f32),
        "wo": mat((d, d), s),
        # --- channel mix ---
        "mu_cm": torch.full((2, d), 0.5, **f32),  # k,r shift mixes
        "ck": mat((d, f), s),
        "cv": mat((f, d), f ** -0.5),
        "cr": mat((d, d), s),
    }


def _token_shift(x, x_prev):
    """x: (B,T,D); x_prev: (B,D) last token of previous segment."""
    prev = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    return prev - x  # RWKV convention: xx = shifted - x


def time_mix_inputs(p, x, x_prev, cfg, cols: slice | None = None):
    """Returns per-stream mixed inputs and the decay/gate tensors.  The
    LoRA deltas, the mixes and the decay's d_t are computed over the
    whole width of x; `p`'s wr/wk/wv/wg may hold a block of the columns
    (a block of the heads), and `cols` takes the same block of the
    decay (all of it when None)."""
    b, t, d = x.shape
    n = cfg.head_dim
    xx = _token_shift(x, x_prev)
    lora_a, lora_b = p["lora_a"].float(), p["lora_b"].float()
    lora = torch.tanh((x + xx * p["mu"][0]).float() @ lora_a)
    delta = (lora @ lora_b).reshape(b, t, 5, d)
    mixed = x[:, :, None, :] + xx[:, :, None, :] * \
        (p["mu"][None, None].to(x.dtype) + delta.to(x.dtype))
    xr, xk, xv, xw, xg = mixed.unbind(2)

    r = (xr @ p["wr"]).reshape(b, t, -1, n)
    k = (xk @ p["wk"]).reshape(b, t, -1, n)
    v = (xv @ p["wv"]).reshape(b, t, -1, n)
    g = F.silu(xg @ p["wg"])
    # data-dependent per-channel decay, in log space:
    #   w = exp(-exp(d))  =>  log w = -exp(d)
    d_t = p["w0"].float() + (xw.float() @ lora_a @ lora_b[:, :d]) * 0.1
    if cols is not None:
        d_t = d_t[..., cols]
    logw = -torch.exp(d_t).reshape(b, t, -1, n)  # <= 0
    return r, k, v, logw, g


def _head_groupnorm(o, scale, bias, eps=64e-5):
    """Per-head norm with the population variance (ddof 0), as
    `jnp.var`."""
    of = o.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, correction=0)
    return (of - mu) * torch.rsqrt(var + eps) * scale + bias


def time_mix(p, x, x_prev, state0, cfg, use_kernel=None,
             cols: slice | None = None, mm=torch.matmul):
    """Full RWKV6 attention replacement.  state0: (B,H,N,N) f32 or None
    (zero).  Returns (out, x_last, state).  With a block of the heads
    (`time_mix_inputs`' `cols`, and the blocks of u, ln_o, ln_o_b, the
    state and the rows of wo) `out` is this block's term of the sum over
    the heads.  `mm` takes the last product (`wo`'s)."""
    b, t, _ = x.shape
    r, k, v, logw, g = time_mix_inputs(p, x, x_prev, cfg, cols)
    o, state = _scan.rwkv6_scan(r, k, v, logw, p["u"].contiguous(), state0,
                                use_kernel=use_kernel)
    o = _head_groupnorm(o, p["ln_o"], p["ln_o_b"])
    o = o.reshape(b, t, -1).to(x.dtype) * g
    return mm(o, p["wo"]), x[:, -1, :], state


def channel_mix_terms(p, x, x_prev, mm=torch.matmul):
    """The channel mix's value product (kk @ cv, taken by `mm`; a pending
    sum when ck/cv hold a block of d_ff) and its gate's input xr."""
    xx = _token_shift(x, x_prev)
    xk = x + xx * p["mu_cm"][0].to(x.dtype)
    xr = x + xx * p["mu_cm"][1].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p["ck"]))
    return mm(kk, p["cv"]), xr


def channel_mix(p, x, x_prev):
    """RWKV6 FFN.  Returns (out, x_last)."""
    kv, xr = channel_mix_terms(p, x, x_prev)
    return torch.sigmoid(xr @ p["cr"]) * kv, x[:, -1, :]


def init_rwkv_state(cfg, batch: int, device="cuda"):
    d, n = cfg.d_model, cfg.head_dim
    h = d // n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "s": torch.zeros((batch, h, n, n), **f32),
        "shift_tm": torch.zeros((batch, d), **f32),
        "shift_cm": torch.zeros((batch, d), **f32),
    }
