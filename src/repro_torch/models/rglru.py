"""RecurrentGemma / Griffin recurrent block: PyTorch port of
`repro.models.rglru`.

Recurrent block (Griffin):
    u     = x @ W_x            (lru width)
    u_c   = causal depthwise conv1d(u, width 4)
    r_t   = sigmoid(u_c * w_r + b_r)          (per-channel gates — the
    i_t   = sigmoid(u_c * w_i + b_i)           block-diagonal gates of the
    a_t   = exp(-c * softplus(lam) * r_t)      paper reduced to diagonal)
    h_t   = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_c_t)
    out   = (h * gelu(x @ W_gate)) @ W_out

The JAX model runs the recurrence as a chunked `lax.associative_scan` at
prefill and as `rglru_step` at decode; here both are one call of
`repro_torch.kernels.rglru_scan.rglru_scan` (the RG-LRU kernel on CUDA
tensors, its sequential plain version on CPU tensors), which takes the
state h and returns the last one: the same function, summed in order.
The conv state is kept in f32 and cast back to x's dtype, as there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import rglru_scan as _scan
from repro_torch.models.layers import _gelu

__all__ = ["C_RGLRU", "init_rec_block", "rec_block", "init_rec_state"]

C_RGLRU = _scan.C_RGLRU


def init_rec_block(gen: torch.Generator, cfg, device="cuda"):
    """One layer's random weights: the JAX package's leaves, shapes,
    dtypes and scales (the gate parameters f32 whatever `cfg.dtype`)."""
    d, w = cfg.d_model, cfg.lru_width
    dt = cfg.torch_dtype

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device) * scale

    zeros = lambda: torch.zeros((w,), dtype=torch.float32, device=device)
    return {
        "wx": normal((d, w), d ** -0.5),
        "wgate": normal((d, w), d ** -0.5),
        "wout": normal((w, d), w ** -0.5),
        "conv": normal((cfg.conv_width, w), 0.1),
        "w_r": zeros(), "b_r": zeros(), "w_i": zeros(), "b_i": zeros(),
        # a ~ uniform(0.9, 0.999) at r = 0.5: the standard LRU init
        "lam": torch.linspace(2.0, 6.0, w, dtype=torch.float32,
                              device=device),
    }


def _conv1d_causal(u, kernel, state=None):
    """Depthwise causal conv.  u: (B,T,W); kernel: (cw,W); state:
    (B,cw-1,W) trailing inputs of the previous segment.  The taps are
    summed in x's dtype from tap 0 up, as the JAX package's Python `sum`
    does."""
    cw, t = kernel.shape[0], u.shape[1]
    if state is None:
        state = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([state.to(u.dtype), u], dim=1)
    out = ext[:, :t] * kernel[0]
    for i in range(1, cw):
        out = out + ext[:, i:i + t] * kernel[i]
    return out, ext[:, -(cw - 1):].float()


def rec_block(p, x, state, cfg, use_kernel=None, mm=torch.matmul):
    """Full Griffin recurrent block.  state: {"h": (B,W) f32, "conv":
    (B,cw-1,W) f32} or None.  Returns (out, new_state).  With a block of
    the W channels (the columns of wx, wgate and conv, the gates, the
    state and the rows of wout) `out` is this block's term of the sum
    over the channels.  `mm` takes the last product (`wout`'s)."""
    u = x @ p["wx"]
    u_c, conv_state = _conv1d_causal(u, p["conv"],
                                     state["conv"] if state else None)
    h0 = state["h"].contiguous() if state else None
    # a rank's block of the gates may be a view; the kernel takes them
    # contiguous
    gates = (p[k].contiguous() for k in ("w_r", "b_r", "w_i", "b_i", "lam"))
    h, h_last = _scan.rglru_scan(u_c, *gates, h0, use_kernel=use_kernel)
    gate = _gelu(x @ p["wgate"])
    out = mm(h.to(x.dtype) * gate, p["wout"])
    return out, {"h": h_last, "conv": conv_state}


def init_rec_state(cfg, batch: int, device="cuda"):
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=torch.float32, device=device),
    }
