"""Runnable examples of the port (`python -m repro_torch.examples.<name>`),
counterparts of the JAX package's `examples/`: `quickstart`, `train_lm`,
`paper_repro`, `serve_models`, `serve_multitenant`, `serve_online` and
`serve_faulty`.  Each takes `--device` (default "cuda").

The smoke-config rule: an example whose JAX original serves a model's
smoke config (`ModelConfig.smoke()`, head dim 16) runs that config on
the CPU exactly, and on the card with head dim 64, the narrowest the
card's attention kernels take, every other field unchanged
(`smoke_config`); it prints the config it ran on its first line
(`config_line`)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import base as cb

__all__ = ["smoke_config", "config_line", "CARD_HEAD_DIM"]

CARD_HEAD_DIM = 64


def smoke_config(arch: str, device):
    """`arch`'s smoke config for `device` (the module docstring's rule),
    registered under its name so that the launchers find it."""
    cfg = cb.get_config(arch).smoke()
    if torch.device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=CARD_HEAD_DIM)
    return cb.register(cfg)


def config_line(cfg, device) -> str:
    """The line an example prints first: the config it runs, and where."""
    moe = (f" experts={cfg.num_experts} top_k={cfg.top_k}"
           if cfg.is_moe else "")
    return (f"# config {cfg.name} on {torch.device(device).type}: "
            f"layers={cfg.num_layers} d_model={cfg.d_model} "
            f"heads={cfg.num_heads}/{cfg.num_kv_heads} "
            f"head_dim={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab}"
            f"{moe} dtype={cfg.dtype}")
