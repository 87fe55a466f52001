"""Serving engine, model half: PyTorch port of `repro.serve.engine`'s
`model_batcher`.

`model_batcher` wires a `ContinuousBatcher` to a model: a queued request
claims a free row of the fixed-width decode batch, its prompt is
prefilled alone (the flash kernel on the card) and its (1, T) cache is
copied into the row of the shared cache; every step then decodes one
token for all rows (the decode kernel on the card).

Not here yet: the slot-aware multi-tenant engine (`SlotServeEngine`,
`Tenant`, `EngineConfig`, over `core.expert_slots`) comes with the MoE
serving slice; `estimate_fleet_contention`, `plan_coresidency` and
`serve_online` with the sched slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.batching import ContinuousBatcher

__all__ = ["model_batcher"]


def model_batcher(cfg, params, batch_size: int, max_len: int, shd=None,
                  device="cuda", use_kernel=None) -> ContinuousBatcher:
    """A ContinuousBatcher wired to the real model: per-row prompt prefill
    writes the (1, T) prefill cache into the shared fixed-width decode
    cache in place; the decode callback is one `decode_step` over the
    whole batch, and the next token is the first argmax of its logits.
    `params` live on `device`."""
    transformer._no_shd(shd)
    dev = resolve_device(device)
    cache = transformer.init_cache(cfg, batch_size, max_len, dev)

    def prefill_row(row, tokens):
        t0 = len(tokens)
        _, row_cache, _ = transformer.prefill(
            cfg, params, {"tokens": np.asarray(tokens)[None, :]},
            use_kernel=use_kernel)
        for seg, row_seg in zip(cache, row_cache):
            for dst, src in zip(seg, row_seg):
                for name in dst:
                    # dst: (n, B, S, ...) shared cache; src: (n, 1, t0, ...)
                    dst[name][:, row, :t0] = src[name][:, 0]

    def decode(tokens, positions):
        logits, _, _ = transformer.decode_step(
            cfg, params, {"tokens": tokens, "positions": positions}, cache,
            use_kernel=use_kernel)
        return torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

    return ContinuousBatcher(batch_size, max_len, prefill_row=prefill_row,
                             decode=decode)
