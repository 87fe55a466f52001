"""Serving step builders: prefill and single-token decode under a plan.

PyTorch port of `repro.serve.step`.  The reference jits each step with
the plan's shardings and lets GSPMD place every tensor; here every rank
of a `torch.distributed` job is a process that runs the step on its
blocks, and the model places them by the plan
(`models.transformer`, `sharding.partition`):

* a step takes this rank's blocks of the weights (`plan.shard_params`
  of the whole tree, or the same blocks made otherwise) and the whole
  batch, cut to this rank's rows inside (`plan.input_shardings`);
* prefill returns this rank's block of the last-token logits (vocab over
  `model`), its block of every leaf of the prompt's cache in the decode
  layout, the reference's `out_shardings=cache_sh` (`plan.cache_specs`:
  rows over the data axes; a full K/V cache's sequence, RG-LRU's `h`
  and `conv` channels and RWKV's `s` heads over `model`; window caches
  and token shifts rows only) and the expert loads (global);
* decode takes this rank's block of the cache
  (`transformer.init_cache(..., shd=plan)`) and writes the token into it
  in place, which stands in for the reference's `donate_argnums`.

PyTorch runs eagerly and has no jit: `jit_prefill_step` and
`jit_decode_step` build nothing ahead; they return the per-rank step and
the abstract trees (on the meta device), the tuples the reference
returns, and the step checks each input's shape against `batch_specs`,
the shapes the reference compiles for.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.sharding.partition import ShardingPlan

__all__ = ["abstract_params", "abstract_cache", "make_prefill",
           "make_decode", "jit_prefill_step", "jit_decode_step"]


def abstract_params(cfg):
    """`cfg`'s parameter tree on the meta device (shapes and dtypes)."""
    return transformer.init_params(cfg, torch.Generator(), "meta")


def abstract_cache(cfg, batch: int, length: int):
    """`cfg`'s decode cache for `batch` rows of `length` tokens on the
    meta device."""
    return transformer.init_cache(cfg, batch, length, "meta")


def _loads(aux) -> list:
    return [a["expert_load"] for seg in aux for a in seg
            if isinstance(a, dict) and "expert_load" in a]


def make_prefill(cfg, plan: ShardingPlan, use_kernel=None):
    """`prefill_step(params, batch) -> (logits, cache, expert loads)` on
    this rank's blocks (see the module's docstring)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache, aux = transformer.prefill(cfg, params, batch,
                                                 shd=plan,
                                                 use_kernel=use_kernel)
        return logits, cache, _loads(aux)
    return prefill_step


def make_decode(cfg, plan: ShardingPlan, use_kernel=None):
    """`decode(params, cache, batch) -> (logits, cache, expert loads)` on
    this rank's blocks, writing `cache` in place."""
    @torch.no_grad()
    def decode(params, cache, batch):
        logits, cache, aux = transformer.decode_step(
            cfg, params, batch, cache, shd=plan, use_kernel=use_kernel)
        return logits, cache, _loads(aux)
    return decode


def _checked(fn, batch_specs: dict, at: int):
    """`fn` refusing a batch (its argument `at`) whose inputs' shapes
    differ from `batch_specs` (`(shape, dtype)` pairs or anything with
    `.shape`)."""
    want = {k: tuple(v.shape if hasattr(v, "shape") else v[0])
            for k, v in batch_specs.items()}

    def step(*args):
        got = {k: tuple(v.shape) for k, v in args[at].items()
               if k in want}
        if got != want:
            raise ValueError(f"a batch of {got}: this step takes {want}")
        return fn(*args)
    return step


def jit_decode_step(cfg, plan: ShardingPlan, batch_specs: dict,
                    batch: int, length: int, use_kernel=None):
    """(the per-rank decode step for batches of `batch_specs`, the
    abstract params, the abstract cache of `batch` x `length`)."""
    step = _checked(make_decode(cfg, plan, use_kernel), batch_specs, 2)
    return step, abstract_params(cfg), abstract_cache(cfg, batch, length)


def jit_prefill_step(cfg, plan: ShardingPlan, batch_specs: dict,
                     use_kernel=None):
    """(the per-rank prefill step for batches of `batch_specs`, the
    abstract params)."""
    step = _checked(make_prefill(cfg, plan, use_kernel), batch_specs, 1)
    return step, abstract_params(cfg)
