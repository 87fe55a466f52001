"""The rest of a run (the look for a card skipped) with the timed path
broken underneath: each fault that a cell can have turns `correct` false
under the cell's own limits.  A sound run at the same size is correct."""
import time

import numpy as np
import pytest
import torch

from cardbench import run
from cardbench.tests import tiny

SEED = 2 ** 36 + 77


def _measure(name, hooks=None, dtype="float32"):
    cell = tiny.cell(name, dtype)
    return run.measure(cell, SEED, 3.0, 0, "cpu", time.perf_counter(),
                       hooks)


def _unchanged(step):
    def broken(state, batch):
        _, metrics = step(_copy(state), batch)
        return state, metrics
    return broken


def _copy(state):
    from repro_torch.tree_util import tree_map
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)


def _half_batch(step):
    def broken(state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})
    return broken


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch],
                         ids=["sound", "state_unchanged", "half_batch"])
def test_training_faults(fault):
    out = _measure(tiny.TRAIN, None if fault is None else {"step": fault})
    assert out["correct"] is (fault is None), out["check"]


def _token_altered(batcher):
    inner = batcher._decode

    def decode(tokens, positions):
        return (np.array(inner(tokens, positions)) + 1) % 256
    batcher._decode = decode


def _cache_unchanged(batcher):
    from repro_torch.models import transformer
    inner = batcher._decode
    real = transformer.decode_step

    def decode(tokens, positions):
        def step(cfg, params, batch, cache, *a, **k):
            from repro_torch.tree_util import tree_map
            return real(cfg, params, batch,
                        tree_map(lambda t: t.clone(), cache), *a, **k)
        transformer.decode_step = step
        try:
            return inner(tokens, positions)
        finally:
            transformer.decode_step = real
    batcher._decode = decode


def _experts_altered(batcher):
    """A decode step's router takes its k-th choice from the far end."""
    from repro_torch.models import moe
    inner = batcher._decode
    real = moe.topk_stable

    def topk(x, k):
        values, ids = real(x, k)
        ids = ids.clone()
        ids[..., -1] = torch.argmin(x, dim=-1)
        return values, ids

    def decode(tokens, positions):
        moe.topk_stable = topk
        try:
            return inner(tokens, positions)
        finally:
            moe.topk_stable = real
    batcher._decode = decode


@pytest.mark.parametrize("fault", [None, _token_altered, _cache_unchanged,
                                   _experts_altered],
                         ids=["sound", "token_altered", "state_unchanged",
                              "experts_altered"])
def test_serving_faults(fault):
    out = _measure(tiny.SERVE,
                   None if fault is None else {"batcher": fault})
    assert out["correct"] is (fault is None), out["check"]
