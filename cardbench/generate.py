"""The one traffic generator: every mix under `cardbench/traffic/` is a
file of parameters that this module reads.

- `"kind": "train"`: batches of `batch` x `seq` token ids, uniform over the
  vocabulary, drawn anew for each step on the device from (seed, step).
- `"kind": "serve"`: a stream of requests (prompt ids, new tokens).  The
  prompt lengths and new-token counts are each a pool of `pool` sizes,
  paired and ordered once for the mix; the stream cycles through those
  pairs from the first, and the seed draws the token ids.  The batcher's
  schedule follows the sizes alone, so every seed gives it the same work;
  a seed that reordered them would move the tail of the first token's
  wait from seed to seed by more than from run to run.  A size spec with
  `median` and `sigma` is a lognormal fitted to a published trace, its
  pool the quantiles (i + 0.5) / pool, clipped to [`lo`, `hi`] (the
  clipped share sits at the bound); one with `lo` and `hi` alone is
  evenly spaced.
"""
from __future__ import annotations

import itertools
from statistics import NormalDist

import numpy as np
import torch

_GOLD = 0x9E3779B97F4A7C15


def seed64(seed: int, salt: int) -> int:
    """A 63-bit seed from the run's seed (any whole number) and a salt."""
    return (int(seed) * _GOLD + salt * 0xBF58476D1CE4E5B9) % (1 << 63)


def train_batch(mix: dict, model: dict, seed: int, step: int,
                device) -> torch.Tensor:
    """Step `step`'s token ids (batch, seq), int32, on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed, 1 + step))
    return torch.randint(0, model["vocab"], (mix["batch"], mix["seq"]),
                         generator=g, dtype=torch.int32, device=device)


def pool(spec: dict) -> np.ndarray:
    """The `pool` sizes of a size spec, in ascending order."""
    n = spec["pool"]
    if "median" in spec:
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        sizes = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        sizes = np.linspace(spec["lo"], spec["hi"], n)
    return np.clip(sizes.round(), spec["lo"], spec["hi"]).astype(np.int64)


def requests(mix: dict, model: dict, seed: int):
    """Endless (prompt int32 array, new tokens) pairs of the mix."""
    lens, news = pool(mix["prompt_len"]), pool(mix["new_tokens"])
    if len(lens) != len(news):
        raise ValueError("prompt_len and new_tokens need pools of one size")
    order = np.random.default_rng(seed64(0, 3))      # the mix's, not the seed's
    lens, news = lens[order.permutation(len(lens))], news[order.permutation(
        len(news))]
    rng = np.random.default_rng(seed64(seed, 0))
    for i in itertools.count():
        t, n = lens[i % len(lens)], news[i % len(lens)]
        prompt = rng.integers(0, model["vocab"], size=int(t),
                              dtype=np.int64).astype(np.int32)
        yield prompt, int(n)
