"""The one traffic generator repeats exactly from a seed, and every seed
sends the same sequence of sizes with its own token ids."""
import itertools

import numpy as np
import pytest
import torch

from cardbench import generate, spec

BIG = 2 ** 31 + 12_345


def _mix(name):
    return spec.cell(name)


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_train_batches_repeat_and_differ_by_step(seed):
    c = _mix("granite-3-2b.train-4x1024")
    a = generate.train_batch(c.traffic, c.model, seed, 1, "cpu")
    b = generate.train_batch(c.traffic, c.model, seed, 1, "cpu")
    d = generate.train_batch(c.traffic, c.model, seed, 2, "cpu")
    assert a.shape == (c.traffic["batch"], c.traffic["seq"])
    assert torch.equal(a, b) and not torch.equal(a, d)
    assert int(a.min()) >= 0 and int(a.max()) < c.model["vocab"]


@pytest.mark.parametrize("cell", ["arctic-480b-2l.prefill-long",
                                  "arctic-480b-2l.decode-chat"])
def test_requests_repeat_and_keep_the_sizes(cell):
    c = _mix(cell)
    take = c.traffic["prompt_len"]["pool"]

    def first(seed):
        return list(itertools.islice(generate.requests(c.traffic, c.model,
                                                       seed), take))

    a, b, other = first(BIG), first(BIG), first(BIG + 1)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(a, b))
    sizes = [(len(p), n) for p, n in a]
    assert sizes == [(len(p), n) for p, n in other]
    assert sorted(t for t, _ in sizes) == generate.pool(
        c.traffic["prompt_len"]).tolist()
    assert sorted(n for _, n in sizes) == generate.pool(
        c.traffic["new_tokens"]).tolist()
    assert not np.array_equal(a[0][0][:8], other[0][0][:8])
    lo, hi = c.traffic["prompt_len"]["lo"], c.traffic["prompt_len"]["hi"]
    for p, n in a:
        assert lo <= len(p) <= hi and p.dtype == np.int32
        assert len(p) + n <= c.traffic["max_len"]


@pytest.mark.parametrize("cell", ["arctic-480b-2l.prefill-long",
                                  "arctic-480b-2l.decode-chat"])
@pytest.mark.parametrize("size", ["prompt_len", "new_tokens"])
def test_lognormal_pools_keep_the_published_median(cell, size):
    spec_ = _mix(cell).traffic[size]
    sizes = generate.pool(spec_)
    assert len(sizes) == spec_["pool"]
    assert np.all(np.diff(sizes) >= 0)
    assert sizes[0] >= spec_["lo"] and sizes[-1] <= spec_["hi"]
    assert abs(np.median(sizes) - spec_["median"]) <= 1


def test_lognormal_pool_is_the_quantiles():
    sizes = generate.pool({"median": 100, "sigma": 1.0, "lo": 1,
                           "hi": 10 ** 6, "pool": 4})
    # quantiles 1/8, 3/8, 5/8, 7/8: z = -1.1503, -0.3186, 0.3186, 1.1503
    assert sizes.tolist() == [32, 73, 138, 316]
