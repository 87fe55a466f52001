"""The port's unpreempted Mattson engines (`repro_torch.core.stackdist`,
`repro_torch.core.stackdist_cold`) against the JAX package's on seeded
random traces and tag streams: every profile, grid and lane equal
(tolerance 0: all int32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as jisa
from repro.core import stackdist as jsd
from repro.core import stackdist_cold as jsc
from repro_torch.core import isa as tisa
from repro_torch.core import stackdist as tsd
from repro_torch.core import stackdist_cold as tsc
import torch_asserts  # noqa: F401  (one torch thread under xdist)


def _eq(t_tuple, j_tuple):
    for name, a, b in zip(t_tuple._fields, t_tuple, j_tuple):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def _traces(seed, b=3, n=700):
    rng = np.random.default_rng(seed)
    return rng.integers(0, tisa.NUM_INSTRUCTIONS, (b, n)).astype(np.int32)


@pytest.mark.parametrize("num_tags", (3, 10))
def test_distance_profile_and_grid_match(num_tags):
    rng = np.random.default_rng(num_tags)
    tags = rng.integers(-1, num_tags, 500).astype(np.int32)
    costs = rng.integers(0, 40, 500).astype(np.int32)
    tp = tsd.distance_profile(tags, costs, num_tags, device="cpu")
    jp = jsd.distance_profile(jnp.asarray(tags), jnp.asarray(costs),
                              num_tags)
    _eq(tp, jp)
    counts = np.array([0, 1, 2, 5, num_tags, num_tags + 4], np.int32)
    np.testing.assert_array_equal(
        tsd.misses_for_counts(tp, counts).numpy(),
        np.asarray(jsd.misses_for_counts(jp, jnp.asarray(counts))))
    _eq(tsd.cycles_grid(tp, counts, [0, 10, 250], 100),
        jsd.cycles_grid(jp, jnp.asarray(counts), jnp.asarray([0, 10, 250]),
                        100))


@pytest.mark.parametrize("scenario", ("SCENARIO_1", "SCENARIO_2",
                                      "SCENARIO_3"))
def test_sweep_and_lanes_unpreempted_match(scenario):
    ts, js = getattr(tisa, scenario), getattr(jisa, scenario)
    tr = _traces(len(scenario) + ts.num_tags)
    kw = dict(num_tags=ts.num_tags, total_steps=1_100)   # cursor wraps
    counts, lats = [1, 2, 4, 8], [10, 50, 250]
    got = tsd.sweep_unpreempted(torch.as_tensor(tr), ts.instr_tag,
                                tisa.INSTR_HW_CYCLES, counts, lats, 100, **kw)
    want = jsd.sweep_unpreempted(jnp.asarray(tr), js.instr_tag,
                                 jisa.INSTR_HW_CYCLES, jnp.asarray(counts),
                                 jnp.asarray(lats), 100, **kw)
    _eq(got, want)
    lane_lats = np.array([10, 50, 250], np.int32)
    got = tsd.lanes_unpreempted(torch.as_tensor(tr), ts.instr_tag,
                                tisa.INSTR_HW_CYCLES, 4, lane_lats, 100, **kw)
    want = jsd.lanes_unpreempted(jnp.asarray(tr), js.instr_tag,
                                 jisa.INSTR_HW_CYCLES, jnp.int32(4),
                                 jnp.asarray(lane_lats), 100, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scenario", ("SCENARIO_1", "SCENARIO_2"))
def test_sweep_and_lanes_cold_match(scenario):
    ts, js = getattr(tisa, scenario), getattr(jisa, scenario)
    tr = _traces(40 + ts.num_tags, n=600)
    kw = dict(num_tags=ts.num_tags, total_steps=900)
    counts, lats, caps, extras = [1, 2, 4], [10, 250], [1, 2, 4, 64], [0, 90]
    got = tsc.sweep_cold(torch.as_tensor(tr), ts.instr_tag,
                         tisa.INSTR_HW_CYCLES, counts, lats, caps, extras,
                         **kw)
    want = jsc.sweep_cold(jnp.asarray(tr), js.instr_tag,
                          jisa.INSTR_HW_CYCLES, jnp.asarray(counts),
                          jnp.asarray(lats), jnp.asarray(caps),
                          jnp.asarray(extras), **kw)
    _eq(got, want)
    lane_lats = np.array([10, 50, 250], np.int32)
    got = tsc.lanes_cold(torch.as_tensor(tr), ts.instr_tag,
                         tisa.INSTR_HW_CYCLES, 4, lane_lats, 3, 77, **kw)
    want = jsc.lanes_cold(jnp.asarray(tr), js.instr_tag,
                          jisa.INSTR_HW_CYCLES, jnp.int32(4),
                          jnp.asarray(lane_lats), jnp.int32(3),
                          jnp.int32(77), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cold_one_matches():
    rng = np.random.default_rng(2)
    tags = rng.integers(-1, 6, 400).astype(np.int32)
    costs = rng.integers(0, 30, 400).astype(np.int32)
    args = ([1, 3, 6], [5, 50], [1, 2, 6], [0, 100])
    got = tsc._cold_one(torch.as_tensor(tags), torch.as_tensor(costs),
                        *args, num_tags=6)
    want = jsc._cold_one(jnp.asarray(tags), jnp.asarray(costs),
                         *(jnp.asarray(a) for a in args), num_tags=6)
    _eq(got, want)
