"""The port's LRU disambiguator (`repro_torch.core.slots`) against the JAX
package's `repro.core.slots` on seeded random tag streams: every lookup's
state, hit, slot and evicted tag equal (tolerance 0: all int32), with and
without `num_active` masking, plus the fused, batched and surgery forms.
The port's batch dimension is held against JAX's `vmap` of the same
function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import slots as js
from repro_torch.core import slots as ts
import torch_asserts  # noqa: F401  (one torch thread under xdist)


def _eq_state(t_state, j_state, msg=""):
    for name, a, b in zip(ts.SlotState._fields, t_state, j_state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{msg} {name}")


def _stream(seed, n=200, num_tags=9):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, num_tags, n).astype(np.int32)


_jlookup = jax.jit(js.lookup)
_jfused = jax.jit(js.lookup_fused)


@pytest.mark.parametrize("num_slots,num_active", [(4, None), (6, None),
                                                  (6, 3), (5, 1), (8, 8)])
def test_lookup_stream_matches(num_slots, num_active):
    tags = _stream(num_slots * 7 + (num_active or 0))
    t_st, j_st = ts.init(num_slots, "cpu"), js.init(num_slots)
    na = None if num_active is None else jnp.int32(num_active)
    for i, tag in enumerate(tags):
        t = ts.lookup(t_st, int(tag), num_active)
        j = _jlookup(j_st, jnp.int32(tag), na)
        assert bool(t.hit) == bool(j.hit), i
        assert int(t.slot) == int(j.slot), i
        assert int(t.evicted_tag) == int(j.evicted_tag), i
        t_st, j_st = t.state, j.state
        _eq_state(t_st, j_st, f"step {i}")
    assert int(ts.occupancy(t_st)) == int(js.occupancy(j_st))


@pytest.mark.parametrize("num_active", (None, 2))
def test_fused_lookup_matches(num_active):
    tags = _stream(5, n=150)
    t_sl, t_bs = ts.init(4, "cpu"), ts.init(3, "cpu")
    j_sl, j_bs = js.init(4), js.init(3)
    na = None if num_active is None else jnp.int32(num_active)
    for i, tag in enumerate(tags):
        t_sl, t_bs, t_hit, t_bhit = ts.lookup_fused(t_sl, t_bs, int(tag),
                                                    num_active)
        j_sl, j_bs, j_hit, j_bhit = _jfused(j_sl, j_bs, jnp.int32(tag), na)
        assert (bool(t_hit), bool(t_bhit)) == (bool(j_hit), bool(j_bhit)), i
        _eq_state(t_sl, j_sl, f"slots step {i}")
        _eq_state(t_bs, j_bs, f"bitstream step {i}")


def test_batched_lanes_match_vmap():
    """The reference machine's lanes: one batched call == JAX's vmap."""
    rng = np.random.default_rng(9)
    lanes, num_slots = 6, 5
    active = rng.integers(1, num_slots + 1, lanes).astype(np.int32)
    t_st = ts.init(num_slots, "cpu", (lanes,))
    j_st = jax.vmap(lambda _: js.init(num_slots))(jnp.arange(lanes))
    step = jax.jit(jax.vmap(js.lookup))
    for i in range(120):
        tag = rng.integers(-1, 8, lanes).astype(np.int32)
        t = ts.lookup(t_st, torch.as_tensor(tag), torch.as_tensor(active))
        j = step(j_st, jnp.asarray(tag), jnp.asarray(active))
        for a, b in zip(t[1:], j[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        t_st, j_st = t.state, j.state
        _eq_state(t_st, j_st, f"step {i}")


def test_lookup_batch_matches():
    tags = _stream(21, n=60)
    t_st, t_hits = ts.lookup_batch(ts.init(4, "cpu"), torch.as_tensor(tags),
                                   3)
    j_st, j_hits = js.lookup_batch(js.init(4), jnp.asarray(tags),
                                   jnp.int32(3))
    np.testing.assert_array_equal(t_hits.numpy(), np.asarray(j_hits))
    _eq_state(t_st, j_st)


def test_invalidate_and_residency_probes_match():
    tags = _stream(33, n=40)
    t_st, _ = ts.lookup_batch(ts.init(6, "cpu"), torch.as_tensor(tags))
    j_st, _ = js.lookup_batch(js.init(6), jnp.asarray(tags))
    probe = np.arange(-1, 10, dtype=np.int32)
    np.testing.assert_array_equal(
        ts.resident_many(t_st, torch.as_tensor(probe)).numpy(),
        np.asarray(js.resident_many(j_st, jnp.asarray(probe))))
    for tag in probe:
        assert bool(ts.resident(t_st, int(tag))) == bool(
            js.resident(j_st, jnp.int32(tag)))
    t_inv = ts.invalidate(t_st, [1, 4])
    j_inv = js.invalidate(j_st, jnp.asarray([1, 4]))
    _eq_state(t_inv, j_inv)
    assert int(ts.occupancy(t_inv)) == int(js.occupancy(j_inv))
