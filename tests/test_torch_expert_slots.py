"""The port's slot-resident expert tracker (`repro_torch.core.expert_slots`)
against the JAX package's (`repro.core.expert_slots`): the cases of
test_expert_slots.py run through both, state and stats equal, and
`fill_seconds` bit for bit; seeded random block streams held equal block
by block; ties ranked as `jax.lax.top_k` ranks them; and the one place
the port departs from the frozen reference: the reference's int32
`misses * expert_bytes` wraps at arctic-480b's expert size, the port's
does not."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.core import expert_slots as jes
from repro_torch.core import expert_slots as tes

# arctic-480b's expert: 3 matrices of 7168 x 4864 in bf16
ARCTIC_EXPERT_BYTES = 3 * 7168 * 4864 * 2


def _cfgs(**kw):
    base = dict(num_experts=8, slots_per_device=3, expert_bytes=1 << 20,
                fill_bandwidth=1e9)
    base.update(kw)
    return jes.ExpertSlotConfig(**base), tes.ExpertSlotConfig(**base)


def _init(jc, tc):
    return jes.init_state(jc), tes.init_state(tc, "cpu")


def _assert_same(tstate, tstats, jstate, jstats):
    for name, a, b in zip(tstate._fields, tstate, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"state.{name}")
        assert a.dtype == {"last_use": torch.int32, "resident": torch.bool,
                           "clock": torch.int32}[name]
    for name, a, b in zip(tstats._fields, tstats, jstats):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        assert a.numpy().tobytes() == np.asarray(b).tobytes(), \
            f"stats.{name}: {a} != {b}"


def _both(blocks, **kw):
    """Run the same blocks through both packages, checking each step."""
    jc, tc = _cfgs(**kw)
    js, ts = _init(jc, tc)
    for blk in blocks:
        ids = np.asarray(blk, np.int32)
        js, jstats = jes.access_block(js, jnp.asarray(ids), jc)
        ts, tstats = tes.access_block(ts, torch.from_numpy(ids), tc)
        _assert_same(ts, tstats, js, jstats)
    return ts, tstats


def test_cold_block_all_miss():
    _, stats = _both([[0, 1, 1, 2]])
    assert int(stats.accessed) == 3 and int(stats.misses) == 3
    assert float(stats.fill_seconds) == pytest.approx(3 * (1 << 20) / 1e9)


def test_warm_block_hits():
    _, stats = _both([[0, 1, 2], [0, 2]])
    assert int(stats.misses) == 0 and float(stats.hit_rate) == 1.0


def test_lru_eviction_block_granular():
    state, stats = _both([[0], [1], [2], [0]], slots_per_device=2)
    assert int(stats.misses) == 1
    assert state.resident.tolist() == [True, False, True] + [False] * 5


def test_residency_capped_at_slot_count():
    state, _ = _both([list(range(8))])
    assert int(state.resident.sum()) == 3
    assert state.resident.tolist()[:3] == [True] * 3   # lower ids win ties


@pytest.mark.parametrize("seed", range(6))
def test_random_block_streams_match_jax(seed):
    """Seeded streams of blocks (repeats, overlaps, 1..5 slots): every
    block's state and stats equal the JAX package's."""
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 8, rng.integers(1, 7)).tolist()
              for _ in range(12)]
    state, _ = _both(blocks, slots_per_device=int(rng.integers(1, 6)))
    assert int(state.resident.sum()) <= 5


def test_valid_mask_and_negative_ids_as_jax():
    """Padding with valid=False is ignored; a negative id counts from the
    end, as JAX's scatter indexes it."""
    jc, tc = _cfgs()
    js, ts = _init(jc, tc)
    ids = np.array([2, 5, -1, 7], np.int32)
    valid = np.array([True, False, True, True])
    js, jstats = jes.access_block(js, jnp.asarray(ids), jc,
                                  jnp.asarray(valid))
    ts, tstats = tes.access_block(ts, torch.from_numpy(ids), tc,
                                  torch.from_numpy(valid))
    _assert_same(ts, tstats, js, jstats)
    assert int(tstats.accessed) == 2


def test_fill_seconds_past_int32_is_the_true_value():
    """16 fresh arctic-480b experts in one block at 50 GB/s: the JAX
    package's int32 product 16 x 209,190,912 wraps and its fill_seconds
    is negative; the port's is 16 x 209,190,912 / 50e9."""
    jc, tc = _cfgs(num_experts=128, slots_per_device=4,
                   expert_bytes=ARCTIC_EXPERT_BYTES, fill_bandwidth=50e9)
    js, ts = _init(jc, tc)
    ids = np.arange(16, dtype=np.int32)
    _, jstats = jes.access_block(js, jnp.asarray(ids), jc)
    _, tstats = tes.access_block(ts, torch.from_numpy(ids), tc)
    assert float(jstats.fill_seconds) == pytest.approx(-0.01896, abs=1e-5)
    assert float(tstats.fill_seconds) == pytest.approx(0.06694, abs=1e-5)
    assert float(tstats.fill_seconds) == float(
        np.float32(16 * ARCTIC_EXPERT_BYTES) / np.float32(50e9))
    # ten fills still fit int32: there the two agree bit for bit
    _both([list(range(10))], num_experts=128, slots_per_device=4,
          expert_bytes=ARCTIC_EXPERT_BYTES, fill_bandwidth=50e9)


def test_resident_ids_rank_ties_as_jax():
    """Experts of one block share their last_use: the ranking of
    `resident_expert_ids` breaks those ties to the lower id, as
    `jax.lax.top_k` does."""
    jc, tc = _cfgs(num_experts=8, slots_per_device=5)
    js, ts = _init(jc, tc)
    for blk in ([6, 1, 3], [7, 2], [4]):
        js, _ = jes.access_block(js, jnp.asarray(blk, jnp.int32), jc)
        ts, _ = tes.access_block(ts, torch.tensor(blk, dtype=torch.int32),
                                 tc)
    for slots in (3, 5, 8):
        want = np.asarray(jes.resident_expert_ids(js, slots))
        got = tes.resident_expert_ids(ts, slots)
        np.testing.assert_array_equal(got.numpy(), want)
    assert tes.resident_expert_ids(ts, 8).tolist() == \
        [4, 2, 7, 1, 3, -1, -1, -1]


@pytest.mark.parametrize("k", [1, 2])
def test_slot_hit_routing_matches_jax(k):
    jc, tc = _cfgs(num_experts=4, slots_per_device=2, hit_bias=10.0,
                   hit_margin=1.0)
    js, ts = _init(jc, tc)
    js, _ = jes.access_block(js, jnp.asarray([2], jnp.int32), jc)
    ts, _ = tes.access_block(ts, torch.tensor([2], dtype=torch.int32), tc)
    logits = np.array([[1.0, 0.0, 0.5, -1.0], [0.0, 5.0, 0.0, -1.0],
                       [0.0, 0.0, 0.0, 0.0]], np.float32)
    jids, jg = jes.slot_hit_routing(jnp.asarray(logits), js, jc, k=k)
    tids, tg = tes.slot_hit_routing(torch.from_numpy(logits), ts, tc, k=k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    assert tids[0, 0] == 2 and tids[1, 0] == 1
    # zero bias and no margin: a plain top-k with JAX's tie order
    jc, tc = _cfgs(hit_bias=0.0)
    js, ts = _init(jc, tc)
    logits = np.array([[0.1, 3.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
                      np.float32)
    jids, _ = jes.slot_hit_routing(jnp.asarray(logits), js, jc, k=3)
    tids, _ = tes.slot_hit_routing(torch.from_numpy(logits), ts, tc, k=3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
