"""The bitset route's algebra, on the CPU: `window_loop_bitset_plain`, the
plain PyTorch model of the window kernel's bitset route (passes of 256
rows in warp sub-chunks of 32, tag sets as 32-bit words, popcount stack
distances from the carried newer-than sets, the cut and the commit per
pass), held bit for bit (tolerance 0: all int32) on numpy-seeded inputs
against

* the port's plain window loop (`window_loop_plain`), at 1, 2, 7, 10, 29
  and 32 tags, windows 1, 13, 31, 32, 33, 64, 200, 257 and 512, unseeded,
  seeded and materialising, with quanta of 6 and 37 (an expiry in nearly
  every window) and 1 << 30 (none);
* the JAX package's interleaved engine (`_simulate_cell`, the jnp body)
  and its Pallas kernel in interpret mode, where the size allows;

plus costs of any int32 value (a running sum that wraps and falls), the
pass counts, and the route rule mirrored from the C entry point.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.core import stackdist_interleaved as jsdi
from repro.kernels import window_distance as jwd
from repro_torch.kernels import window_distance as twd

TAGS = (1, 2, 7, 10, 29, 32)
WINDOWS = (1, 13, 31, 32, 33, 64, 200, 257, 512)
MODES = ("unseeded", "seeded", "materialise")
QUANTA = (6, 37, 1 << 30)
P = 3
TRACE_LEN = 64
STEPS = 200
LONG_STEPS = 700        # the no-expiry cells: several passes a trip
HANDLER, BS_EXTRA = 9, 17


def _streams(rng, num_tags, p=P, trace_len=TRACE_LEN, costs=(0, 9)):
    tags = rng.integers(-1, num_tags, (p, trace_len)).astype(np.int32)
    hw = rng.integers(*costs, (p, trace_len), dtype=np.int64).astype(
        np.int32)
    return tags, hw


def _seed(rng, num_tags, p=P, trace_len=TRACE_LEN):
    """Engine-coordinate seed (numpy): virtual last_pos in [-1, num_tags),
    cursors and counters mid-flight."""
    return (rng.permutation(num_tags).astype(np.int32) - 1,
            rng.integers(0, 3 * trace_len, p).astype(np.int32),
            np.int32(rng.integers(0, p + 1)), np.int32(rng.integers(0, 6)),
            rng.integers(0, 9_000, p).astype(np.int32),
            rng.integers(0, 900, p).astype(np.int32),
            rng.integers(0, 900, p).astype(np.int32),
            rng.integers(0, 90, p).astype(np.int32),
            np.int32(rng.integers(0, 40)))


def _cells(tags, hw, quanta, num_tags, seed, cells_k):
    """Loop arguments for one fleet run at each quantum x slot count (the
    seed, if any, repeated in every cell)."""
    nq = len(quanta)
    counts = torch.tensor(cells_k, dtype=torch.int32).repeat(nq)
    q = torch.tensor(quanta, dtype=torch.int32).repeat_interleave(
        len(cells_k))
    c = q.shape[0]
    if seed is None:
        init = twd.cold_carry(c, P, num_tags, "cpu")
    else:
        one = twd._seed_carry(tuple(torch.as_tensor(x) for x in seed), P,
                              num_tags, torch.device("cpu"))
        init = twd.Carry(*(x.expand((c,) + x.shape[1:]).clone()
                           for x in one))
    sched = torch.tensor(list(range(P)) + [0], dtype=torch.int32)
    return (torch.as_tensor(tags)[None], torch.as_tensor(hw)[None],
            torch.zeros(c, dtype=torch.long), counts,
            torch.full((c,), 41, dtype=torch.int32),
            q[:, None].expand(c, P).contiguous(), sched, HANDLER, BS_EXTRA,
            init)


def _assert_carry_equal(got, want, what):
    for name, g, w in zip(twd.Carry._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                      err_msg=f"{what}: {name}")


def _long_steps(window: int) -> int:
    """Steps of a no-expiry run: about three windows (two and a bit at the
    widest), so that a trip spans several passes."""
    return min(LONG_STEPS, max(STEPS, 3 * window))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("num_tags", TAGS)
def test_bitset_model_matches_plain_loop(num_tags, window, mode):
    """Every quantum of QUANTA at slot counts 1 and 4."""
    rng = np.random.default_rng(num_tags * 1_000 + window * 7 + len(mode))
    tags, hw = _streams(rng, num_tags)
    seed = _seed(rng, num_tags) if mode == "seeded" else None
    kw = dict(window=window, pos_base=num_tags if seed is not None else 0,
              materialise=mode != "unseeded")
    for quanta, steps in ((QUANTA[:2], STEPS),
                          (QUANTA[2:], _long_steps(window))):
        args = _cells(tags, hw, quanta, num_tags, seed, (1, 4))
        got = twd.window_loop_bitset_plain(*args, total_steps=steps, **kw)
        want = twd.window_loop_plain(*args, total_steps=steps, **kw)
        _assert_carry_equal(got, want, f"quanta {quanta}")


@functools.partial(jax.jit, static_argnames=("num_tags", "total_steps",
                                             "window", "materialise"))
def _jax_cell(pt, pc, s, lat, qv, sched, handler, bs, seed=None, *,
              num_tags, total_steps, window, materialise=False):
    return jsdi._simulate_cell(pt, pc, s, lat, qv, sched, handler, bs,
                               num_tags, total_steps, window, seed=seed,
                               materialise=materialise)


def _jax_seed(seed, num_tags):
    (last, cursors, sched_idx, qc, cycles, instrs, misses, bsm,
     switches) = (jnp.asarray(x) for x in seed)
    return jsdi.CellCarry(
        last_pos=last, last_miss_pos=jnp.full((num_tags,), -1, jnp.int32),
        cursors=cursors, sched_idx=sched_idx, steps_done=jnp.int32(0),
        q_cycles=qc, cycles=cycles, instrs=instrs, misses=misses,
        bs_misses=bsm, switches=switches)


@pytest.mark.parametrize("mode", ("seeded", "materialise"))
@pytest.mark.parametrize("window", (13, 33, 257))
@pytest.mark.parametrize("num_tags", (2, 32))
def test_bitset_model_matches_jax_body(num_tags, window, mode):
    """One cell with a mixed quantum vector against the JAX package's
    `_simulate_cell`: every `CellCarry` field."""
    rng = np.random.default_rng(77 * num_tags + window)
    tags, hw = _streams(rng, num_tags)
    quanta = np.array([6, 1 << 30, 37], np.int32)
    sched = np.array(list(range(P)) + [0], np.int32)
    seed = _seed(rng, num_tags) if mode == "seeded" else None
    materialise = True
    kw = dict(num_tags=num_tags, total_steps=_long_steps(window),
              window=window)
    init = twd._seed_carry(
        None if seed is None else tuple(torch.as_tensor(x) for x in seed),
        P, num_tags, torch.device("cpu"))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    got = twd.window_loop_bitset_plain(
        torch.as_tensor(tags)[None], torch.as_tensor(hw)[None],
        torch.zeros(1, dtype=torch.long), i32([3]), i32([41]),
        torch.as_tensor(quanta)[None], torch.as_tensor(sched), HANDLER,
        BS_EXTRA, init,
        total_steps=kw["total_steps"], window=window,
        pos_base=num_tags if seed is not None else 0,
        materialise=materialise)
    want = _jax_cell(jnp.asarray(tags), jnp.asarray(hw), jnp.int32(3),
                     jnp.int32(41), jnp.asarray(quanta), jnp.asarray(sched),
                     jnp.int32(HANDLER), jnp.int32(BS_EXTRA),
                     seed=None if seed is None else _jax_seed(seed,
                                                              num_tags),
                     materialise=materialise, **kw)
    for name, g, w in zip(jsdi.CellCarry._fields, got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("window", (13, 33))
@pytest.mark.parametrize("num_tags", (7, 32))
def test_bitset_model_matches_pallas_interpret(num_tags, window):
    """A (Q, B, K, L) = (2, 2, 2, 1) grid against the Pallas kernel in
    interpret mode (test_torch_window.py's size: 48 rows, 130 steps)."""
    rng = np.random.default_rng(4_242 + window + num_tags)
    ptags = np.stack([_streams(rng, num_tags, trace_len=48)[0]
                      for _ in range(2)])
    pcosts = np.stack([_streams(rng, num_tags, trace_len=48)[1]
                       for _ in range(2)])
    counts = np.array([1, 4], np.int32)
    lats = np.array([73], np.int32)
    quanta = np.array([[6, 37, 120], [1 << 30] * 3], np.int32)
    sched = np.array([0, 1, 2, 0], np.int32)
    kw = dict(num_tags=num_tags, total_steps=130, window=window)
    want = jwd.window_grid(jnp.asarray(ptags), jnp.asarray(pcosts),
                           jnp.asarray(counts), jnp.asarray(lats),
                           jnp.asarray(quanta), jnp.asarray(sched),
                           jnp.int32(11), jnp.int32(23), interpret=True,
                           **kw)
    q, b, k, l = twd._grid_cells(2, 2, 2, 1, "cpu")
    final = twd.window_loop_bitset_plain(
        torch.as_tensor(ptags), torch.as_tensor(pcosts), b,
        torch.as_tensor(counts)[k], torch.as_tensor(lats)[l],
        torch.as_tensor(quanta)[q], torch.as_tensor(sched), 11, 23,
        twd.cold_carry(q.shape[0], P, num_tags, "cpu"), total_steps=130,
        window=window, pos_base=0, materialise=False)
    shape = (2, 2, 2, 1)
    got = (final.cycles, final.instrs, final.misses, final.bs_misses,
           final.switches)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            g.reshape(np.asarray(w).shape).numpy(), np.asarray(w),
            err_msg=f"grid field {i}")
    assert np.asarray(want[4]).shape == shape


@pytest.mark.parametrize("num_tags", (10, 32))
def test_bitset_model_takes_any_int32_cost(num_tags):
    """Costs and quanta across the int32 range, latency and bitstream
    extra negative: the running cost wraps and falls, so the first expiry
    can lie anywhere in a pass."""
    rng = np.random.default_rng(9 + num_tags)
    tags, hw = _streams(rng, num_tags, costs=(-(1 << 31), 1 << 31))
    for window in (33, 512):
        args = list(_cells(tags, hw, (0, 1 << 29, -(1 << 30)), num_tags,
                           None, (2, 5)))
        args[4] = torch.tensor([-7, 1 << 30] * 3, dtype=torch.int32)
        args[8] = -(1 << 28)
        kw = dict(total_steps=600, window=window, pos_base=0,
                  materialise=True)
        got = twd.window_loop_bitset_plain(*args, **kw)
        want = twd.window_loop_plain(*args, **kw)
        _assert_carry_equal(got, want, f"window {window}")


@pytest.mark.parametrize("window,steps,trips,passes", [
    (512, 1_024, 2, 4),       # two windows of two passes each
    (257, 514, 2, 4),         # 256 + 1 rows a window
    (256, 512, 2, 2),
    (13, 130, 10, 10),
    (1, 5, 5, 5),
])
def test_bitset_model_counts_trips_and_passes(window, steps, trips, passes):
    """Without an expiry every trip is one window of ceil(W / 256)
    passes (the kernel's `stats` count the same on the card)."""
    rng = np.random.default_rng(window)
    tags, hw = _streams(rng, 10)
    args = _cells(tags, hw, (1 << 30,), 10, None, (4,))
    stats = []
    twd.window_loop_bitset_plain(*args, total_steps=steps, window=window,
                                 pos_base=0, materialise=False, stats=stats)
    assert stats == [(trips, passes)]


def test_route_rule_mirrors_the_c_entry_point():
    """`route` is the C entry point's rule (`bitset_route`): a tag set in
    one 32-bit word and the fleet in one warp's lanes."""
    assert twd.route(32, 4) == "bitset"
    assert twd.route(33, 4) == "generic"
    assert twd.route(1, 1) == "bitset"
    assert twd.route(10, 32) == "bitset"
    assert twd.route(10, 33) == "generic"
    assert twd.ROUTES == ("bitset", "generic")
    assert twd.window_grid.routes.keys() == set(twd.ROUTES)
    assert twd.window_cell.routes.keys() == set(twd.ROUTES)
    with pytest.raises(ValueError, match="bitset route"):
        twd.window_loop_bitset_plain(
            *_cells(*_streams(np.random.default_rng(0), 33), (6,), 33, None,
                    (1,)), total_steps=10, window=4, pos_base=0,
            materialise=False)
