"""The port's window pass (`repro_torch.kernels.window_distance`, plain
version) against the JAX package's interleaved engine: `_simulate_cell`
(the jnp body) and the Pallas kernel in interpret mode.  Same numpy inputs
through both packages; every field equal bit for bit (tolerance 0: all
int32)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stackdist_interleaved as jsdi
from repro.kernels import window_distance as jwd
from repro_torch.core import stackdist_interleaved as tsdi
from repro_torch.kernels import window_distance as twd
import torch_asserts  # noqa: F401  (one torch thread under xdist)

TRACE_LEN = 48
NUM_TAGS = 7
TOTAL_STEPS = 130
QUANTUM_MENU = (6, 37, 120, 1 << 30)
WINDOWS = (1, 13, 64, 200)


@functools.partial(jax.jit, static_argnames=("num_tags", "total_steps",
                                             "window", "materialise"))
def _jax_cell(pt, pc, s, lat, qv, sched, handler, bs, seed=None, *,
              num_tags, total_steps, window, materialise=False):
    return jsdi._simulate_cell(pt, pc, s, lat, qv, sched, handler, bs,
                               num_tags, total_steps, window, seed=seed,
                               materialise=materialise)


def _case(rng, p):
    tags = rng.integers(-1, NUM_TAGS, (p, TRACE_LEN)).astype(np.int32)
    costs = rng.integers(0, 9, (p, TRACE_LEN)).astype(np.int32)
    quanta = np.array([QUANTUM_MENU[i] for i in rng.integers(0, 4, p)],
                      np.int32)
    sched = np.array(list(range(p)) + [0], np.int32)
    return tags, costs, quanta, sched


def _seed(rng, p):
    """Engine-coordinate seed (numpy): virtual last_pos in [-1, num_tags),
    counters mid-flight."""
    return (rng.permutation(NUM_TAGS).astype(np.int32) - 1,
            rng.integers(0, 3 * TRACE_LEN, p).astype(np.int32),
            np.int32(rng.integers(0, p + 1)), np.int32(rng.integers(0, 6)),
            rng.integers(0, 9_000, p).astype(np.int32),
            rng.integers(0, 900, p).astype(np.int32),
            rng.integers(0, 900, p).astype(np.int32),
            rng.integers(0, 90, p).astype(np.int32),
            np.int32(rng.integers(0, 40)))


def _jax_seed(seed):
    (last, cursors, sched_idx, qc, cycles, instrs, misses, bsm,
     switches) = (jnp.asarray(x) for x in seed)
    return jsdi.CellCarry(
        last_pos=last, last_miss_pos=jnp.full((NUM_TAGS,), -1, jnp.int32),
        cursors=cursors, sched_idx=sched_idx, steps_done=jnp.int32(0),
        q_cycles=qc, cycles=cycles, instrs=instrs, misses=misses,
        bs_misses=bsm, switches=switches)


ARGS = dict(s=3, lat=41, handler=9, bs=17)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("mode", ("unseeded", "seeded", "materialise"))
def test_plain_cell_matches_jax_body_and_pallas_interpret(window, mode):
    rng = np.random.default_rng(1_000 * len(mode) + window)
    p = 3
    tags, costs, quanta, sched = _case(rng, p)
    seed = _seed(rng, p) if mode == "seeded" else None
    materialise = mode != "unseeded"
    kw = dict(num_tags=NUM_TAGS, total_steps=TOTAL_STEPS, window=window)
    got = twd.window_cell(
        torch.as_tensor(tags), torch.as_tensor(costs), ARGS["s"],
        ARGS["lat"], torch.as_tensor(quanta), torch.as_tensor(sched),
        ARGS["handler"], ARGS["bs"],
        None if seed is None else tuple(torch.as_tensor(x) for x in seed),
        materialise=materialise, **kw)
    jargs = (jnp.asarray(tags), jnp.asarray(costs), jnp.int32(ARGS["s"]),
             jnp.int32(ARGS["lat"]), jnp.asarray(quanta),
             jnp.asarray(sched), jnp.int32(ARGS["handler"]),
             jnp.int32(ARGS["bs"]))
    pallas = jwd.window_cell(
        *jargs, seed=None if seed is None else tuple(
            jnp.asarray(x) for x in seed),
        materialise=materialise, interpret=True, **kw)
    body = _jax_cell(*jargs, seed=None if seed is None else _jax_seed(seed),
                     materialise=materialise, **kw)
    fields = jsdi.CellCarry._fields
    for name, g, w in zip(fields, got, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{name} vs Pallas")
    if materialise:
        for name, g, w in zip(fields, got, body):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} vs body")
    else:
        counters = (got[6], got[7], got[8], got[9], got[10])
        for g, w in zip(counters, body):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", WINDOWS)
def test_plain_grid_matches_pallas_interpret(window):
    """`window_grid` over a (Q, B, K, L) = (2, 2, 2, 2) grid."""
    rng = np.random.default_rng(4_242 + window)
    p = 3
    ptags = np.stack([_case(rng, p)[0] for _ in range(2)])
    pcosts = np.stack([_case(rng, p)[1] for _ in range(2)])
    counts = np.array([1, 4], np.int32)
    lats = np.array([0, 73], np.int32)
    quanta = np.array([[6, 37, 120], [1 << 30] * 3], np.int32)
    sched = np.array([0, 1, 2, 0], np.int32)
    kw = dict(num_tags=NUM_TAGS, total_steps=TOTAL_STEPS, window=window)
    got = twd.window_grid(torch.as_tensor(ptags), torch.as_tensor(pcosts),
                          counts, lats, quanta, sched, 11, 23, **kw)
    want = jwd.window_grid(jnp.asarray(ptags), jnp.asarray(pcosts),
                           jnp.asarray(counts), jnp.asarray(lats),
                           jnp.asarray(quanta), jnp.asarray(sched),
                           jnp.int32(11), jnp.int32(23), interpret=True,
                           **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"grid field {i}")


def test_simulate_cell_is_the_plain_window_pass():
    """`stackdist_interleaved._simulate_cell` (the port's plain body for one
    cell) equals the JAX body on a cell with every cursor wrapping."""
    rng = np.random.default_rng(77)
    tags, costs, quanta, sched = _case(rng, 2)
    kw = dict(num_tags=NUM_TAGS, total_steps=TOTAL_STEPS, window=13)
    got = tsdi._simulate_cell(torch.as_tensor(tags), torch.as_tensor(costs),
                              2, 5, torch.as_tensor(quanta),
                              torch.as_tensor(sched), 3, 7, **kw)
    want = _jax_cell(jnp.asarray(tags), jnp.asarray(costs), jnp.int32(2),
                     jnp.int32(5), jnp.asarray(quanta), jnp.asarray(sched),
                     jnp.int32(3), jnp.int32(7), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_use_kernel_knob():
    cpu = torch.device("cpu")
    # None/'auto' go through the wrapper, which runs the plain body on CPU
    # tensors (test below)
    assert twd.resolve(None, cpu) is True
    assert twd.resolve("auto", cpu) is True
    assert twd.resolve("plain", cpu) is False
    assert twd.resolve(False, cpu) is False
    for forced in ("kernel", True):
        with pytest.raises(ValueError, match="CUDA"):
            twd.resolve(forced, cpu)
    with pytest.raises(ValueError, match="use_kernel"):
        twd.resolve("interpret", cpu)
    cuda = torch.device("cuda")
    assert twd.resolve(None, cuda) is True
    assert twd.resolve("kernel", cuda) is True
    assert twd.resolve("plain", cuda) is False


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(3)
    tags, costs, quanta, sched = _case(rng, 2)
    before = (twd.window_grid.launches, twd.window_cell.launches)
    kw = dict(num_tags=NUM_TAGS, total_steps=40, window=8)
    a = twd.window_cell(torch.as_tensor(tags), torch.as_tensor(costs), 2, 5,
                        quanta, sched, 3, 7, **kw)
    b = twd.window_cell_plain(torch.as_tensor(tags), torch.as_tensor(costs),
                              2, 5, quanta, sched, 3, 7, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (twd.window_grid.launches, twd.window_cell.launches) == before
