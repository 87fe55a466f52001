"""Card-only checks of the port's CUDA window kernel against its plain
PyTorch version (bit-for-bit), plus the sweep and resume paths that launch
it.  Marked `cuda`; every test skips without a CUDA device.  On a machine
with a card: `PYTHONPATH=src python -m pytest -q -m cuda tests/`.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import isa, simulator
from repro_torch.kernels import window_distance as wd

pytestmark = pytest.mark.cuda

QUANTUM_MENU = (6, 37, 120, 1 << 30)
WINDOWS = (1, 13, 64, 200, 512, 2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, p, num_tags, trace_len, dev):
    tags = rng.integers(-1, num_tags, (p, trace_len)).astype(np.int32)
    costs = rng.integers(0, 9, (p, trace_len)).astype(np.int32)
    quanta = np.array([QUANTUM_MENU[i] for i in rng.integers(0, 4, p)],
                      np.int32)
    sched = np.array(list(range(p)) + [0], np.int32)
    t = lambda x: torch.as_tensor(x, device=dev)
    return t(tags), t(costs), t(quanta), t(sched)


def _seed(rng, p, num_tags, trace_len, dev):
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return (t(rng.permutation(num_tags) - 1),
            t(rng.integers(0, 3 * trace_len, p)), t(rng.integers(0, p + 1)),
            t(rng.integers(0, 6)), t(rng.integers(0, 9_000, p)),
            t(rng.integers(0, 900, p)), t(rng.integers(0, 900, p)),
            t(rng.integers(0, 90, p)), t(rng.integers(0, 40)))


@pytest.mark.parametrize("num_tags", (7, 29))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("mode", ("unseeded", "seeded", "materialise"))
def test_window_cell_kernel_matches_plain(dev, num_tags, window, mode):
    rng = np.random.default_rng(window * 31 + num_tags)
    p = 3
    tags, costs, quanta, sched = _case(rng, p, num_tags, 300, dev)
    seed = (_seed(rng, p, num_tags, 300, dev) if mode == "seeded"
            else None)
    kw = dict(num_tags=num_tags, total_steps=2_500, window=window,
              materialise=mode != "unseeded")
    args = (tags, costs, 3, 41, quanta, sched, 9, 17, seed)
    before = wd.window_cell.launches
    got = wd.window_cell(*args, **kw)
    assert wd.window_cell.launches == before + 1
    want = wd.window_cell_plain(*args, **kw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), f"field {i}"


@pytest.mark.parametrize("window", WINDOWS)
def test_window_grid_kernel_matches_plain(dev, window):
    rng = np.random.default_rng(4_242 + window)
    p, num_tags = 3, 29
    tags = torch.stack([_case(rng, p, num_tags, 300, dev)[0]
                        for _ in range(3)])
    costs = torch.stack([_case(rng, p, num_tags, 300, dev)[1]
                         for _ in range(3)])
    counts = torch.tensor([1, 4, 8], dtype=torch.int32, device=dev)
    lats = torch.tensor([0, 73], dtype=torch.int32, device=dev)
    quanta = torch.tensor([[6, 37, 120], [1 << 30] * 3, [500, 900, 700]],
                          dtype=torch.int32, device=dev)
    sched = torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=dev)
    kw = dict(num_tags=num_tags, total_steps=3_000, window=window)
    args = (tags, costs, counts, lats, quanta, sched, 11, 23)
    got = wd.window_grid(*args, **kw)
    want = wd.window_grid_plain(*args, **kw)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), f"field {i}"


def test_sweep_and_resume_on_card_match_scan(dev):
    rng = np.random.default_rng(5)
    fl = rng.integers(0, isa.NUM_INSTRUCTIONS, (3, 2, 400)).astype(np.int32)
    sched = simulator.SchedulerConfig(quantum_cycles=500)
    kw = dict(slot_counts=[2, 4], total_steps=900, device=dev)
    scan = simulator.sweep_fleet(fl, [10, 50], isa.SCENARIO_2, sched,
                                 path="scan", **kw)
    before = wd.window_grid.launches
    fast = simulator.sweep_fleet(fl, [10, 50], isa.SCENARIO_2, sched,
                                 path="interleaved", interleave_window=64,
                                 **kw)
    assert wd.window_grid.launches > before
    for a, b in zip(scan, fast):
        assert torch.equal(a.cpu(), b.cpu())
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    _, st = simulator.simulate_many(fl[0], cfg, isa.SCENARIO_2, sched,
                                    total_steps=700, return_state=True,
                                    path="scan", device=dev)
    outs = [simulator.simulate_many(fl[0], cfg, isa.SCENARIO_2, sched,
                                    total_steps=600, state=st,
                                    return_state=True, path=path,
                                    device=dev)
            for path in ("scan", "interleaved")]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a.cpu(), b.cpu())
    na, nb = (simulator.fleet_state_to_numpy(o[1]) for o in outs)
    for a, b in zip(na[2:] + tuple(na.slot_st) + tuple(na.bs_st),
                    nb[2:] + tuple(nb.slot_st) + tuple(nb.bs_st)):
        np.testing.assert_array_equal(a, b)


def test_kernel_refuses_what_shared_memory_cannot_hold(dev):
    tags = torch.zeros((1, 1, 8), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        wd.window_grid(tags, tags, one, one, one.reshape(1, 1), one - 1, 0,
                       0, num_tags=10_000, total_steps=4, window=4)
