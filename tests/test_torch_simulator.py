"""The port's simulator (`repro_torch.core.simulator`) against the JAX
package's on the CPU, at small sizes: every sweep engine, the dispatcher's
engine choice, the single-program, bitstream and pair entry points, and
the golden integers of tests/test_sched.py (`simulate_many` is in
test_torch_resume.py).  Both packages run int32 simulations, so every
comparison is exact (tolerance 0); CPIs compare as float32 equal."""
import numpy as np
import pytest
import torch

from repro.core import isa as jisa
from repro.core import simulator as jsim
from repro_torch.core import isa as tisa
from repro_torch.core import simulator as tsim
from repro_torch.core import traces as ttr
from torch_asserts import DEV, assert_equal, synthetic_fleet

ENGINES = {"_sweep_fleet": "scan", "_sweep_fleet_stackdist": "stackdist",
           "_sweep_fleet_stackdist_cold": "stackdist_cold",
           "_sweep_fleet_interleaved": "interleaved"}

# golden integers of the original fleet scan (tests/test_sched.py) on
# synthetic_fleet(), quantum 3,000, SCENARIO_2, slots [2, 4], latencies
# [10, 250], 10,000 steps
GOLDEN_CYCLES = [
    [[[41053, 41061, 38814], [605033, 604706, 601422]],
     [[33289, 31568, 31557], [396887, 394361, 393696]]],
    [[[41026, 41037, 40321], [612738, 610764, 611228]],
     [[34085, 31552, 31553], [406319, 402932, 403026]]]]
GOLDEN_SWITCHES = [[[38, 560], [30, 361]], [[38, 567], [30, 369]]]


@pytest.fixture
def engine_spy(monkeypatch):
    """Record which sweep engine each package's dispatcher called."""
    calls = {"port": [], "jax": []}
    for key, mod in (("port", tsim), ("jax", jsim)):
        for fn, engine in ENGINES.items():
            real = getattr(mod, fn)

            def spy(*a, _real=real, _engine=engine, _key=key, **kw):
                calls[_key].append(_engine)
                return _real(*a, **kw)

            monkeypatch.setattr(mod, fn, spy)
    return calls


# --- golden pins -----------------------------------------------------------


@pytest.mark.parametrize("path", ("scan", "interleaved", "auto"))
def test_golden_integers(path, engine_spy):
    res = tsim.sweep_fleet(
        synthetic_fleet(), [10, 250], tisa.SCENARIO_2,
        tsim.SchedulerConfig(quantum_cycles=3_000), slot_counts=[2, 4],
        total_steps=10_000, path=path, device=DEV)
    np.testing.assert_array_equal(res.cycles.numpy(), GOLDEN_CYCLES)
    np.testing.assert_array_equal(res.switches.numpy(), GOLDEN_SWITCHES)
    assert engine_spy["port"] == ["scan" if path == "scan"
                                  else "interleaved"]


# --- sweep_fleet: every engine, and auto's choice --------------------------

# (name, scenario, quantum(s), bs entries, steps, expected auto engine)
GRIDS = {
    "stackdist": ("SCENARIO_2", None, 64, 900, "stackdist"),
    "stackdist_cold": ("SCENARIO_1", None, 6, 900, "stackdist_cold"),
    "interleaved": ("SCENARIO_2", (700, (400, 2_000)), 64, 1_500,
                    "interleaved"),
    "scan_cold_bitstream": ("SCENARIO_2", (700,), 4, 600, "scan"),
    "scan_small_quantum": ("SCENARIO_1", (120,), 64, 600, "scan"),
}


def _grid_call(mod, isa_mod, grid, fleets, path):
    scen, quanta, bs, steps, _ = GRIDS[grid]
    sched = (mod.SchedulerConfig.no_preempt() if quanta is None
             else mod.SchedulerConfig(quantum_cycles=500,
                                      priorities=(2, 1)))
    kw = dict(slot_counts=[1, 3], bs_cache_entries=bs, bs_miss_extra=37,
              total_steps=steps, path=path)
    if quanta is not None:
        kw["quanta"] = list(quanta)
    if mod is tsim:
        kw["device"] = DEV
    return mod.sweep_fleet(fleets, [0, 50], getattr(isa_mod, scen), sched,
                           **kw)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sweep_fleet_auto_matches_jax_engine_and_results(grid, engine_spy):
    fleets = synthetic_fleet(b=3, p=2, n=350, seed=len(grid))
    got = _grid_call(tsim, tisa, grid, fleets, "auto")
    want = _grid_call(jsim, jisa, grid, fleets, "auto")
    assert engine_spy["port"] == engine_spy["jax"] == [GRIDS[grid][-1]]
    assert_equal(got, want)
    np.testing.assert_array_equal(got.cpi.numpy(), np.asarray(want.cpi))
    assert got.cpi.dtype == torch.float32


@pytest.mark.parametrize("grid,path", [
    ("stackdist", "stackdist"), ("stackdist", "scan"),
    ("stackdist_cold", "stackdist_cold"), ("stackdist_cold", "scan"),
    ("interleaved", "interleaved"), ("interleaved", "scan"),
    ("scan_small_quantum", "interleaved")])
def test_sweep_fleet_forced_path_matches_jax(grid, path, engine_spy):
    fleets = synthetic_fleet(b=2, p=2, n=300, seed=7 + len(path))
    got = _grid_call(tsim, tisa, grid, fleets, path)
    want = _grid_call(jsim, jisa, grid, fleets, path)
    assert engine_spy["port"] == engine_spy["jax"] == [path]
    assert_equal(got, want)


def test_forced_ineligible_paths_raise_like_jax():
    fleets = synthetic_fleet(b=1, p=2, n=200)
    for grid, path in (("interleaved", "stackdist"),
                       ("scan_cold_bitstream", "interleaved"),
                       ("interleaved", "stackdist_cold")):
        with pytest.raises(ValueError):
            _grid_call(jsim, jisa, grid, fleets, path)
        with pytest.raises(ValueError):
            _grid_call(tsim, tisa, grid, fleets, path)


def test_interleaved_chunking_and_bucket_padding_match(monkeypatch):
    """A grid whose fleet axis is cut into chunks (the memory bound) and
    whose tail is padded to the chunk shape equals JAX's."""
    fleets = synthetic_fleet(b=5, p=2, n=300, seed=3)
    kw = dict(slot_counts=[2, 4], quanta=[600, 900], total_steps=1_200,
              interleave_window=64, path="interleaved")
    # window 64 x 10 tags x 8 cells per fleet: chunks of two fleets
    for mod in (tsim, jsim):
        monkeypatch.setattr(mod, "_INTERLEAVED_CHUNK_ELEMS", 2 * 64 * 10 * 8)
    got = tsim.sweep_fleet(fleets, [10, 90], tisa.SCENARIO_2,
                           tsim.SchedulerConfig(), device=DEV, **kw)
    want = jsim.sweep_fleet(fleets, [10, 90], jisa.SCENARIO_2,
                            jsim.SchedulerConfig(), **kw)
    assert_equal(got, want)


def test_interleave_window_is_keyed_by_device():
    assert tsim.INTERLEAVE_WINDOW == {"cpu": 256, "cuda": 512}
    q = np.array([[20_000, 20_000]])
    assert tsim._interleaved_window(q, 10**6, None, "cpu") == 256
    assert tsim._interleaved_window(q, 10**6, None, "cuda") == 512
    assert tsim._interleaved_window(np.array([[100, 90]]), 10**6, None,
                                    "cuda") == 128
    assert tsim._interleaved_window(q, 300, None, "cuda") == 300
    assert tsim.fleet_mesh_size() == 1


# --- single-program, bitstream and pair entry points -----------------------


@pytest.mark.parametrize("bs_entries,path", [(64, "auto"), (64, "scan"),
                                             (3, "auto"), (3, "scan")])
def test_simulate_single_and_batch_match(bs_entries, path):
    tr = synthetic_fleet(b=1, p=3, n=500, seed=bs_entries)[0]
    cfg_kw = dict(num_slots=3, miss_latency=40, bs_cache_entries=bs_entries)
    got = tsim.simulate_single(tr[0], tsim.ReconfigConfig(**cfg_kw),
                               tisa.SCENARIO_1, path=path, device=DEV)
    want = jsim.simulate_single(tr[0], jsim.ReconfigConfig(**cfg_kw),
                                jisa.SCENARIO_1, path=path)
    assert_equal(got, want)
    lats = np.array([10, 50, 250], np.int32)
    got = tsim.simulate_single_batch(tr, lats, tsim.ReconfigConfig(**cfg_kw),
                                     tisa.SCENARIO_2, path=path, device=DEV)
    want = jsim.simulate_single_batch(tr, lats, jsim.ReconfigConfig(**cfg_kw),
                                      jisa.SCENARIO_2, path=path)
    assert_equal(got, want)


@pytest.mark.parametrize("path", ("auto", "scan"))
def test_sweep_bitstream_matches(path):
    tr = synthetic_fleet(b=1, p=2, n=300, seed=17)[0]
    kw = dict(slot_counts=[4], miss_latencies=[50, 10],
              bs_entries=[2, 16], bs_miss_extras=[50, 250],
              total_steps=400, path=path)
    got = tsim.sweep_bitstream(tr, tisa.SCENARIO_2, device=DEV, **kw)
    want = jsim.sweep_bitstream(tr, jisa.SCENARIO_2, **kw)
    assert_equal(got, want)


def test_pair_entry_points_and_fixed_cpi_match():
    fl = synthetic_fleet(b=2, p=2, n=400, seed=5)
    kw = dict(total_steps=1_500)
    t_sched = tsim.SchedulerConfig(quantum_cycles=800)
    j_sched = jsim.SchedulerConfig(quantum_cycles=800)
    t_cfg = tsim.ReconfigConfig(num_slots=4, miss_latency=50)
    j_cfg = jsim.ReconfigConfig(num_slots=4, miss_latency=50)
    assert_equal(tsim.simulate_pair(fl[0], t_cfg, tisa.SCENARIO_2, t_sched,
                                    device=DEV, **kw),
                 jsim.simulate_pair(fl[0], j_cfg, jisa.SCENARIO_2, j_sched,
                                    **kw))
    assert_equal(tsim.simulate_pair_batch(fl, t_cfg, tisa.SCENARIO_2,
                                          t_sched, device=DEV, **kw),
                 jsim.simulate_pair_batch(fl, j_cfg, jisa.SCENARIO_2,
                                          j_sched, **kw))
    for name in ("minver", "st", "crc32"):
        for spec in ("RV32I", "RV32IMF"):
            sched_v = dict(quantum_cycles=(1_000, 20_000))
            assert (tsim.fixed_fleet_cpi(ttr.mix_of(name), tisa.SPECS[spec],
                                         tsim.SchedulerConfig(**sched_v), 1)
                    == jsim.fixed_fleet_cpi(ttr.mix_of(name),
                                            jisa.SPECS[spec],
                                            jsim.SchedulerConfig(**sched_v),
                                            1))
    assert tsim.fixed_pair_cpi is tsim.fixed_fleet_cpi
