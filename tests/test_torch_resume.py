"""The port's `simulate_many` against the JAX package's on the CPU, at
small sizes: one-shot on every path, split runs resumed from one shared
`FleetState` (seeded into both packages through `fleet_state_from_numpy`),
stale resident tags, masked slots and the state round trip.  Results and
canonical final states are compared exactly (tolerance 0: int32)."""
import jax
import numpy as np
import pytest

from repro.core import isa as jisa
from repro.core import simulator as jsim
from repro_torch.core import isa as tisa
from repro_torch.core import simulator as tsim
from torch_asserts import (DEV, assert_equal, assert_state_equal,
                           synthetic_fleet)


def _many(mod, isa_mod, traces, steps, **kw):
    cfg = mod.ReconfigConfig(num_slots=kw.pop("num_slots", 3),
                             miss_latency=45,
                             bs_cache_entries=kw.pop("bs", 64))
    sched = mod.SchedulerConfig(quantum_cycles=kw.pop("quantum", 700),
                                priorities=kw.pop("priorities", None))
    if mod is tsim:
        kw["device"] = DEV
    return mod.simulate_many(traces, cfg, isa_mod.SCENARIO_2, sched,
                             total_steps=steps, **kw)


@pytest.mark.parametrize("path", ("auto", "scan", "interleaved"))
def test_simulate_many_one_shot_matches(path):
    tr = synthetic_fleet(b=1, p=3, n=400, seed=23)[0]
    assert_equal(_many(tsim, tisa, tr, 1_400, path=path),
                 _many(jsim, jisa, tr, 1_400, path=path))
    got, t_state = _many(tsim, tisa, tr, 1_400, path=path,
                         return_state=True, priorities=(1, 2, 1))
    want, j_state = _many(jsim, jisa, tr, 1_400, path=path,
                          return_state=True, priorities=(1, 2, 1))
    assert_equal(got, want)
    assert_state_equal(t_state, j_state)


@pytest.mark.parametrize("split", (1, 333, 900))
def test_split_resume_from_one_shared_state(split):
    """Seed both packages from one JAX state through
    `fleet_state_from_numpy`; every resumed segment's result and canonical
    final state equal JAX's and the port's own one-shot run."""
    tr = synthetic_fleet(b=1, p=2, n=350, seed=split)[0]
    _, j_seed = _many(jsim, jisa, tr, split, return_state=True, path="scan")
    t_seed = tsim.fleet_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_seed), device=DEV)
    assert_state_equal(t_seed, j_seed)
    rest = 1_200 - split
    got, t_end = _many(tsim, tisa, tr, rest, state=t_seed, return_state=True)
    want, j_end = _many(jsim, jisa, tr, rest, state=j_seed,
                        return_state=True)
    assert_equal(got, want)
    assert_state_equal(t_end, j_end)
    one, t_one = _many(tsim, tisa, tr, 1_200, return_state=True)
    assert_equal(got, one)
    assert_state_equal(t_one, j_end)
    scan, t_scan = _many(tsim, tisa, tr, rest, state=t_seed,
                         return_state=True, path="scan")
    assert_equal(scan, got)
    assert_state_equal(t_scan, j_end)


def test_resume_with_stale_tags_and_masked_slots_match():
    """A state holding a tag the next fleet's table lacks widens the
    engine's tag space (`_engine_num_tags`); a masked disambiguator rides
    the scan.  Both equal JAX's."""
    tr1 = synthetic_fleet(b=1, p=2, n=300, seed=41)[0]
    _, j_mid = _many(jsim, jisa, tr1, 500, return_state=True, num_slots=4)
    t_mid = tsim.fleet_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, j_mid), device=DEV)
    cfg_t = tsim.ReconfigConfig(num_slots=4, miss_latency=45)
    cfg_j = jsim.ReconfigConfig(num_slots=4, miss_latency=45)
    # scenario 3 has two tags: the state's residents beyond them are stale
    sched_t = tsim.SchedulerConfig(quantum_cycles=600)
    sched_j = jsim.SchedulerConfig(quantum_cycles=600)
    got = tsim.simulate_many(tr1, cfg_t, tisa.SCENARIO_3, sched_t,
                             total_steps=700, state=t_mid, return_state=True,
                             device=DEV)
    want = jsim.simulate_many(tr1, cfg_j, jisa.SCENARIO_3, sched_j,
                              total_steps=700, state=j_mid,
                              return_state=True)
    assert_equal(got[0], want[0])
    assert_state_equal(got[1], want[1])
    assert tsim._engine_num_tags(
        tsim.fleet_tag_table(tisa.SCENARIO_3, 2), t_mid) > 2
    got = _many(tsim, tisa, tr1, 600, num_slots=4, num_active=2,
                return_state=True)
    want = _many(jsim, jisa, tr1, 600, num_slots=4, num_active=2,
                 return_state=True)
    assert_equal(got[0], want[0])
    assert_state_equal(got[1], want[1])


def test_init_state_and_numpy_round_trip():
    st = tsim.init_fleet_state(3, 4, 16, device=DEV)
    assert_state_equal(st, jsim.init_fleet_state(3, 4, 16))
    back = tsim.fleet_state_from_numpy(tsim.fleet_state_to_numpy(st),
                                       device=DEV)
    assert_state_equal(back, jsim.init_fleet_state(3, 4, 16))
    assert st.num_programs == 3
    assert_equal(st.result(), jsim.init_fleet_state(3, 4, 16).result())
