"""The port's fault layer (`repro_torch.sched.faults`, the simulator's
fault surgery and the `OnlineReplacer`'s recovery) against the JAX
package's on the CPU, exactly: the surgery on the same states, the masked
(degraded) simulation against a physical k-slot cache, the storms and
their counter-based draws, every recovery policy's report under one
storm, and checkpoints of either package restored into the other and
finished equal to the uninterrupted serve."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro import sched as J
from repro.core import isa as jisa
from repro.core import simulator as jsim
from repro.core import traces as jtraces
from repro_torch import sched as T
from repro_torch.core import isa as tisa
from repro_torch.core import simulator as tsim
from repro_torch.core import slots as tslots
from torch_asserts import (DEV, assert_equal, assert_state_equal,
                           assert_tree_equal)

BENCHES = ["minver", "nbody", "crc32", "cubic"]


def _fleet(p=2, n=3_000):
    return np.stack([jtraces.build_trace(b, n) for b in BENCHES[:p]])


def _pair(p=2, total=6_000, num_slots=4):
    """The same warm state in both packages: (traces, sched pair,
    config pair, (port state, JAX state))."""
    tr = _fleet(p)
    js = jsim.SchedulerConfig(quantum_cycles=1_500)
    ts = tsim.SchedulerConfig(quantum_cycles=1_500)
    jc = jsim.ReconfigConfig(num_slots=num_slots, miss_latency=50)
    tc = tsim.ReconfigConfig(num_slots=num_slots, miss_latency=50)
    _, jst = jsim.simulate_many(tr, jc, jisa.SCENARIO_2, js, total,
                                return_state=True)
    _, tst = tsim.simulate_many(tr, tc, tisa.SCENARIO_2, ts, total,
                                return_state=True, device=DEV)
    assert_state_equal(tst, jst)
    return tr, (ts, js), (tc, jc), (tst, jst)


# ---------------------------------------------------------------------------
# fault surgery
# ---------------------------------------------------------------------------

SURGERY = ["seu_two", "seu_none", "flush", "degrade_1", "degrade_2",
           "degrade_4"]


def _surgery(name, sim, st, occupied):
    if name == "seu_two":
        return sim.seu_fleet_state(st, occupied[:2])
    if name == "seu_none":
        return sim.seu_fleet_state(st, [])
    if name == "flush":
        return sim.flush_bitstream(st)
    return sim.degrade_fleet_state(st, int(name.split("_")[1]))


@pytest.mark.parametrize("name", SURGERY)
def test_fault_surgery_matches_reference(name):
    """Each surgery on the same warm state gives the reference's state,
    and the next resumed segment (the reference machine on a mutated
    cache, masked on a degraded one) the reference's counters and
    state."""
    tr, (ts, js), (tc, jc), (tst, jst) = _pair()
    occupied = np.nonzero(np.asarray(jst.slot_st.tags) >= 0)[0]
    assert occupied.size >= 3
    tmut = _surgery(name, tsim, tst, occupied)
    jmut = _surgery(name, jsim, jst, occupied)
    assert_state_equal(tmut, jmut)
    na = int(name.split("_")[1]) if name.startswith("degrade") else None
    jres, jnext = jsim.simulate_many(tr, jc, jisa.SCENARIO_2, js, 2_500,
                                     state=jmut, return_state=True,
                                     num_active=na)
    tres, tnext = tsim.simulate_many(tr, tc, tisa.SCENARIO_2, ts, 2_500,
                                     state=tmut, return_state=True,
                                     num_active=na, device=DEV)
    assert_equal(tres, jres)
    assert_state_equal(tnext, jnext)


def test_fault_surgery_validation():
    _, _, _, (tst, _) = _pair()
    with pytest.raises(ValueError, match="out of range"):
        tsim.seu_fleet_state(tst, [99])
    for bad in (0, 5):
        with pytest.raises(ValueError, match="num_active"):
            tsim.degrade_fleet_state(tst, bad)
    assert int(tslots.occupancy(tsim.flush_bitstream(tst).bs_st)) == 0
    tr, (ts, _), (tc, _), _ = _pair()
    with pytest.raises(ValueError, match="degrade_fleet_state"):
        tsim.simulate_many(tr, tc, tisa.SCENARIO_2, ts, 1_000, state=tst,
                           num_active=2, device=DEV)
    for name in ("seu_fleet_state", "flush_bitstream",
                 "degrade_fleet_state"):
        assert name in tsim.__all__


@pytest.mark.parametrize("k", [1, 2, 3])
def test_masked_slots_equal_physical_cache(k):
    """`num_active=k` over a 4-slot disambiguator is bit for bit an LRU
    cache of k slots in the port (counters and live caches), and equals
    the reference's masked run."""
    tr = _fleet(2, 2_000)
    sched = tsim.SchedulerConfig(quantum_cycles=1_500)
    kw = dict(total_steps=4_000, return_state=True, device=DEV)
    res_m, st_m = tsim.simulate_many(
        tr, tsim.ReconfigConfig(num_slots=4, miss_latency=50),
        tisa.SCENARIO_2, sched, num_active=k, **kw)
    res_p, st_p = tsim.simulate_many(
        tr, tsim.ReconfigConfig(num_slots=k, miss_latency=50),
        tisa.SCENARIO_2, sched, **kw)
    for a, b in zip(res_m, res_p):
        assert torch.equal(a, b)
    assert torch.equal(st_m.slot_st.tags[:k], st_p.slot_st.tags)
    assert torch.equal(st_m.slot_st.last_use[:k], st_p.slot_st.last_use)
    assert (st_m.slot_st.tags[k:] == -1).all()
    assert torch.equal(st_m.bs_st.tags, st_p.bs_st.tags)
    jres, jst = jsim.simulate_many(
        tr, jsim.ReconfigConfig(num_slots=4, miss_latency=50),
        jisa.SCENARIO_2, jsim.SchedulerConfig(quantum_cycles=1_500),
        4_000, num_active=k, return_state=True)
    assert_equal(res_m, jres)
    assert_state_equal(st_m, jst)


def test_mutated_states_scan_one_segment_then_reseed(monkeypatch):
    """A mutated state takes the reference machine for one segment; the
    segment re-warms the caches and the next one takes the resumable
    interleaved engine again."""
    calls = {"interleaved": 0, "scan": 0}
    for name, key in (("_resume_fleet_interleaved", "interleaved"),
                      ("_simulate_fleet_impl", "scan")):
        real = getattr(tsim, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tsim, name, spy)
    tr, (ts, _), (tc, _), (tst, _) = _pair()
    occupied = np.nonzero(tst.slot_st.tags.numpy() >= 0)[0][:1]
    for mut in (tsim.seu_fleet_state(tst, occupied),
                tsim.flush_bitstream(tst)):
        before = dict(calls)
        _, st1 = tsim.simulate_many(tr, tc, tisa.SCENARIO_2, ts, 4_000,
                                    state=mut, return_state=True,
                                    device=DEV)
        assert calls == {"interleaved": before["interleaved"],
                         "scan": before["scan"] + 1}
        tsim.simulate_many(tr, tc, tisa.SCENARIO_2, ts, 2_000, state=st1,
                           device=DEV)
        assert calls["interleaved"] == before["interleaved"] + 1


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def _events(plan):
    return [dataclasses.asdict(e) for e in plan.events]


@pytest.mark.parametrize("seed,epochs,cores,kw", [
    (3, 20, 3, {}),
    (1, 30, 2, dict(p_core_loss=0.9, p_permanent=0.5)),
    (7, 12, 5, dict(p_seu=0.5, max_hit=3, p_stall=0.3, start_epoch=2)),
])
def test_storm_matches_reference(seed, epochs, cores, kw):
    tp = T.FaultPlan.storm(seed, epochs, cores, **kw)
    jp = J.FaultPlan.storm(seed, epochs, cores, **kw)
    assert _events(tp) == _events(jp)
    assert (tp.horizon(), tp.max_core()) == (jp.horizon(), jp.max_core())
    for te, je in zip(tp.events, jp.events):
        np.testing.assert_array_equal(tp.rng(te).integers(0, 1_000, 8),
                                      jp.rng(je).integers(0, 1_000, 8))
    assert T.FAULT_KINDS == J.FAULT_KINDS
    assert T.RECOVERY_POLICIES == J.RECOVERY_POLICIES


def test_fault_event_validation_matches_reference():
    bad = [dict(epoch=0, kind="meteor", core=0),
           dict(epoch=-1, kind="core_loss", core=0),
           dict(epoch=0, kind="core_loss", core=0, repair_epochs=0),
           dict(epoch=0, kind="slot_seu", core=0, num_hit=0),
           dict(epoch=0, kind="reconfig_stall", core=0, stall_epochs=0),
           dict(epoch=0, kind="core_loss", core=-1)]
    for kw in bad:
        with pytest.raises(ValueError) as te:
            T.FaultEvent(**kw)
        with pytest.raises(ValueError) as je:
            J.FaultEvent(**kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(TypeError):
        T.FaultPlan(events=("not-an-event",))


# ---------------------------------------------------------------------------
# the replacer's recovery, against the reference
# ---------------------------------------------------------------------------

PC = dict(num_slots=4, miss_latency=50, quantum_cycles=2_000,
          trace_len=2_000, steps_per_program=2_000)
OC = dict(num_cores=3, epoch_steps=3_000, probe_steps=800)
EVENTS = [(0, "arrive", "a", "minver"), (0, "arrive", "b", "cubic"),
          (0, "arrive", "c", "crc32"), (1, "arrive", "d", "tarfind"),
          (3, "depart", "c", None), (3, "arrive", "e", "qrduino"),
          (4, "arrive", "f", "nbody")]
# every fault kind: core 0 (a and b) is lost and repairs degraded, where
# the last arrival lands (a masked core); a double SEU on the evacuees'
# core, a flush, and a port stall on core 2 that steers the evacuation
STORM = [(2, "core_loss", 0, dict(repair_epochs=2, degraded_slots=1)),
         (3, "slot_seu", 1, dict(num_hit=2)),
         (4, "bitstream_flush", 2, {}),
         (2, "reconfig_stall", 2, dict(stall_epochs=2))]
NUM_EPOCHS = 7


def _plan(mod, storm=STORM, seed=7):
    return mod.FaultPlan(events=tuple(mod.FaultEvent(e, k, c, **kw)
                                      for e, k, c, kw in storm), seed=seed)


def _tenant_events(mod):
    return [mod.TenantEvent(*e) for e in EVENTS]


@pytest.fixture(scope="module")
def models():
    return (T.ContentionModel(T.PlacementConfig(**PC), device=DEV),
            J.ContentionModel(J.PlacementConfig(**PC)))


def _replacers(models, **kw):
    tm, jm = models
    t = T.OnlineReplacer(T.OnlineConfig(placement=T.PlacementConfig(**PC),
                                        **OC),
                         model=tm, faults=_plan(T), device=DEV, **kw)
    j = J.OnlineReplacer(J.OnlineConfig(placement=J.PlacementConfig(**PC),
                                        **OC),
                         model=jm, faults=_plan(J), **kw)
    return t, j


@pytest.mark.parametrize("recovery", ["none", "cold_restart", "warm"])
def test_recovery_policies_match_reference(models, recovery):
    t, j = _replacers(models, recovery=recovery)
    trep = t.run(_tenant_events(T), NUM_EPOCHS)
    jrep = j.run(_tenant_events(J), NUM_EPOCHS)
    assert_tree_equal(trep, jrep)
    assert_tree_equal(t.snapshot(), j.snapshot())
    kinds = {f["kind"] for f in trep.fault_log}
    assert {"core_loss", "slot_seu", "bitstream_flush", "reconfig_stall",
            "repair"} <= kinds
    if recovery != "none":
        assert trep.evacuations >= 1


def test_backoff_is_capped_like_the_reference(models):
    t, j = _replacers(models, backoff_cap=2)
    for rep in (t, j):
        rep.cores[1].stall_until = 50
    for epoch in range(12):
        assert t._attempt_move("x", 1, epoch, why="test") == \
            j._attempt_move("x", 1, epoch, why="test")
    assert_tree_equal(t.fault_log, j.fault_log)
    assert_tree_equal(t._retry, j._retry)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_checkpoint_restore(models, direction):
    """A checkpoint saved mid-serve by one package, restored into a fresh
    replacer (fresh contention model) of the other, finishes the serve
    equal to the uninterrupted serve."""
    t, j = _replacers(models, recovery="warm")
    snaps = {}
    src, dst_mod = (j, T) if direction == "jax_to_port" else (t, J)
    full = src.run(_tenant_events(J if src is j else T), NUM_EPOCHS,
                   checkpoint_every=3,
                   save_fn=lambda s, e: snaps.setdefault(e, s))
    epoch, snap = sorted(snaps.items())[0]
    assert epoch == 2
    cfg = dst_mod.OnlineConfig(placement=dst_mod.PlacementConfig(**PC), **OC)
    if dst_mod is T:
        fresh = T.OnlineReplacer(
            cfg, model=T.ContentionModel(T.PlacementConfig(**PC),
                                         device=DEV),
            faults=_plan(T), recovery="warm", device=DEV)
    else:
        fresh = J.OnlineReplacer(
            cfg, model=J.ContentionModel(J.PlacementConfig(**PC)),
            faults=_plan(J), recovery="warm")
    fresh.restore(snap)
    resumed = fresh.run(_tenant_events(dst_mod), NUM_EPOCHS)
    assert_tree_equal(resumed, full)
