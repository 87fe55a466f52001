"""The port's online layer (`repro_torch.sched.online.OnlineReplacer`), the
serve engine's sched half (`estimate_fleet_contention`,
`SlotServeEngine.fleet_contention` / `plan_coresidency` /
`apply_admission` / `serve_online`) and the online benchmarks against the
JAX package's on the CPU, exactly: every policy under both re-solve
modes (reports, snapshots and re-solve logs without their seconds), the
migration pricing on a tiered topology, the engine's results, and the
rows of `online_churn` and `chaos_serve` at reduced sizes."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import chaos_serve as jchaos
from benchmarks import online_churn as jchurn
from repro import sched as J
from repro.configs import base as jcb
from repro.core import isa as jisa
from repro.models import transformer as jt
from repro.serve import engine as je
from repro.workloads import opcounts as jopc
from repro_torch import sched as T
from repro_torch import workloads as tworkloads
from repro_torch.bench import chaos_serve as tchaos
from repro_torch.bench import online_churn as tchurn
from repro_torch.configs import base as tcb
from repro_torch.core import isa as tisa
from repro_torch.models import convert
from repro_torch.serve import engine as te
from repro_torch.workloads import opcounts as topc
from torch_asserts import DEV, assert_tree_equal, without_seconds

PC = dict(num_slots=4, miss_latency=50, quantum_cycles=2_000,
          trace_len=2_000, steps_per_program=2_000)
EVENTS = [(0, "arrive", "fgA", "minver"), (0, "arrive", "fgB", "cubic"),
          (0, "arrive", "m1", "qrduino"), (1, "arrive", "m2", "edn"),
          (1, "arrive", "m3", "crc32"), (2, "arrive", "m4", "tarfind"),
          (4, "depart", "m3", None), (4, "arrive", "m5", "tarfind")]
NUM_EPOCHS = 7


@pytest.fixture(scope="module")
def models():
    return (T.ContentionModel(T.PlacementConfig(**PC), device=DEV),
            J.ContentionModel(J.PlacementConfig(**PC)))


def _pair(models, topo=None, **kw):
    """The same replacer in both packages: 3 flat cores, or `topo`
    (hosts, sockets/host, cores/socket)."""
    tm, jm = models
    oc = dict(epoch_steps=2_000, probe_steps=800)
    tcfg = T.OnlineConfig(placement=T.PlacementConfig(**PC),
                          **(dict(topology=T.Topology(*topo)) if topo
                             else dict(num_cores=3)), **oc)
    jcfg = J.OnlineConfig(placement=J.PlacementConfig(**PC),
                          **(dict(topology=J.Topology(*topo)) if topo
                             else dict(num_cores=3)), **oc)
    return (T.OnlineReplacer(tcfg, model=tm, device=DEV, **kw),
            J.OnlineReplacer(jcfg, model=jm, **kw))


def _events(mod):
    return [mod.TenantEvent(*e) for e in EVENTS]


@pytest.mark.parametrize("mode", ["incremental", "full"])
@pytest.mark.parametrize("policy", ["never", "always", "warm"])
def test_policies_and_resolve_modes_match_reference(models, policy, mode):
    t, j = _pair(models, policy=policy, resolve_mode=mode)
    trep = t.run(_events(T), NUM_EPOCHS)
    jrep = j.run(_events(J), NUM_EPOCHS)
    assert_tree_equal(trep, jrep)
    assert_tree_equal(t.snapshot(), j.snapshot())
    assert_tree_equal(without_seconds(t.resolve_log),
                      without_seconds(j.resolve_log))
    assert T.OnlineReplacer.__init__.__kwdefaults__["device"] == "cuda"


def test_tiered_migration_pricing_matches_reference(models):
    """Two hosts of two sockets of one core: after a warm serve every
    tenant's probe, reload surcharge and warm fraction toward every core
    equal the reference's (intra-core, cross-socket and cross-host
    tiers)."""
    t, j = _pair(models, topo=(2, 2, 1), policy="warm")
    assert_tree_equal(t.run(_events(T), 5), j.run(_events(J), 5))
    for name in sorted(t.tenants):
        assert t.warm_fraction(name) == j.warm_fraction(name)
        for dst in [None, *range(4)]:
            assert t.migration_penalty(name, dst) == \
                j.migration_penalty(name, dst)
            if dst is not None:
                assert t.reload_cycles(name, dst) == \
                    j.reload_cycles(name, dst)
    assert t._exchange_units({"fgA": 1, "m1": 0}) == \
        j._exchange_units({"fgA": 1, "m1": 0})


def test_replacer_validation(models):
    tm, _ = models
    cfg = T.OnlineConfig(num_cores=2, placement=T.PlacementConfig(**PC))
    for kw, match in ((dict(policy="sometimes"), "policy"),
                      (dict(resolve_mode="lazy"), "resolve_mode"),
                      (dict(recovery="pray"), "recovery"),
                      (dict(backoff_cap=0), "backoff_cap")):
        with pytest.raises(ValueError, match=match):
            T.OnlineReplacer(cfg, model=tm, device=DEV, **kw)
    with pytest.raises(ValueError, match="slots"):
        T.OnlineReplacer(T.OnlineConfig(
            num_cores=2, placement=T.PlacementConfig(num_slots=2)),
            model=tm, device=DEV)
    with pytest.raises(ValueError, match="sweeps on"):
        T.OnlineReplacer(cfg, model=tm, device="meta")
    rep = T.OnlineReplacer(cfg, model=tm, device=DEV)
    with pytest.raises(ValueError, match="twice"):
        rep.run([T.TenantEvent(0, "arrive", "a", "minver"),
                 T.TenantEvent(0, "arrive", "a", "crc32")], 2)
    with pytest.raises(ValueError, match="unknown tenant name"):
        rep.run([T.TenantEvent(0, "arrive", "b", "llama:decode")], 2)
    snap = rep.snapshot()
    with pytest.raises(ValueError, match="snapshot version"):
        rep.restore({**snap, "version": 9})
    with pytest.raises(ValueError, match="topology"):
        rep.restore({**snap, "topology": (2, 1, 1)})


# ---------------------------------------------------------------------------
# the serve engine's sched half
# ---------------------------------------------------------------------------

BENCHES = {"fg": "minver", "t1": "nbody", "t2": "crc32", "t3": "tarfind"}


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's over arctic's smoke config with the
    JAX package's weights carried across; four single-row tenants."""
    jcb.load_all()
    tcb.load_all()
    jcfg = jcb.get_config("arctic-480b").smoke()
    tcfg = tcb.get_config("arctic-480b").smoke()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   DEV)
    tokens = np.zeros((1, 4), np.int32)

    def make():
        return (te.SlotServeEngine(tcfg, tp, te.EngineConfig(),
                                   [te.Tenant(n, tokens) for n in BENCHES],
                                   max_len=8, device=DEV),
                je.SlotServeEngine(jcfg, jp, je.EngineConfig(),
                                   [je.Tenant(n, tokens) for n in BENCHES],
                                   max_len=8))
    return make


@pytest.mark.parametrize("scenarios", ["shared", "per_tenant"])
def test_estimate_fleet_contention_matches_reference(engines, scenarios,
                                                      monkeypatch):
    kw = dict(num_slots=2, quantum_cycles=1_000, trace_len=3_000,
              total_steps=8_000)
    tscen = jscen = None
    if scenarios == "per_tenant":
        tscen = [tisa.SCENARIO_2, tisa.SCENARIO_3, tisa.SCENARIO_2,
                 tisa.SCENARIO_2]
        jscen = [jisa.SCENARIO_2, jisa.SCENARIO_3, jisa.SCENARIO_2,
                 jisa.SCENARIO_2]
    tm, jm = engines()
    assert_tree_equal(tm.fleet_contention(BENCHES, scenarios=tscen, **kw),
                      jm.fleet_contention(BENCHES, scenarios=jscen, **kw))
    assert_tree_equal(
        te.estimate_fleet_contention(["cubic", "edn"], device=DEV,
                                     priorities=(2, 1), **kw),
        je.estimate_fleet_contention(["cubic", "edn"], priorities=(2, 1),
                                     **kw))
    # a model-zoo name prices as the reference's, given the same OpCount
    zoo = "granite-3-2b:decode"
    oc = jopc.model_opcount(*zoo.split(":")).to_dict()
    monkeypatch.setattr(topc, "_CACHE", {tuple(zoo.split(":")):
                                         topc.OpCount.from_dict(oc)})
    monkeypatch.setattr(tworkloads, "_SPECS", {})
    assert_tree_equal(
        te.estimate_fleet_contention([zoo, "edn"], device=DEV, **kw),
        je.estimate_fleet_contention([zoo, "edn"], **kw))


@pytest.mark.parametrize("slo,weights,core", [(9.0, None, 1),
                                              (1.08, {"fg": 4.0}, 0),
                                              (1.0, None, 0)])
def test_plan_coresidency_and_apply_admission_match_reference(
        engines, models, slo, weights, core):
    tm, jm = engines()
    kw = dict(slo=slo, num_cores=2, slo_weights=weights)
    tdec = tm.plan_coresidency(BENCHES, model=models[0], **kw)
    jdec = jm.plan_coresidency(BENCHES, model=models[1], **kw)
    assert_tree_equal(tdec, jdec)
    if tdec.placement is None:
        assert tm.apply_admission(tdec, core) == []
        jm.apply_admission(jdec, core)
    else:
        assert [t.name for t in tm.apply_admission(tdec, core)] == \
            [t.name for t in jm.apply_admission(jdec, core)]
    assert [t.name for t in tm.tenants] == [t.name for t in jm.tenants]
    assert [t.name for t in tm.deferred] == [t.name for t in jm.deferred]
    if not tm.tenants:
        with pytest.raises(ValueError, match="no resident tenants"):
            tm.run(1)


def test_serve_online_with_a_storm_matches_reference(engines, models):
    tm, jm = engines()
    storm = dict(seed=5, num_epochs=6, num_cores=3, p_core_loss=0.15,
                 p_seu=0.2, p_flush=0.15, p_stall=0.15)
    oc = dict(num_cores=3, epoch_steps=2_000, probe_steps=800)
    trep = tm.serve_online(
        _events(T), model=models[0], num_epochs=6, apply_core=1,
        online_cfg=T.OnlineConfig(placement=T.PlacementConfig(**PC), **oc),
        faults=T.FaultPlan.storm(**storm))
    jrep = jm.serve_online(
        _events(J), model=models[1], num_epochs=6, apply_core=1,
        online_cfg=J.OnlineConfig(placement=J.PlacementConfig(**PC), **oc),
        faults=J.FaultPlan.storm(**storm))
    assert_tree_equal(trep, jrep)
    assert trep.fault_log
    assert [t.name for t in tm.deferred] == [t.name for t in jm.deferred]
    with pytest.raises(ValueError, match="out of range"):
        tm.serve_online(_events(T)[:3], model=models[0], num_epochs=1,
                        online_cfg=T.OnlineConfig(
                            placement=T.PlacementConfig(**PC), **oc),
                        apply_core=7)


# ---------------------------------------------------------------------------
# the online benchmarks, at reduced sizes
# ---------------------------------------------------------------------------

def _shrink(monkeypatch, jmod, tmod, epochs, **oc):
    small = dict(num_slots=4, miss_latency=50, quantum_cycles=2_000,
                 trace_len=2_000, steps_per_program=2_000)
    for mod, pkg in ((jmod, J), (tmod, T)):
        pcfg = pkg.PlacementConfig(**small)
        monkeypatch.setattr(mod, "PCFG", pcfg)
        monkeypatch.setattr(mod, "CFG", dataclasses.replace(
            mod.CFG, placement=pcfg, **oc))
        monkeypatch.setattr(mod, "NUM_EPOCHS", epochs)


def test_online_churn_rows_match_reference(monkeypatch):
    _shrink(monkeypatch, jchurn, tchurn, 8, epoch_steps=3_000,
            probe_steps=1_000)
    got, tout = tchurn.run(DEV)
    want, jout = jchurn.run()
    assert got == want
    assert_tree_equal(tout, jout)


def test_chaos_serve_rows_match_reference(monkeypatch):
    """chaos_serve's storm with 2,000-step epochs: its asserts (warm
    recovery no worse than cold_restart or none, an evacuation, the
    crash-restart parity) hold in both packages, and the rows agree."""
    _shrink(monkeypatch, jchaos, tchaos, 8, epoch_steps=2_000,
            probe_steps=500)
    got, tout = tchaos.run(DEV)
    want, jout = jchaos.run()
    assert got == want
    assert_tree_equal(tout, jout)
