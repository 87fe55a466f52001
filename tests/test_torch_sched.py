"""The port's placement layer (`repro_torch.sched`: topology, policy,
placement, admission) and its placement benchmarks against the JAX
package's on the CPU, exactly: the geometry and reload tiers, the policy
schedules, `ContentionModel.predict` (shared and per-tenant taxonomies, a
degraded width) with its sweep counts, `place_tenants`, `place_fleet`,
the baselines and `score_placement`, `AdmissionController.decide` with
and without SLO weights, the tenant-name rule (Embench and model-zoo
names), and the rows of
`placement_study` and `placement_search` at a reduced size; then
`fleet_scale_study` at a smoke size and `perf_slot_decode` (its slot rows
on the JAX package's weights, carried across, over fewer steps; its
fleet rows as they are)."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import fleet_scale_study as jfleet
from benchmarks import perf_slot_decode as jslot
from benchmarks import placement_search as jsearch
from benchmarks import placement_study as jstudy
from repro import sched as J
from repro.configs import base as jcb
from repro.core import isa as jisa
from repro.models import transformer as jt
from repro.workloads import opcounts as jopc
from repro_torch import sched as T
from repro_torch import workloads as tworkloads
from repro_torch.bench import fleet_scale_study as tfleet
from repro_torch.bench import perf_slot_decode as tslot
from repro_torch.bench import placement_search as tsearch
from repro_torch.bench import placement_study as tstudy
from repro_torch.core import isa as tisa
from repro_torch.models import convert
from repro_torch.workloads import opcounts as topc
from torch_asserts import DEV, assert_tree_equal

PC = dict(num_slots=4, miss_latency=50, quantum_cycles=2_000,
          trace_len=2_000, steps_per_program=2_000)
ROSTER = {"a": "minver", "b": "nbody", "c": "crc32", "d": "tarfind",
          "e": "cubic", "f": "qrduino"}


@pytest.fixture(scope="module")
def models():
    return (T.ContentionModel(T.PlacementConfig(**PC), device=DEV),
            J.ContentionModel(J.PlacementConfig(**PC)))


def test_public_names_match_reference():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert T.DISTANCES == J.DISTANCES
    assert T.RESOLVE_MODES == J.RESOLVE_MODES


# ---------------------------------------------------------------------------
# topology and policy
# ---------------------------------------------------------------------------

GEOMETRIES = [dict(num_hosts=1, sockets_per_host=1, cores_per_socket=3),
              dict(num_hosts=2, sockets_per_host=2, cores_per_socket=2),
              dict(num_hosts=3, sockets_per_host=1, cores_per_socket=2,
                   cross_socket_reload=2.0, cross_host_reload=8.0)]


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "x".join(
    str(g[k]) for k in ("num_hosts", "sockets_per_host",
                        "cores_per_socket")))
def test_topology_matches_reference(geo):
    t, j = T.Topology(**geo), J.Topology(**geo)
    assert (t.num_cores, t.num_sockets, t.cores_per_host, t.geometry()) == \
        (j.num_cores, j.num_sockets, j.cores_per_host, j.geometry())
    cores = range(t.num_cores)
    assert [(t.socket_of(c), t.host_of(c)) for c in cores] == \
        [(j.socket_of(c), j.host_of(c)) for c in cores]
    assert [t.cores_of_host(h) for h in range(t.num_hosts)] == \
        [j.cores_of_host(h) for h in range(j.num_hosts)]
    for a in cores:
        for b in cores:
            d = t.distance(a, b)
            assert d == j.distance(a, b)
            assert t.reload_multiplier(d) == j.reload_multiplier(d)
    assert T.Topology.flat(5) == T.Topology(1, 1, 5)
    assert T.Topology.flat(5).geometry() == J.Topology.flat(5).geometry()


@pytest.mark.parametrize("bad", [
    dict(num_hosts=0), dict(cores_per_socket=0),
    dict(cross_socket_reload=-1.0),
    dict(cross_socket_reload=8.0, cross_host_reload=4.0)])
def test_topology_validation_matches_reference(bad):
    with pytest.raises(ValueError) as te:
        T.Topology(**bad)
    with pytest.raises(ValueError) as je:
        J.Topology(**bad)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="outside"):
        T.Topology.flat(2).socket_of(2)
    with pytest.raises(ValueError, match="unknown distance"):
        T.Topology.flat(2).reload_multiplier("far")


POLICIES = [("uniform", (5_000,), {}),
            ("weighted", ((3, 1, 2),), dict(quantum_cycles=4_000)),
            ("foreground_background", (4,), dict(fg_weight=3))]


@pytest.mark.parametrize("ctor,args,kw", POLICIES,
                         ids=[p[0] for p in POLICIES])
def test_policy_matches_reference(ctor, args, kw):
    t = getattr(T.PriorityPolicy, ctor)(*args, **kw)
    j = getattr(J.PriorityPolicy, ctor)(*args, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    n = 4 if ctor == "foreground_background" else 3
    np.testing.assert_array_equal(t.schedule(n), j.schedule(n))
    np.testing.assert_array_equal(t.cpu_share(n), j.cpu_share(n))
    assert dataclasses.asdict(t.scheduler()) == \
        dataclasses.asdict(j.scheduler())
    cells = [1_000, (500, 700, 900)]
    for got, want in zip(T.quantum_grid(*cells, num_programs=3),
                         J.quantum_grid(*cells, num_programs=3)):
        np.testing.assert_array_equal(got, want)
    assert T.quantum_grid(*cells) == J.quantum_grid(*cells)
    with pytest.raises(ValueError, match="at least one"):
        T.quantum_grid()
    with pytest.raises(ValueError, match=">= 2"):
        T.PriorityPolicy.foreground_background(1)


# ---------------------------------------------------------------------------
# contention model
# ---------------------------------------------------------------------------

GROUPS = [("minver",), ("crc32", "minver"), ("minver", "crc32"),
          ("nbody", "tarfind", "crc32"), ("cubic", "cubic"),
          ("qrduino", "minver", "nbody", "crc32"), ()]


@pytest.mark.parametrize("case", ["shared", "per_tenant", "degraded"])
def test_predict_matches_reference(case):
    mapped = case == "per_tenant"
    t = T.ContentionModel(
        T.PlacementConfig(**PC), device=DEV,
        scenarios={"minver": tisa.SCENARIO_3} if mapped else None)
    j = J.ContentionModel(
        J.PlacementConfig(**PC),
        scenarios={"minver": jisa.SCENARIO_3} if mapped else None)
    ns = 3 if case == "degraded" else None
    for pt, pj in zip(t.predict(GROUPS, num_slots=ns),
                      j.predict(GROUPS, num_slots=ns)):
        assert pt.dtype == pj.dtype
        np.testing.assert_array_equal(pt, pj)
    for b in ("minver", "crc32", "qrduino"):
        assert t.solo_cpi(b) == j.solo_cpi(b)
        assert t.solo_miss_rate(b) == j.solo_miss_rate(b)
    assert (t.sim_calls, t.groups_simulated) == \
        (j.sim_calls, j.groups_simulated)
    # cached: a repeat simulates nothing
    calls = t.sim_calls
    t.predict(GROUPS, num_slots=ns)
    assert t.sim_calls == calls


def test_names_resolve_embench_and_model_zoo(models, monkeypatch):
    tm, jm = models
    with pytest.raises(ValueError, match="unknown tenant name.*nosuch"):
        tm.predict([("nosuch", "minver")])
    # a model-zoo name prices as the reference's, given the same OpCount
    zoo = "granite-3-2b:decode"
    oc = jopc.model_opcount(*zoo.split(":")).to_dict()
    monkeypatch.setattr(topc, "_CACHE", {tuple(zoo.split(":")):
                                         topc.OpCount.from_dict(oc)})
    monkeypatch.setattr(tworkloads, "_SPECS", {})
    assert tm.solo_cpi(zoo) == jm.solo_cpi(zoo)
    np.testing.assert_array_equal(tm.trace(zoo), jm.trace(zoo))
    with pytest.raises(ValueError, match="num_slots"):
        tm.predict([("minver",)], num_slots=5)


# ---------------------------------------------------------------------------
# placement and admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_cores", [1, 2, 3, 4, 8])
def test_place_tenants_matches_reference(models, num_cores):
    tm, jm = models
    assert_tree_equal(T.place_tenants(ROSTER, num_cores, tm, max_rounds=4),
                      J.place_tenants(ROSTER, num_cores, jm, max_rounds=4))


@pytest.mark.parametrize("geo", [(1, 1, 3), (2, 1, 2), (3, 2, 1)])
def test_place_fleet_matches_reference(models, geo):
    tm, jm = models
    assert_tree_equal(T.place_fleet(ROSTER, T.Topology(*geo), tm),
                      J.place_fleet(ROSTER, J.Topology(*geo), jm))


def test_baselines_and_scores_match_reference(models):
    tm, jm = models
    names = sorted(ROSTER)
    assert T.fifo_placement(names, 4) == J.fifo_placement(names, 4)
    for seed in range(3):
        cores = T.random_placement(names, 3, seed=seed)
        assert cores == J.random_placement(names, 3, seed=seed)
        assert_tree_equal(T.score_placement(cores, ROSTER, tm),
                          J.score_placement(cores, ROSTER, jm))


@pytest.mark.parametrize("slo,weights", [
    (9.0, None), (1.0, None), (1.06, None), (1.06, {"a": 4.0}),
    (1.08, {"b": 2.0, "e": 0.5})])
def test_admission_matches_reference(models, slo, weights):
    tm, jm = models
    got = T.AdmissionController(slo=slo, num_cores=3, model=tm,
                                max_rounds=4).decide(ROSTER, weights)
    want = J.AdmissionController(slo=slo, num_cores=3, model=jm,
                                 max_rounds=4).decide(ROSTER, weights)
    assert_tree_equal(got, want)
    for name in ROSTER:
        assert got.core_of(name) == want.core_of(name)
    assert got.admitted_all == want.admitted_all


def test_admission_validation(models):
    tm, _ = models
    with pytest.raises(ValueError, match="slo"):
        T.AdmissionController(slo=0, model=tm)
    with pytest.raises(ValueError, match="num_cores"):
        T.AdmissionController(num_cores=0, model=tm)
    ctrl = T.AdmissionController(model=tm)
    with pytest.raises(ValueError, match="unknown tenant"):
        ctrl.decide(ROSTER, {"zz": 1.0})
    with pytest.raises(ValueError, match="positive"):
        ctrl.decide(ROSTER, {"a": 0.0})


# ---------------------------------------------------------------------------
# the placement benchmarks, at a reduced size
# ---------------------------------------------------------------------------

def test_placement_study_rows_match_reference(monkeypatch):
    small = dict(miss_latency=50, quantum_cycles=2_000, trace_len=2_000,
                 steps_per_program=2_000)
    monkeypatch.setattr(jstudy, "CFG", J.PlacementConfig(**small))
    monkeypatch.setattr(tstudy, "CFG", T.PlacementConfig(**small))
    cases = {p: b for p, b in jstudy.CASES.items() if p in (2, 4)}
    monkeypatch.setattr(jstudy, "CASES", cases)
    monkeypatch.setattr(tstudy, "CASES", cases)
    got, tout = tstudy.run(DEV)
    want, jout = jstudy.run()
    assert got == want
    assert_tree_equal(tout, jout)


def test_placement_search_rows_match_reference(monkeypatch):
    small = dict(quantum_cycles=2_000, trace_len=2_000,
                 steps_per_program=2_500)
    monkeypatch.setattr(jsearch, "CFG", J.PlacementConfig(**small))
    monkeypatch.setattr(tsearch, "CFG", T.PlacementConfig(**small))
    got, trep = tsearch.run(DEV)
    want, jrep = jsearch.run()
    seconds = ("cold_search_s", "search_s")
    assert [r for r in got if not r.startswith(seconds + ("#",))] == \
        [r for r in want if not r.startswith(seconds + ("#",))]
    assert {k: v for k, v in trep.items() if k not in seconds} == \
        {k: v for k, v in jrep.items() if k not in seconds}


def test_fleet_scale_study_smoke_matches_reference(monkeypatch):
    sizes = lambda pkg: [("16t_4c", 16, pkg.Topology(
        num_hosts=2, sockets_per_host=1, cores_per_socket=2))]
    monkeypatch.setenv("REPRO_FLEET_SCALE", "smoke")
    monkeypatch.setattr(jfleet, "SMOKE_SIZES", sizes(J))
    monkeypatch.setattr(tfleet, "SMOKE_SIZES", sizes(T))
    got, tout = tfleet.run(DEV)
    want, jout = jfleet.run()
    assert got[0] == want[0]
    assert [r.split(",")[:5] + r.split(",")[6:] for r in got[1:-1]] == \
        [r.split(",")[:5] + r.split(",")[6:] for r in want[1:-1]]
    assert got[-1].startswith("# finding fleet-scale smoke: 16 tenants")
    for mode in ("full", "incremental"):
        assert_tree_equal(tout["16t_4c"][mode], jout["16t_4c"][mode])


def test_perf_slot_decode_rows_match_reference(monkeypatch):
    monkeypatch.setattr(jslot, "STEPS", 4)
    monkeypatch.setattr(tslot, "STEPS", 4)
    want = jslot.run()
    jcb.load_all()
    jcfg = dataclasses.replace(jcb.get_config("arctic-480b").smoke(),
                               num_experts=128, top_k=2, capacity_factor=8.0)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), DEV)
    assert tslot.run(params, device=DEV) == want
    tcfg = tslot.config()[1]
    for field in ("d_model", "head_dim", "num_heads", "num_experts", "top_k",
                  "capacity_factor"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
