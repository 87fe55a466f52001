"""The port's model-zoo workloads (`repro_torch.workloads`: `OpCount`,
the lowering, the registry) and `model_serve_study` against the JAX
package's on the CPU, exactly, given the same `OpCount`s: the port's
`opcounts._CACHE` is filled with the JAX package's counts (through
`to_dict` / `from_dict`), so the specs, the traces, `resolve_trace`, the
sched/serve hook-ups and the study's rows must equal the reference's bit
for bit.  The port's own counter is held to the reference within a
tolerance in test_torch_opcounts.py."""
import pathlib

import numpy as np
import pytest

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import model_serve_study as jstudy
from repro import sched as J
from repro import workloads as JW
from repro.core import traces as jtraces
from repro.serve import engine as je
from repro.workloads import lowering as jlow
from repro.workloads import opcounts as jopc
from repro_torch import sched as T
from repro_torch import workloads as TW
from repro_torch.bench import model_serve_study as tstudy
from repro_torch.core import traces as ttraces
from repro_torch.serve import engine as te
from repro_torch.workloads import lowering as tlow
from repro_torch.workloads import opcounts as topc
from torch_asserts import DEV, assert_tree_equal

NAMES = JW.list_workloads()
PC = dict(num_slots=4, miss_latency=50, quantum_cycles=2_000,
          trace_len=2_000, steps_per_program=2_000)


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX package's OpCount of every cell, as dicts."""
    return {n: jopc.model_opcount(*n.rsplit(":", 1)).to_dict()
            for n in NAMES}


@pytest.fixture
def shared(monkeypatch, jax_counts):
    """The port's registry over the JAX package's counts."""
    cache = {tuple(n.rsplit(":", 1)): topc.OpCount.from_dict(d)
             for n, d in jax_counts.items()}
    monkeypatch.setattr(topc, "_CACHE", cache)
    monkeypatch.setattr(TW, "_SPECS", {})
    return cache


def test_public_names_and_tables_match_reference():
    assert sorted(TW.__all__) == sorted(JW.__all__)
    assert TW.PHASES == JW.PHASES
    for name in ("F_OP_GROUP", "TRANSCENDENTALS",
                 "TRANSCENDENTAL_EXPANSION", "I_OP_GROUP",
                 "BYTES_PER_BASE_OP", "PHASES", "MIX_BATCH", "MIX_SEQ_LEN"):
        assert getattr(topc, name) == getattr(jopc, name), name
    assert tlow.PHASE_KNOBS == jlow.PHASE_KNOBS


OC = [({"fma": 10.0, "base": 5.0, "fadd": 1.0}, 20.0, 40.0, 2.0),
      ({"base": 3.0}, 0.0, 12.0, 0.0),
      ({"fdiv": 0.5, "mul": 2.0, "fsqrt": 1.25}, 7.0, 0.0, 0.5)]


@pytest.mark.parametrize("i", range(len(OC)))
def test_opcount_algebra_and_round_trip(i):
    counts, flops, nbytes, trans = OC[i]
    other = OC[(i + 1) % len(OC)]
    t = topc.OpCount(dict(counts), flops, nbytes, trans)
    j = jopc.OpCount(dict(counts), flops, nbytes, trans)
    t2, j2 = topc.OpCount(dict(other[0]), *other[1:]), \
        jopc.OpCount(dict(other[0]), *other[1:])
    for a, b in (((t + t2), (j + j2)), (t * 3.5, j * 3.5),
                 (0.25 * t, 0.25 * j)):
        assert a.to_dict() == b.to_dict()
        assert a.total() == b.total()
        np.testing.assert_array_equal(a.frac(), b.frac())
    assert t.to_dict() == j.to_dict()
    back = topc.OpCount.from_dict(j.to_dict())
    assert back == t and back.to_dict() == j.to_dict()
    assert topc.OpCount.from_dict({k: v for k, v in t.to_dict().items()
                                   if k != "transcendental_elems"}) == \
        topc.OpCount(dict(counts), flops, nbytes, 0.0)
    assert (t.__add__(1) is NotImplemented) and \
        (j.__add__(1) is NotImplemented)


def test_empty_opcount_raises_as_reference():
    msgs = []
    for oc in (topc.OpCount(), jopc.OpCount()):
        with pytest.raises(ValueError) as e:
            oc.frac()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", NAMES)
def test_spec_and_traces_match_reference(jax_counts, name):
    arch, phase = name.rsplit(":", 1)
    ts = tlow.spec_from_opcount(arch, phase,
                                topc.OpCount.from_dict(jax_counts[name]))
    js = jlow.spec_from_opcount(arch, phase,
                                jopc.OpCount.from_dict(jax_counts[name]))
    for f in ("name", "arch", "phase", "frac", "hot_f_groups",
              "cold_event_period", "f_run_len", "sporadic"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.opcount.to_dict() == js.opcount.to_dict()
    np.testing.assert_array_equal(ts.mix(), js.mix())
    for seed in (0, 1):
        a = ts.build_trace(20_000, seed)
        b = js.build_trace(20_000, seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_spec_from_opcount_rejects_unknown_phase():
    msgs = []
    for mod, oc in ((tlow, topc.OpCount({"fma": 1.0})),
                    (jlow, jopc.OpCount({"fma": 1.0}))):
        with pytest.raises(ValueError) as e:
            mod.spec_from_opcount("granite-3-2b", "train", oc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("bench", ["minver", "crc32", "nbody", "wikisort"])
def test_resolve_trace_passes_embench_through(bench):
    a = TW.resolve_trace(bench, 3_000, seed=2)
    np.testing.assert_array_equal(a, JW.resolve_trace(bench, 3_000, seed=2))
    np.testing.assert_array_equal(a, ttraces.build_trace(bench, 3_000,
                                                         seed=2))
    model = T.ContentionModel(T.PlacementConfig(trace_len=3_000),
                              trace_seed=2, device=DEV)
    np.testing.assert_array_equal(model.trace(bench), a)


@pytest.mark.parametrize("bad", ["nosuch", "granite-3-2b:train",
                                 "nosuch:decode", "granite-3-2b"])
def test_resolve_trace_errors_match_reference(bad):
    msgs = []
    for w in (TW, JW):
        with pytest.raises(ValueError) as e:
            w.resolve_trace(bad, 100)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if ":" in bad:
        msgs = []
        for w in (TW, JW):
            with pytest.raises(ValueError) as e:
                w.get_workload(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_registry_names_count_nothing(monkeypatch):
    monkeypatch.setattr(topc, "_CACHE", {})
    monkeypatch.setattr(TW, "_SPECS", {})
    assert TW.list_workloads() == JW.list_workloads()
    assert TW.list_workloads(("decode",)) == JW.list_workloads(("decode",))
    for n in NAMES + ["minver", "x:y", "granite-3-2b:train", ""]:
        assert TW.is_workload_name(n) == JW.is_workload_name(n)
    assert TW.workload_name("a", "b") == JW.workload_name("a", "b")
    assert topc._CACHE == {} and TW._SPECS == {}
    assert set(ttraces.BENCHES) == set(jtraces.BENCHES)


def test_mix_table_rows_match_reference(shared):
    assert TW.mix_table_rows() == JW.mix_table_rows()
    assert TW.mix_table_rows(NAMES[:3]) == JW.mix_table_rows(NAMES[:3])


ZOO = ["qwen1.5-4b:prefill", "rwkv6-7b:prefill", "musicgen-medium:decode",
       "llama4-maverick-400b-a17b:decode"]


def test_contention_model_on_zoo_names_matches_reference(shared):
    t = T.ContentionModel(T.PlacementConfig(**PC), device=DEV)
    j = J.ContentionModel(J.PlacementConfig(**PC))
    groups = [tuple(ZOO[:2]), tuple(ZOO[2:]), (ZOO[0], "minver"),
              tuple(ZOO[1:])]
    for pt, pj in zip(t.predict(groups), j.predict(groups)):
        assert pt.dtype == pj.dtype
        np.testing.assert_array_equal(pt, pj)
    for n in ZOO:
        np.testing.assert_array_equal(t.trace(n), j.trace(n))
        assert t.solo_cpi(n) == j.solo_cpi(n)
    assert (t.sim_calls, t.groups_simulated) == \
        (j.sim_calls, j.groups_simulated)


def test_estimate_fleet_contention_on_zoo_names_matches_reference(shared):
    kw = dict(num_slots=2, quantum_cycles=1_000, trace_len=3_000,
              total_steps=8_000)
    assert_tree_equal(
        te.estimate_fleet_contention(ZOO[:3], device=DEV, **kw),
        je.estimate_fleet_contention(ZOO[:3], **kw))


def test_model_serve_study_rows_match_reference(shared, monkeypatch,
                                                tmp_path):
    monkeypatch.chdir(tmp_path)
    assert tstudy.FLEET == jstudy.FLEET and tstudy.CASES == jstudy.CASES
    assert tstudy.CFG.__dict__ == jstudy.CFG.__dict__
    assert list(tstudy.RANDOM_SEEDS) == list(jstudy.RANDOM_SEEDS)
    trows, tout = tstudy.run(DEV)
    jrows, jout = jstudy.run()
    mix = lambda rows: [r for r in rows if r.startswith("# mix_table")]
    assert mix(trows) == [f"# mix_table 20 workloads -> {tstudy.MIX_CSV}"]
    assert [r for r in trows if r not in mix(trows)] == \
        [r for r in jrows if r not in mix(jrows)]
    for p in (2, 3):
        assert_tree_equal(tout[p], jout[p])
    assert tout["scan_dispatches"] == 0
    # the port's table beside the reference's, equal line for line
    with open(tstudy.MIX_CSV) as f, open(jstudy.MIX_CSV) as g:
        assert f.read() == g.read()
    assert tstudy.MIX_CSV.endswith("workload_mix_torch.csv")


def test_model_serve_study_on_the_ports_mixes_holds_chip_smokes_digest(
        monkeypatch, tmp_path):
    """On the port's own counted mixes the study's anchors are re-derived
    (not the reference's); its asserts hold, and its rows are the digest
    `chip_smoke.py` holds the card's run to."""
    import hashlib
    monkeypatch.syspath_prepend(
        str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TW, "_SPECS", {})
    rows, out = tstudy.run(DEV)
    assert out["scan_dispatches"] == 0
    for p in (2, 3):
        assert out[p]["placed_worst"] <= out[p]["random_worst_mean"]
    assert hashlib.sha1("\n".join(rows).encode()).hexdigest() == \
        chip_smoke.EXPECTED_ROWS["model_serve_study_torch"]
