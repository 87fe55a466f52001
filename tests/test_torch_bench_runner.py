"""The port's bench runner (`python -m repro_torch.bench`) and perf gate
(`repro_torch.bench.perf_gate`) against the JAX package's
`benchmarks/run.py` and `benchmarks/perf_gate.py`: the registered names,
`--list`, `--only` by comma-separated substrings (exit 2 on a substring
that matches nothing), the per-module CSVs, the merged record with
per-entry provenance, the registration audit, and `compare` equal to the
reference's on the same records."""
import json
import shutil

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import perf_gate as j_gate
from benchmarks import run as j_run
from repro_torch import bench
from repro_torch.bench import __main__ as runner
from repro_torch.bench import perf_gate as t_gate


def test_registered_names_are_the_reference_names():
    assert sorted(bench.BENCHES) == sorted(j_run.BENCHES)
    assert bench.MODULE_OF == j_run.MODULE_OF
    bench.audit_registration()


def test_list_prints_every_name(capsys):
    runner.main(["--list"])
    assert capsys.readouterr().out.split() == list(bench.BENCHES)


def test_only_matches_substrings_and_refuses_dead_ones(capsys):
    assert runner.select("fig4,placement") == [
        "fig4_extensions", "placement_study", "placement_search"]
    assert runner.select(None) == list(bench.BENCHES)
    with pytest.raises(SystemExit) as e:
        runner.main(["--device", "cpu", "--only", "fig4,nosuchbench"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "['nosuchbench']" in err and "fig4_extensions" in err


def test_csvs_and_the_merged_record(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    record = tmp_path / "experiments" / "bench_torch.json"
    record.parent.mkdir()
    record.write_text(json.dumps({"provenance": {}, "results": {
        "chaos_serve": {"us_per_call": 5, "derived": "kept",
                        "backend": "cuda", "device": "H100",
                        "platform_version": "torch"},
        "fig6_single": {"us_per_call": 7, "derived": "legacy"}}}))
    runner.main(["--device", "cpu", "--only", "fig4", "--out", "csv"])
    assert not json.loads(record.read_text())["results"].get(
        "fig4_extensions")       # no --record: the record is untouched
    runner.main(["--device", "cpu", "--only", "fig5,fig4", "--out", "csv",
                 "--record"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert "dropping provenance-free entry 'fig6_single'" in out
    for name in ("fig4_extensions", "fig5_classification"):
        lines = (tmp_path / "csv" / f"{name}.csv").read_text().splitlines()
        assert lines == bench.BENCHES[name](device="cpu")[0]
    rec = json.loads(record.read_text())
    assert set(rec) == {"provenance", "results"}
    assert rec["provenance"]["backend"] == "cpu"
    res = rec["results"]
    assert set(res) == {"chaos_serve", "fig4_extensions",
                        "fig5_classification"}
    assert res["chaos_serve"]["derived"] == "kept"
    entry = res["fig4_extensions"]
    assert entry["derived"] == "minver_speedup_F=27.50 (paper 27.5)"
    assert {"us_per_call", "derived", *runner.PROVENANCE_KEYS} <= set(entry)
    assert entry["backend"] == "cpu" and entry["us_per_call"] > 0
    # the gate: a record against itself passes, one entry 2x slower fails
    slow = tmp_path / "slow.json"
    res["fig5_classification"]["us_per_call"] *= 2
    slow.write_text(json.dumps(rec))
    assert t_gate.main(["--baseline", str(record), "--min-us", "0"]) == 0
    assert t_gate.main(["--baseline", str(record), "--current", str(slow),
                        "--min-us", "0"]) == 1
    assert "fig5_classification slowed 2.00x" in capsys.readouterr().err


def test_audit_finds_orphans_and_stale_names(tmp_path, monkeypatch):
    src = tmp_path / "bench"
    shutil.copytree(bench.__path__[0], src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench.audit_registration(str(src))
    (src / "orphan.py").write_text("")
    with pytest.raises(AssertionError, match="orphan"):
        bench.audit_registration(str(src))
    (src / "orphan.py").unlink()
    monkeypatch.setitem(bench.EXCLUDED, "gone", "a module that left")
    with pytest.raises(AssertionError, match="gone"):
        bench.audit_registration(str(src))


ENTRY = st.fixed_dictionaries(
    {"us_per_call": st.integers(0, 10**7)},
    optional={"backend": st.sampled_from(["cpu", "cuda", "gpu"])})
RECORDS = st.dictionaries(st.sampled_from(["a", "b", "c", "d"]), ENTRY,
                          max_size=4)


@settings(max_examples=60, deadline=None)
@given(RECORDS, RECORDS,
       st.floats(1.0, 3.0, allow_nan=False),
       st.sampled_from([0.0, 1e3, 1e5]),
       st.one_of(st.none(), st.lists(st.sampled_from(["a", "b", "x"]),
                                     max_size=3)))
def test_compare_equals_the_reference(base, cur, slowdown, min_us, modules):
    kw = dict(max_slowdown=slowdown, min_us=min_us, modules=modules)
    assert _outcome(t_gate.compare, base, cur, kw) == _outcome(
        j_gate.compare, base, cur, kw)


def _outcome(compare, base, cur, kw):
    """("ok", (rows, failures)) or ("raised", the exception's type): both
    gates raise on the same records (a zero baseline above the floor
    divides by zero in either), so the two are held to the same outcome."""
    try:
        return "ok", compare(base, cur, **kw)
    except Exception as e:  # noqa: BLE001  (the type is what is compared)
        return "raised", type(e)


def test_compare_raises_where_the_reference_raises_on_a_zero_baseline():
    base, cur = {"a": {"us_per_call": 0}}, {"a": {"us_per_call": 1}}
    kw = dict(max_slowdown=1.0, min_us=0.0, modules=None)
    for compare in (t_gate.compare, j_gate.compare):
        with pytest.raises(ZeroDivisionError):
            compare(base, cur, **kw)
    assert _outcome(t_gate.compare, base, cur, kw) == (
        "raised", ZeroDivisionError)
