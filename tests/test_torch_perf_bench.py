"""The port's perf benchmarks (`repro_torch.bench.perf_sweep`,
`window_kernel`) at small sizes on the CPU: every section's parity code
runs (each fast engine held bit for bit to the reference machine, the
first step design to the current one, resumed states through the canonical
state), the rows and the `--record` JSON come out, and the reference's
`BENCH_sweep.json` is never written.  There is no window kernel on the
CPU, so the kernel arm is swapped for the plain one here (`KERNEL_ARM =
"plain"`); the real kernel arm runs in tests/test_torch_cuda.py and in
`chip_smoke.py` on the card."""
import hashlib
import json
import pathlib

import pytest

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import perf_sweep as jsweep
from benchmarks import window_kernel as jwk
from repro_torch.bench import __main__ as bench_main
from repro_torch.bench import perf_sweep, window_kernel
from repro_torch.core import isa, scheduler, simulator
from torch_asserts import DEV

ROOT = pathlib.Path(__file__).resolve().parent.parent
SWEEP_JSON = ROOT / "BENCH_sweep.json"

SMALL = dict(FIG6_TRACE_LEN=300, P4_FLEETS=2, P4_TRACE_LEN=200,
             P4_TOTAL_STEPS=600, P4_QUANTUM=150, PG_FLEETS=1,
             PG_TRACE_LEN=300, PG_TOTAL_STEPS=600, PG_QUANTUM=300,
             BS_TRACE_LEN=200, BS_CAPACITIES=(2, 4), RS_TRACE_LEN=300,
             RS_TOTAL_STEPS=600)
SMALL_WK = dict(WK_TRACE_LEN=400, WK_TOTAL_STEPS=800, WK_QUANTUM=200)


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(perf_sweep, k, v)
    for k, v in SMALL_WK.items():
        monkeypatch.setattr(window_kernel, k, v)
    # no kernel on the CPU: the kernel arm runs the plain pass here
    monkeypatch.setattr(window_kernel, "KERNEL_ARM", "plain")


def _digest(path: pathlib.Path) -> str:
    return hashlib.sha1(path.read_bytes()).hexdigest()


def test_sizes_are_the_reference_sizes():
    for k in ("FIG6_TRACE_LEN", "FIG6_LATENCIES", "P4_FLEETS",
              "P4_TRACE_LEN", "P4_TOTAL_STEPS", "P4_QUANTUM", "REPS",
              "PG_FLEETS", "PG_TRACE_LEN", "PG_TOTAL_STEPS", "PG_QUANTUM",
              "PG_SLOT_COUNTS", "PG_LATENCIES", "PG_PROGRAMS",
              "BS_TRACE_LEN", "BS_CAPACITIES", "BS_PENALTIES",
              "RS_TRACE_LEN", "RS_TOTAL_STEPS"):
        assert getattr(perf_sweep, k) == getattr(jsweep, k), k
    assert [n for n, _ in perf_sweep.FIG6_SCENARIOS] == \
        [n for n, _ in jsweep.FIG6_SCENARIOS]
    for k in ("WK_FLEETS", "WK_PROGRAMS", "WK_TRACE_LEN", "WK_TOTAL_STEPS",
              "WK_QUANTUM", "WK_SLOT_COUNTS", "WK_LATENCIES", "REPS"):
        assert getattr(window_kernel, k) == getattr(jwk, k), k


def test_perf_sweep_sections_hold_parity_and_leave_bench_sweep_alone(
        small, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    before = _digest(SWEEP_JSON)
    rows, report = perf_sweep.run(DEV)
    assert _digest(SWEEP_JSON) == before
    assert list(tmp_path.iterdir()) == []
    for name in ("fig6_grid", "p4_preempted", "cold_bitstream",
                 "resumed_segment"):
        assert report[name]["parity"] is True, name
        assert report[name]["speedup"] > 0
    assert sorted(report["preempted_grid"]) == ["p2", "p3", "p4"]
    for e in report["preempted_grid"].values():
        assert e["parity"] is True
        assert sorted(e["window_sweep_s"], key=int) == ["256", "512", "1024"]
        assert e["default_window"] == simulator.INTERLEAVE_WINDOW["cpu"]
    assert "inert" in report["p4_preempted"]["unroll_sweep"]
    assert report["window_kernel"]["kernel_mode"] == "plain"
    assert set(report["meta"]["section_seconds"]) == \
        set(perf_sweep.SECTIONS)
    assert rows[0] == "section,variant,seconds,speedup"
    assert rows[-1].startswith("# fast path") and "[cpu]" in rows[-1]


def test_legacy_step_equals_the_current_step():
    tensor = scheduler.fleet_traces(scheduler.make_fleets(3)[:2], 300)
    table = simulator.fleet_tag_table(isa.SCENARIO_2, 3)
    sched = simulator.SchedulerConfig(quantum_cycles=150)
    legacy = perf_sweep._legacy_sweep(
        torch_asserts.torch.as_tensor(tensor), table, [10, 50], [2, 4], 150,
        sched.handler_cycles, 4, 64, 100, 700)
    current = simulator.sweep_fleet(tensor, [10, 50], isa.SCENARIO_2, sched,
                                    slot_counts=[2, 4], total_steps=700,
                                    path="scan", device=DEV)
    for a, b in zip(legacy, current):
        assert a.shape == b.shape
        assert torch_asserts.torch.equal(a, b)


def test_window_kernel_arm_raises_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        window_kernel.run(DEV)


def test_window_kernel_rows_and_record(small, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    rows, r = window_kernel.run(DEV)
    assert r["kernel_mode"] == "plain"
    assert r["routes"] == {"window_grid": {"bitset": 0, "generic": 0},
                           "window_cell": {"bitset": 0, "generic": 0}}
    assert rows[1].startswith("window_kernel,plain,")
    assert rows[-1].startswith("# finding window kernel (plain")
    bench_main.main(["--device", "cpu", "--only", "window_kernel,perf_sweep",
                     "--record"])
    rec = json.loads((tmp_path / "experiments" /
                      "bench_torch.json").read_text())
    assert {"backend", "device", "platform_version"} <= \
        set(rec["provenance"])
    assert rec["provenance"]["backend"] == "cpu"
    assert rec["results"]["window_kernel"]["report"]["kernel_mode"] == \
        "plain"
    assert rec["results"]["perf_sweep"]["report"]["fig6_grid"]["parity"]
    assert not (tmp_path / "BENCH_sweep.json").exists()
