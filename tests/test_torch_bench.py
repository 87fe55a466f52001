"""The port's paper-figure benchmarks (`repro_torch.bench`) against the JAX
package's `benchmarks/` modules, cut to small traces on the CPU: every
printed row equal as text, and the fig7 grid equal as a whole (tolerance
0: int32 counters, float32 CPIs)."""
import numpy as np
import pytest

from benchmarks import bitstream_study as j_bs
from benchmarks import fig4_extensions as j_fig4
from benchmarks import fig5_classification as j_fig5
from benchmarks import fig6_single as j_fig6
from benchmarks import fig7_multi as j_fig7
from repro.core import scheduler as jsch
from repro.core import simulator as jsim
from repro_torch import bench
from repro_torch.bench import bitstream_study as t_bs
from repro_torch.bench import fig4_extensions as t_fig4
from repro_torch.bench import fig5_classification as t_fig5
from repro_torch.bench import fig6_single as t_fig6
from repro_torch.bench import fig7_multi as t_fig7
from torch_asserts import DEV, assert_equal

PAIRS = jsch.make_pairs()[::13]          # 4 pairs, FM+FM and FM+M
# long enough that every program of every fleet runs (at the 20K quantum
# for fig7, at a 4K one for the P=4 fleets)
TRACE_LEN, TOTAL_STEPS, FLEET_STEPS = 3_000, 20_000, 24_000


def test_fig4_and_fig5_rows_equal():
    assert t_fig4.run() == j_fig4.run()
    assert t_fig5.run() == j_fig5.run()
    lines, derived = bench.bench_fig4(device=DEV)
    assert derived == "minver_speedup_F=27.50 (paper 27.5)"
    lines, derived = bench.bench_fig5(device=DEV)
    assert derived.startswith("classes: FM=5 M=8 insensitive=9")


def test_small_fig7_grid_equal_as_a_whole(monkeypatch):
    monkeypatch.setattr(j_fig7, "TRACE_LEN", TRACE_LEN)
    monkeypatch.setattr(j_fig7, "TOTAL_STEPS", TOTAL_STEPS)
    got = t_fig7.sweep(PAIRS, device=DEV, trace_len=TRACE_LEN,
                       total_steps=TOTAL_STEPS)
    want = jsim.sweep_fleet(
        jsch.fleet_traces(PAIRS, TRACE_LEN), [j_fig7.MISS_LATENCY],
        j_fig7.isa.SCENARIO_2, jsim.SchedulerConfig(),
        slot_counts=j_fig7.SLOT_COUNTS, quanta=j_fig7.QUANTA,
        total_steps=TOTAL_STEPS)
    assert tuple(got.cycles.shape) == (2, 4, 3, 1, 2)
    assert_equal(got, want)
    np.testing.assert_array_equal(got.cpi.numpy(), np.asarray(want.cpi))
    rows, agg = t_fig7.run(PAIRS, device=DEV, trace_len=TRACE_LEN,
                           total_steps=TOTAL_STEPS, res=got)
    j_rows, j_agg = j_fig7.run(PAIRS)
    assert rows == j_rows
    assert bench.fig7_derived(rows) == [
        r for r in j_rows if r.startswith("# 4slot@20K")][0][2:]


def test_small_fleet_sweep_rows_equal(monkeypatch):
    monkeypatch.setattr(j_fig7, "TRACE_LEN", TRACE_LEN)
    monkeypatch.setattr(j_fig7, "FLEET_TOTAL_STEPS", FLEET_STEPS)
    rows, agg = t_fig7.run_fleets(max_fleets=3, quantum=4_000, device=DEV,
                                  trace_len=TRACE_LEN,
                                  total_steps=FLEET_STEPS)
    j_rows, j_agg = j_fig7.run_fleets(max_fleets=3, quantum=4_000)
    assert rows == j_rows
    assert bench.fleet_derived(agg) == bench.fleet_derived(j_agg)


@pytest.mark.parametrize("module", ("fig6", "bitstream"))
def test_small_fig6_and_bitstream_rows_equal(module, monkeypatch):
    if module == "fig6":
        for mod in (j_fig6, t_fig6):
            monkeypatch.setattr(mod, "TRACE_LEN", 3_000)
        rows, _ = t_fig6.run(device=DEV)
        assert rows == j_fig6.run()[0]
    else:
        assert (t_bs.run(trace_len=2_500, device=DEV)
                == j_bs.run(trace_len=2_500))
