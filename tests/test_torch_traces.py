"""The port's numpy-only modules (`isa`, `traces`, `bitstream`,
`scheduler`) against the JAX package's: the port keeps its own copies, and
every table, mix, trace and fleet tensor must be array-equal (tolerance 0;
analytic CPIs equal as floats)."""
import dataclasses

import numpy as np
import pytest

from repro.core import bitstream as jbs
from repro.core import isa as jisa
from repro.core import scheduler as jsch
from repro.core import traces as jtr
from repro_torch.core import bitstream as tbs
from repro_torch.core import isa as tisa
from repro_torch.core import scheduler as tsch
from repro_torch.core import traces as ttr
import torch_asserts  # noqa: F401  (one torch thread under xdist)


def test_isa_tables_and_scenarios_equal():
    assert tisa.NAMES == jisa.NAMES
    assert tisa.GROUP_NAMES == jisa.GROUP_NAMES
    for name in ("INSTR_EXT", "INSTR_GROUP", "INSTR_HW_CYCLES", "GROUP_EXT",
                 "GROUP_HW_CYCLES", "SOFT_ON_I", "SOFT_ON_M"):
        np.testing.assert_array_equal(getattr(tisa, name),
                                      getattr(jisa, name), err_msg=name)
    assert set(tisa.SPECS) == set(jisa.SPECS)
    for key in tisa.SPECS:
        a, b = tisa.SPECS[key], jisa.SPECS[key]
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)
    assert set(tisa.SCENARIOS) == set(jisa.SCENARIOS)
    for key in tisa.SCENARIOS:
        a, b = tisa.SCENARIOS[key], jisa.SCENARIOS[key]
        np.testing.assert_array_equal(a.instr_tag, b.instr_tag)
        assert (a.num_slots, a.num_tags) == (b.num_slots, b.num_tags)
    assert [s.num_tags for s in (tisa.SCENARIO_1, tisa.SCENARIO_2,
                                 tisa.SCENARIO_3)] == [29, 10, 2]


def test_bitstream_configs_equal():
    for name in ("FUTURE_FAST", "NEAR_TERM", "PARTIAL_RECONFIG"):
        a, b = getattr(tbs, name), getattr(jbs, name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.reconfig_cycles, a.fill_cycles, a.miss_latency(False)) == (
            b.reconfig_cycles, b.fill_cycles, b.miss_latency(False))


@pytest.mark.parametrize("name", sorted(jtr.BENCHES))
def test_mix_cpi_and_trace_equal(name):
    a, b = ttr.mix_of(name), jtr.mix_of(name)
    np.testing.assert_array_equal(a.frac, b.frac)
    for spec in ("RV32I", "RV32IF", "RV32IM", "RV32IMF"):
        assert (ttr.analytic_cpi(a, tisa.SPECS[spec])
                == jtr.analytic_cpi(b, jisa.SPECS[spec]))
    for seed in (0, 3):
        np.testing.assert_array_equal(ttr.build_trace(name, 3_000, seed),
                                      jtr.build_trace(name, 3_000, seed))
    np.testing.assert_array_equal(
        ttr.trace_mix(ttr.build_trace(name, 2_000)),
        jtr.trace_mix(jtr.build_trace(name, 2_000)))


def test_paint_trace_and_solve_mix_equal():
    rng = np.random.default_rng(11)
    frac = rng.dirichlet(np.ones(tisa.NUM_GROUPS))
    kw = dict(length=1_500, seed_key="custom:7", hot_f_groups=("fmul",),
              cold_event_period=40, f_run_len=3, sporadic=True)
    np.testing.assert_array_equal(ttr.paint_trace(frac, **kw),
                                  jtr.paint_trace(frac, **kw))
    for name in ("minver", "matmult-int"):
        np.testing.assert_array_equal(
            ttr.solve_mix(ttr.BENCHES[name]).frac,
            jtr.solve_mix(jtr.BENCHES[name]).frac)


@pytest.mark.parametrize("k", (2, 3, 4))
def test_fleets_and_fleet_traces_equal(k):
    assert tsch.make_fleets(k) == jsch.make_fleets(k)
    fleets = tsch.make_fleets(k)[:5]
    np.testing.assert_array_equal(tsch.fleet_traces(fleets, 1_200),
                                  jsch.fleet_traces(fleets, 1_200))


def test_pairs_and_pair_traces_equal():
    assert tsch.make_pairs() == jsch.make_pairs()
    assert len(tsch.make_pairs()) == 50
    assert tsch.fm_fm_pairs() == jsch.fm_fm_pairs()
    assert tsch.fm_m_pairs() == jsch.fm_m_pairs()
    pairs = tsch.make_pairs()[::10]
    np.testing.assert_array_equal(tsch.pair_traces(pairs, 900),
                                  jsch.pair_traces(pairs, 900))
