"""Fig. 7 — multi-program environment: 50 benchmark pairs under a
round-robin scheduler, slot-count variations {2, 4, 8} at 50-cycle misses,
with 1K- vs 20K-cycle scheduler quanta; speedups vs fixed RV32IMF, plus the
fixed RV32I/IM/IF references.  Validates the paper's aggregate anchors:
4-slot@20K ~ 0.82x IMF average and 3.39x / 1.48x / 2.04x over I / IM / IF;
quantum lengthening 1K->20K improves the reconfigurable series.

The whole {2 quanta x 50 pairs x 3 slot counts x miss latency} grid runs
as ONE `simulator.sweep_fleet` call (slot counts sweep via
disambiguator masking, quanta via the quantum axis).  `run_fleets` extends
the experiment beyond the paper: P=4 fleets (`scheduler.make_fleets(4)`)
across a miss-latency grid, again one call.  Port of the JAX package's
`benchmarks/fig7_multi.py`: both grids are preempted, so they ride the
interleaved engine, whose window pass is the CUDA kernel on the card.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import isa, scheduler, simulator, traces

SLOT_COUNTS = (2, 4, 8)
QUANTA = (1_000, 20_000)
TRACE_LEN = 60_000
TOTAL_STEPS = 160_000
MISS_LATENCY = 50

# beyond-paper fleet sweep: 4-way mixes, miss-latency grid
FLEET_K = 4
FLEET_LATENCIES = (10, 50, 250)
FLEET_TOTAL_STEPS = 240_000


def sweep(pairs, *, device="cuda", trace_len: int = TRACE_LEN,
          total_steps: int = TOTAL_STEPS,
          use_kernel=None) -> simulator.FleetResult:
    """The fig7 grid: ONE sweep over {quanta x pairs x slot counts x
    latency} — the scheduler quantum is just another sweep axis."""
    tensor = scheduler.fleet_traces(pairs, trace_len)
    return simulator.sweep_fleet(
        tensor, [MISS_LATENCY], isa.SCENARIO_2,
        simulator.SchedulerConfig(), slot_counts=SLOT_COUNTS,
        quanta=QUANTA, total_steps=total_steps, use_kernel=use_kernel,
        device=device)


def run(pairs=None, *, device="cuda", trace_len: int = TRACE_LEN,
        total_steps: int = TOTAL_STEPS,
        res: simulator.FleetResult | None = None
        ) -> tuple[list[str], dict]:
    """Rows and per-series averages of fig7; `res` reuses a grid already
    swept by `sweep` with the same arguments."""
    pairs = pairs or scheduler.make_pairs()
    rows = ["pair,series,quantum,avg_speedup_vs_IMF"]
    agg: dict = {}
    if res is None:
        res = sweep(pairs, device=device, trace_len=trace_len,
                    total_steps=total_steps)
    cpis_all = res.cpi.cpu().numpy()        # (Q, B, K, 1, 2)

    for qi, q in enumerate(QUANTA):
        sched = simulator.SchedulerConfig(quantum_cycles=q)
        # fixed-ISA references (analytic fleet CPI)
        for spec_name in ("RV32I", "RV32IM", "RV32IF"):
            spec = isa.SPECS[spec_name]
            for (a, b) in pairs:
                sp = []
                for n in (a, b):
                    mix = traces.mix_of(n)
                    sp.append(simulator.fixed_fleet_cpi(mix, isa.RV32IMF,
                                                        sched) /
                              simulator.fixed_fleet_cpi(mix, spec, sched))
                agg.setdefault((spec_name, q), []).append(float(np.mean(sp)))
        cpis = cpis_all[qi]                 # (B, K, 1, 2)
        for k, nslots in enumerate(SLOT_COUNTS):
            vname = f"{nslots}slot"
            for i, (a, b) in enumerate(pairs):
                sp = []
                for j, n in enumerate((a, b)):
                    ref = simulator.fixed_fleet_cpi(
                        traces.mix_of(n), isa.RV32IMF, sched)
                    sp.append(ref / cpis[i, k, 0, j])
                val = float(np.mean(sp))
                agg.setdefault((vname, q), []).append(val)
                rows.append(f"{a}+{b},{vname},{q},{val:.3f}")

    for (series, q), vals in sorted(agg.items()):
        rows.append(f"AVERAGE,{series},{q},{np.mean(vals):.3f}")
    # paper's headline ratios (4-slot @ 20K over fixed subsets)
    k = np.mean(agg[("4slot", 20_000)])
    rows.append("# 4slot@20K vs fixed-ISA averages: "
                f"x{k / np.mean(agg[('RV32I', 20_000)]):.2f} over RV32I "
                f"(paper 3.39), "
                f"x{k / np.mean(agg[('RV32IM', 20_000)]):.2f} over RV32IM "
                f"(paper 1.48), "
                f"x{k / np.mean(agg[('RV32IF', 20_000)]):.2f} over RV32IF "
                f"(paper 2.04); abs {k:.2f} of IMF (paper 0.82)")
    return rows, agg


def _fleets(k: int, max_fleets: int | None):
    fleets = scheduler.make_fleets(k)
    return fleets if max_fleets is None else fleets[:max_fleets]


def sweep_fleets(k: int = FLEET_K, max_fleets: int | None = 24,
                 quantum: int = 20_000, *, device="cuda",
                 trace_len: int = TRACE_LEN,
                 total_steps: int = FLEET_TOTAL_STEPS,
                 use_kernel=None) -> simulator.FleetResult:
    """The k-way fleet grid: ONE sweep over {fleets x miss latencies} at
    4 slots and one quantum."""
    tensor = scheduler.fleet_traces(_fleets(k, max_fleets), trace_len)
    return simulator.sweep_fleet(
        tensor, FLEET_LATENCIES, isa.SCENARIO_2,
        simulator.SchedulerConfig(quantum_cycles=quantum), slot_counts=(4,),
        total_steps=total_steps, use_kernel=use_kernel, device=device)


def run_fleets(k: int = FLEET_K, max_fleets: int | None = 24,
               quantum: int = 20_000, *, device="cuda",
               trace_len: int = TRACE_LEN,
               total_steps: int = FLEET_TOTAL_STEPS,
               res: simulator.FleetResult | None = None
               ) -> tuple[list[str], dict]:
    """Beyond-paper: k-way fleets x miss-latency grid, one call; `res`
    reuses a grid already swept by `sweep_fleets` with the same arguments.

    Also emits per-benchmark *solo references* — each program alone on the
    core, unpreempted, same latency grid — and the per-fleet contention
    slowdown against them.  The solo columns are unpreempted + warm-cache,
    so the sweep dispatcher serves them from one stack-distance pass per
    benchmark instead of K x L scans."""
    fleets = _fleets(k, max_fleets)
    sched = simulator.SchedulerConfig(quantum_cycles=quantum)
    if res is None:
        res = sweep_fleets(k, max_fleets, quantum, device=device,
                           trace_len=trace_len, total_steps=total_steps)
    cpis = res.cpi.cpu().numpy()              # (B, 1, L, k)
    rows = [f"fleet,latency,avg_speedup_vs_IMF,avg_contention_vs_solo "
            f"(P={k}, 4 slots, quantum {quantum})"]
    agg: dict = {}
    benches = sorted({n for f in fleets for n in f})
    refs = {n: simulator.fixed_fleet_cpi(traces.mix_of(n), isa.RV32IMF,
                                         sched)
            for n in benches}
    # solo-reference columns: (B=|benches|, P=1) unpreempted sweep over the
    # same latency grid — stack-distance fast path, no scans
    solo = simulator.sweep_fleet(
        np.stack([traces.build_trace(n, trace_len) for n in benches])[
            :, None, :],
        FLEET_LATENCIES, isa.SCENARIO_2, simulator.SchedulerConfig.no_preempt(),
        slot_counts=(4,), total_steps=trace_len, device=device)
    solo_np = solo.cpi.cpu().numpy()
    solo_cpi = {n: solo_np[bi, 0, :, 0]
                for bi, n in enumerate(benches)}
    for li, lat in enumerate(FLEET_LATENCIES):
        for n in benches:
            # unpreempted solo vs plain analytic IMF (no handler term) —
            # the same quantity fig6_single reports for these cells
            imf = simulator.analytic_cpi(traces.mix_of(n), isa.RV32IMF)
            rows.append(f"solo:{n},{lat},"
                        f"{imf / solo_cpi[n][li]:.3f},1.00x")
        for i, fleet in enumerate(fleets):
            sp = float(np.mean([refs[n] / cpis[i, 0, li, j]
                                for j, n in enumerate(fleet)]))
            slowdown = float(np.mean([cpis[i, 0, li, j] / solo_cpi[n][li]
                                      for j, n in enumerate(fleet)]))
            agg.setdefault(lat, []).append(sp)
            rows.append(f"{'+'.join(fleet)},{lat},{sp:.3f},{slowdown:.2f}x")
    for lat, vals in sorted(agg.items()):
        rows.append(f"AVERAGE,{lat},{np.mean(vals):.3f},-")
    rows.append(f"# {len(fleets)} fleets of {k}; slot competition grows "
                "with P at fixed slot count (avg falls with latency); "
                "contention = fleet CPI / unpreempted solo CPI")
    return rows, agg


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows, _ = run(device=device)
    for row in rows[-12:]:
        print_fn(row)
    frows, _ = run_fleets(device=device)
    for row in frows[-6:]:
        print_fn(row)
    print_fn(f"# fig7 done in {time.time() - t0:.1f}s "
             f"({len(rows) + len(frows)} rows total)")


if __name__ == "__main__":
    main()
