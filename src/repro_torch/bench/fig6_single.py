"""Fig. 6 — single-benchmark reconfigurable core: 3 slot-granularity
scenarios x {10, 50, 250}-cycle miss latencies, on the 5 FM-class
benchmarks, as speedup relative to fixed RV32IMF (plus the max(IM, IF)
fixed-extension reference series).

Runs through `simulator.sweep_fleet` as P=1 fleets with a quantum no run
can reach (a single program is never preempted), so the whole
{5 benchmarks x 3 latencies} grid per scenario is one call — the same
machinery as the Fig. 7 multi-program sweeps.  Being unpreempted with a
warm bitstream cache, the grid is eligible for the stack-distance fast
path: the dispatcher serves every {slot count x latency} cell from one
Mattson pass per benchmark (see `repro.core.stackdist`), bit-for-bit equal
to the scan.  Port of the JAX package's `benchmarks/fig6_single.py`;
`device` picks where the sweeps run.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import isa, simulator, traces

LATENCIES = (10, 50, 250)
SCENARIOS = (("s1", isa.SCENARIO_1), ("s2", isa.SCENARIO_2),
             ("s3", isa.SCENARIO_3))
TRACE_LEN = 120_000
# single program, never preempted
NO_PREEMPT = simulator.SchedulerConfig.no_preempt()


def run(device="cuda") -> tuple[list[str], dict]:
    rows = ["benchmark,series,latency,speedup_vs_IMF"]
    agg: dict = {}
    fleet = np.stack([traces.build_trace(n, TRACE_LEN)
                      for n in traces.FM_BENCHES])[:, None, :]  # (5, 1, N)
    imf = {n: simulator.analytic_cpi(traces.mix_of(n), isa.RV32IMF)
           for n in traces.FM_BENCHES}
    per_scen = {}
    for sname, scen in SCENARIOS:
        res = simulator.sweep_fleet(
            fleet, LATENCIES, scen, NO_PREEMPT,
            slot_counts=(scen.num_slots,), total_steps=TRACE_LEN,
            device=device)
        per_scen[sname] = res.cpi.cpu().numpy()   # (5, 1, L, 1)
    for bi, name in enumerate(traces.FM_BENCHES):
        mix = traces.mix_of(name)
        best_fixed = max(
            imf[name] / simulator.analytic_cpi(mix, isa.RV32IM),
            imf[name] / simulator.analytic_cpi(mix, isa.RV32IF))
        rows.append(f"{name},max(IM;IF),-,{best_fixed:.3f}")
        for sname, _ in SCENARIOS:
            for li, lat in enumerate(LATENCIES):
                sp = imf[name] / float(per_scen[sname][bi, 0, li, 0])
                rows.append(f"{name},{sname},{lat},{sp:.3f}")
                agg.setdefault((sname, lat), []).append(sp)
    for (sname, lat), vals in sorted(agg.items()):
        rows.append(f"AVERAGE,{sname},{lat},{np.mean(vals):.3f}")
    rows.append("# paper anchors: s1@10>0.90, s2@10>0.90, s2@50~0.71, "
                "s3@10~0.55 (worst), s1@250~0.52")
    return rows, agg


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows, _ = run(device)
    for row in rows:
        print_fn(row)
    print_fn(f"# fig6 done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
