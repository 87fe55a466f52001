"""The paper-figure benchmarks of the port and their derived anchors.

Each `bench_*` function runs one module on `device` and returns
(rows, derived): the module's printed rows and the one-line anchor the JAX
package's `benchmarks/run.py` records for it.  The anchors are integer
simulations turned into float32 CPIs, so they do not depend on the device:
fig4 minver_speedup_F=27.50, fig5 5/8/9, fig6 avg_s2@50c=0.687, fig7
abs 0.81 of IMF (x3.13/x1.39/x1.67), P=4 fleet 0.935/0.757/0.452.
`bench_expert_slots` serves a smoke-size MoE model through the slot
engine; its derived line is its first row, as the JAX runner records it.
`python -m repro_torch.bench` runs them all.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench import (bench_expert_slots, bitstream_study,
                               fig4_extensions, fig5_classification,
                               fig6_single, fig7_multi)


def _capture(main, **kw) -> list[str]:
    lines: list[str] = []
    main(print_fn=lines.append, **kw)
    return lines


def bench_fig4(device="cuda"):
    lines = _capture(fig4_extensions.main)
    minver = [l for l in lines if l.startswith("minver,")][0].split(",")
    return lines, f"minver_speedup_F={minver[6]} (paper 27.5)"


def bench_fig5(device="cuda"):
    lines = _capture(fig5_classification.main)
    return lines, [l for l in lines if l.startswith("# classes")][0][2:]


def bench_fig6(device="cuda"):
    lines = _capture(fig6_single.main, device=device)
    s2_50 = [l for l in lines if l.startswith("AVERAGE,s2,50")][0]
    return lines, f"avg_s2@50c={s2_50.split(',')[-1]} (paper ~0.71)"


def fig7_derived(lines: list[str]) -> str:
    return [l for l in lines if l.startswith("# 4slot@20K")][0][2:]


def bench_fig7(device="cuda"):
    lines, _ = fig7_multi.run(device=device)
    return lines, fig7_derived(lines)


def fleet_derived(agg: dict) -> str:
    return "; ".join(f"P4_avg@{lat}c={np.mean(v):.3f}"
                     for lat, v in sorted(agg.items()))


def bench_fleet_sweep(device="cuda"):
    lines, agg = fig7_multi.run_fleets(device=device)
    return lines, fleet_derived(agg)


def bench_bitstream_study(device="cuda"):
    lines = _capture(bitstream_study.main, device=device)
    return lines, [l for l in lines if l.startswith("# finding")][0][2:]


def bench_slots(device="cuda"):
    lines = _capture(bench_expert_slots.main, device=device)
    return lines, lines[1] if len(lines) > 1 else ""


BENCHES = {
    "fig4_extensions": bench_fig4,
    "fig5_classification": bench_fig5,
    "fig6_single": bench_fig6,
    "fig7_multi": bench_fig7,
    "fleet_sweep": bench_fleet_sweep,
    "bitstream_study": bench_bitstream_study,
    "bench_expert_slots": bench_slots,
}
