"""The paper-figure benchmarks of the port and their derived anchors.

Each `bench_*` function runs one module on `device` and returns
(rows, derived[, report]): the module's printed rows, the one-line anchor
the JAX package's `benchmarks/run.py` records for it and, for the perf
benchmarks, the full report `--record` keeps.  The anchors are integer
simulations turned into float32 CPIs, so they do not depend on the device:
fig4 minver_speedup_F=27.50, fig5 5/8/9, fig6 avg_s2@50c=0.687, fig7
abs 0.81 of IMF (x3.13/x1.39/x1.67), P=4 fleet 0.935/0.757/0.452.
`expert_slots` (module `bench_expert_slots`) serves a smoke-size MoE
model through the slot engine; its derived line is its first row, as the
JAX runner records it.
The sched benchmarks (`placement_study`, `placement_search`,
`online_churn`, `chaos_serve`, `fleet_scale_study`) derive their
"# finding" line, as the JAX runner does (anchors: P2/P3/P4
1.075/1.075/1.113, worst 1.0768, 1.0441 with 1 migration,
1.0377/1.0551/2.3480); `perf_slot_decode` its `slots,2,4.0` row.
`model_serve_study` (the model-zoo fleet, `repro_torch.workloads`)
derives its "# finding" line; `perf_sweep` and `window_kernel` (the
simulator's engines head to head, parity before timing) their summary
lines, and hand their reports to `--record`; `roofline_table` tabulates
the dry run's records (`repro_torch.launch.dryrun`).
`python -m repro_torch.bench` runs them all; `audit_registration` holds
every module of this package to `BENCHES` (through `MODULE_OF`) or to
`EXCLUDED`, as the reference's runner does.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.bench import (bench_expert_slots, bitstream_study,
                               chaos_serve, fig4_extensions,
                               fig5_classification, fig6_single, fig7_multi,
                               fleet_scale_study, model_serve_study,
                               online_churn, perf_slot_decode, perf_sweep,
                               placement_search, placement_study,
                               roofline_table, window_kernel)


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


def finding(lines: list[str]) -> str:
    """The "# finding" line a sched benchmark derives, without its "# "."""
    return [l for l in lines if l.startswith("# finding")][0][2:]


def bench_placement_study(device="cuda"):
    lines, _ = placement_study.run(device)
    return lines, finding(lines)


def bench_placement_search(device="cuda"):
    lines, _ = placement_search.run(device)
    return lines, finding(lines)


def bench_online_churn(device="cuda"):
    lines, _ = online_churn.run(device)
    return lines, finding(lines)


def bench_chaos_serve(device="cuda"):
    lines, _ = chaos_serve.run(device)
    return lines, finding(lines)


def bench_fleet_scale_study(device="cuda"):
    lines, _ = fleet_scale_study.run(device)
    return lines, finding(lines)


def bench_perf_slot_decode(device="cuda"):
    lines = _capture(perf_slot_decode.main, device=device)
    best = [l for l in lines if l.startswith("slots,2,4.0")]
    return lines, (best[0] if best else "")


def bench_model_serve_study(device="cuda"):
    lines, _ = model_serve_study.run(device)
    return lines, finding(lines)


def bench_perf_sweep(device="cuda"):
    lines, report = perf_sweep.run(device)
    return lines, lines[-1][2:], report


def bench_window_kernel(device="cuda"):
    lines, report = window_kernel.run(device)
    return lines, finding(lines), report


def bench_roofline(device="cuda"):
    lines = _capture(roofline_table.main)
    return lines, f"{len(lines) - 1} dry-run cells tabulated"


BENCHES = {
    "fig4_extensions": bench_fig4,
    "fig5_classification": bench_fig5,
    "fig6_single": bench_fig6,
    "fig7_multi": bench_fig7,
    "fleet_sweep": bench_fleet_sweep,
    "bitstream_study": bench_bitstream_study,
    "expert_slots": bench_slots,
    "perf_slot_decode": bench_perf_slot_decode,
    "roofline_table": bench_roofline,
    "placement_study": bench_placement_study,
    "placement_search": bench_placement_search,
    "online_churn": bench_online_churn,
    "chaos_serve": bench_chaos_serve,
    "fleet_scale_study": bench_fleet_scale_study,
    "model_serve_study": bench_model_serve_study,
    "perf_sweep": bench_perf_sweep,
    "window_kernel": bench_window_kernel,
}

# registration audit: every benchmark module of this package backs a
# BENCHES entry or is listed with the reason it is excluded
MODULE_OF = {
    "fig4_extensions": "fig4_extensions",
    "fig5_classification": "fig5_classification",
    "fig6_single": "fig6_single",
    "fig7_multi": "fig7_multi",
    "fleet_sweep": "fig7_multi",            # second entry point (run_fleets)
    "bitstream_study": "bitstream_study",
    "expert_slots": "bench_expert_slots",
    "perf_slot_decode": "perf_slot_decode",
    "roofline_table": "roofline_table",
    "placement_study": "placement_study",
    "placement_search": "placement_search",
    "online_churn": "online_churn",
    "chaos_serve": "chaos_serve",
    "fleet_scale_study": "fleet_scale_study",
    "model_serve_study": "model_serve_study",
    "perf_sweep": "perf_sweep",
    "window_kernel": "window_kernel",
}
EXCLUDED = {
    "perf_gate": "the gate comparing two bench_torch.json records, not a "
                 "benchmark",
}


def audit_registration(bench_dir: str | None = None) -> None:
    """Raise if a module of this package (`_`-prefixed ones aside) is
    neither registered (MODULE_OF) nor EXCLUDED, or if either map is
    stale: the reference runner's `audit_registration`."""
    bench_dir = bench_dir or os.path.dirname(os.path.abspath(__file__))
    modules = {os.path.splitext(f)[0] for f in os.listdir(bench_dir)
               if f.endswith(".py") and not f.startswith("_")}
    missing_map = set(BENCHES) - set(MODULE_OF)
    registered = set(MODULE_OF.values())
    orphans = modules - registered - set(EXCLUDED)
    stale = (registered | set(EXCLUDED)) - modules
    if missing_map or orphans or stale:
        raise AssertionError(
            f"benchmark registration audit failed: "
            f"BENCHES entries missing from MODULE_OF={sorted(missing_map)}, "
            f"orphan modules={sorted(orphans)}, "
            f"stale references={sorted(stale)}")
