"""Perf-regression gate over the port's bench records: PyTorch port of
`benchmarks/perf_gate.py`.

Compares a freshly benchmarked record (`experiments/bench_torch.json`'s
`results`, merged by `python -m repro_torch.bench --record`) against a
baseline record and fails when any gated module's `us_per_call` regressed
by more than `--max-slowdown`.  Absolute wall-clock compares only on the
same machine, so the baseline must be produced where the gate runs:
snapshot before re-benchmarking,

    cp experiments/bench_torch.json /tmp/bench_baseline.json
    python -m repro_torch.bench --only fig6 --record
    python -m repro_torch.bench.perf_gate \\
        --baseline /tmp/bench_baseline.json --modules fig6_single

`--modules` restricts the gate to entries re-benchmarked on both sides
(the record merges partial runs, so other entries are carried over).
Modules below `--min-us` are skipped (timer noise), as are modules on
only one side and modules whose sides were recorded on different
backends (every entry carries {backend, device, platform_version}: a CPU
baseline never gates a card's run).  An allowlist that matches nothing
fails closed.  A record file is read as {"results": {...}} (the port's)
or as a flat {name: entry} mapping (the reference's).

Exit code 0 = within budget, 1 = regression.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["compare", "load", "main", "DEFAULT_CURRENT"]

DEFAULT_CURRENT = os.path.join("experiments", "bench_torch.json")


def compare(baseline: dict, current: dict, *, max_slowdown: float,
            min_us: float, modules=None) -> tuple[list[str], list[str]]:
    """Returns (report_rows, failures).  `modules` restricts the gate to the
    listed names (the ones actually re-benchmarked on both sides — stale
    carried-over entries must not be compared)."""
    rows, failures = [], []
    shared = sorted(set(baseline) & set(current))
    if modules is not None:
        shared = [n for n in shared if n in set(modules)]
        if not shared:
            # fail closed: an allowlist that matches nothing gates nothing
            failures.append(
                f"none of the allowlisted modules {sorted(set(modules))} "
                f"exist on both sides — gate is vacuous")
    for name in shared:
        base_be = baseline[name].get("backend")
        cur_be = current[name].get("backend")
        if base_be and cur_be and base_be != cur_be:
            rows.append(f"{name}: skipped (baseline backend {base_be} != "
                        f"current {cur_be})")
            continue
        base_us = float(baseline[name].get("us_per_call", 0))
        cur_us = float(current[name].get("us_per_call", 0))
        if base_us < min_us or cur_us <= 0:
            rows.append(f"{name}: skipped (baseline {base_us:.0f}us below "
                        f"{min_us:.0f}us floor)")
            continue
        ratio = cur_us / base_us
        verdict = "OK" if ratio <= max_slowdown else "REGRESSION"
        rows.append(f"{name}: {base_us:.0f}us -> {cur_us:.0f}us "
                    f"({ratio:.2f}x) {verdict}")
        if ratio > max_slowdown:
            failures.append(
                f"{name} slowed {ratio:.2f}x (> {max_slowdown:.2f}x budget)")
    for name in sorted(set(current) - set(baseline)):
        rows.append(f"{name}: new module (no baseline), skipped")
    if not shared:
        rows.append("no shared modules between baseline and current — "
                    "nothing gated")
    return rows, failures


def load(path: str) -> dict:
    """The {name: entry} results of a record file (see the docstring)."""
    with open(path) as f:
        rec = json.load(f)
    return rec["results"] if "results" in rec else rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.perf_gate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="a bench_torch.json snapshot to compare against")
    ap.add_argument("--current", default=DEFAULT_CURRENT)
    ap.add_argument("--max-slowdown", type=float, default=1.25,
                    help="fail when us_per_call exceeds baseline by this "
                         "factor (default 1.25 = >25%% slower)")
    ap.add_argument("--min-us", type=float, default=100_000,
                    help="ignore modules whose baseline is below this "
                         "(timer noise)")
    ap.add_argument("--modules", default=None,
                    help="comma-separated module allowlist — gate only "
                         "entries re-benchmarked on both sides")
    args = ap.parse_args(argv)
    rows, failures = compare(
        load(args.baseline), load(args.current),
        max_slowdown=args.max_slowdown, min_us=args.min_us,
        modules=args.modules.split(",") if args.modules else None)
    for r in rows:
        print(r)
    if failures:
        print("PERF GATE FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print(f"perf gate passed (budget {args.max_slowdown:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
