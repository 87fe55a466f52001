"""Run the port's benchmarks: the counterpart of `benchmarks/run.py`.

    python -m repro_torch.bench [--device cuda] [--only fig6,placement]
        [--out experiments/bench_torch] [--record]
    python -m repro_torch.bench --list        # the names --only matches

Prints `name,us_per_call,derived`, then each module's rows followed by
its own such line, and writes each module's rows to `<out>/<name>.csv`.
`--only` takes comma-separated substrings: a module runs when any of
them is part of its name, and a substring that matches no module is an
error naming the valid ones (exit 2). With `--record` the run is merged
into `experiments/bench_torch.json` (under the working directory;
`experiments/` is git-ignored): {"provenance": this run's, "results":
{name: entry}}, each entry `us_per_call`, `derived`, the provenance keys
`backend`, `device` and `platform_version` (torch and CUDA versions), on
a card the name and power limit `nvidia-smi` reports (`nvidia_smi`), and
a perf benchmark's full `report` (`perf_sweep`, `window_kernel`).
Entries of modules not run this time are kept; a kept entry without
provenance is dropped with a note, as the reference's
`_record_fleet_json` does, so that `perf_gate` never compares a number
it cannot attribute to a backend.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from repro_torch.bench import BENCHES
from repro_torch.device import resolve_device

__all__ = ["main", "record", "select", "provenance", "RECORD",
           "PROVENANCE_KEYS"]

RECORD = os.path.join("experiments", "bench_torch.json")
PROVENANCE_KEYS = ("backend", "device", "platform_version")


def provenance(device: torch.device) -> dict:
    """{backend, device, platform_version} of `device`, and on a card the
    `nvidia-smi` name and power limit."""
    meta = {"backend": device.type, "device": str(device),
            "platform_version": f"torch-{torch.__version__}"}
    if device.type == "cuda":
        meta["device"] = torch.cuda.get_device_name(device)
        meta["platform_version"] += f" cuda-{torch.version.cuda}"
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        meta["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    return meta


def select(only: str | None) -> list[str]:
    """The registered names that any comma-separated substring of `only`
    matches (all of them for None); ValueError naming the substrings that
    match nothing."""
    subs = [s for s in (only or "").split(",") if s]
    dead = [s for s in subs if not any(s in name for name in BENCHES)]
    if dead:
        raise ValueError(f"--only substring(s) {dead} match no registered "
                         f"module; valid names: {', '.join(BENCHES)}")
    return [name for name in BENCHES
            if not subs or any(s in name for s in subs)]


def record(results: dict, meta: dict, path: str = RECORD) -> dict:
    """Merge this run's entries into the record at `path` (see the module
    docstring) and return what was written."""
    existing: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f).get("results", {})
        except (json.JSONDecodeError, OSError, AttributeError):
            existing = {}
    dropped = [name for name, entry in existing.items()
               if name not in results
               and any(k not in entry for k in PROVENANCE_KEYS)]
    for name in dropped:
        print(f"# dropping provenance-free entry {name!r} from "
              f"{os.path.basename(path)} (re-run it to re-record)")
        del existing[name]
    existing.update(results)
    bad = sorted(name for name, entry in existing.items()
                 if any(k not in entry for k in PROVENANCE_KEYS))
    assert not bad, (
        f"entries {bad} lack {PROVENANCE_KEYS} provenance after merge")
    out = {"provenance": meta, "results": existing}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--only", default=None,
                    help="comma-separated substrings; a module runs when "
                         "any of them matches its name")
    ap.add_argument("--list", action="store_true",
                    help="print the registered module names (the values "
                         "--only matches against) and exit")
    ap.add_argument("--out", default=os.path.join("experiments",
                                                  "bench_torch"),
                    help="directory of the per-module <name>.csv files")
    ap.add_argument("--record", action="store_true",
                    help=f"merge the run into {RECORD}")
    args = ap.parse_args(argv)
    if args.list:
        for name in BENCHES:
            print(name)
        return
    try:
        names = select(args.only)
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    meta = provenance(device)
    os.makedirs(args.out, exist_ok=True)
    results = {}
    print("name,us_per_call,derived")
    for name in names:
        t0 = time.perf_counter()
        lines, derived, *report = BENCHES[name](device=device)
        us = (time.perf_counter() - t0) * 1e6
        for line in lines:
            print(line)
        with open(os.path.join(args.out, f"{name}.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
        derived = str(derived).replace(",", ";")
        print(f"{name},{us:.0f},{derived}", flush=True)
        results[name] = {"us_per_call": round(us), "derived": derived,
                         **meta}
        if report:
            results[name]["report"] = report[0]
    if args.record and results:
        record(results, meta)


if __name__ == "__main__":
    main()
