"""Run the port's benchmarks: `python -m repro_torch.bench [--device cuda]
[--only NAME ...] [--record]`.

Prints each module's rows, then `name,seconds,derived` per module.  With
`--record` it also writes `experiments/bench_torch.json` (under the
working directory; `experiments/` is git-ignored) with the device's
provenance: backend, device name, torch/CUDA versions and, on a card, the
name and power limit `nvidia-smi` reports, and the full report of each
perf benchmark (`perf_sweep`, `window_kernel`).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from repro_torch.bench import BENCHES


def _provenance(device: torch.device) -> dict:
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="*", choices=sorted(BENCHES))
    ap.add_argument("--record", action="store_true",
                    help="write experiments/bench_torch.json")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    results = {}
    for name in args.only or BENCHES:
        t0 = time.perf_counter()
        lines, derived, *report = BENCHES[name](device=device)
        secs = time.perf_counter() - t0
        for line in lines:
            print(line)
        print(f"{name},{secs:.3f},{derived}", flush=True)
        results[name] = {"seconds": secs, "derived": derived}
        if report:
            results[name]["report"] = report[0]
    if args.record:
        os.makedirs("experiments", exist_ok=True)
        with open(os.path.join("experiments", "bench_torch.json"), "w") as f:
            json.dump({"provenance": _provenance(device),
                       "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
