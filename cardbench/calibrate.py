"""The readings that a cell's limits are set from, on the card at the
cell's own size (not run by the benchmark's runs).

    python3 cardbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 6] [--out FILE]

For every seed, the program's numbers as a run takes them (training: its
set-up steps and the reference's three; serving: a short window at the
cell's load and its sample).  For each control seed, the control: the
reference computed in float8 (e4m3) where the configuration states bf16,
put in the program's place; for a training cell also the reference with
half of each batch left out (the mean over the rest).  A state left
unchanged reads 1 on `change_gap` by its definition and is not run.
Prints one JSON line a reading and writes them all to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from cardbench import run as _run  # noqa: E402,F401  (paths and caches)

import torch  # noqa: E402

from cardbench import check, spec  # noqa: E402
from cardbench.drivers import serve, train  # noqa: E402


def _emit(out: list, row: dict) -> None:
    out.append(row)
    print(json.dumps(row), flush=True)


def train_readings(cell, seeds, control_seeds, dev, out) -> None:
    for seed in seeds:
        t = time.perf_counter()
        rec = train.run(cell, seed, 0.0, False, dev, t)
        numbers = train.correctness(rec, cell, seed, dev)
        _emit(out, {"seed": seed, "kind": "program", **numbers,
                    "loss": rec["checked"]["loss"],
                    "s": time.perf_counter() - t})
        if seed not in control_seeds:
            continue
        drawn = cell.reference.draw(cell.model, seed, dev)
        ref = check.train_reference(cell, drawn, seed, dev)
        for kind, kw in (("control_fp8", {"mode": "fp8"}),
                         ("fault_half_batch",
                          {"rows": slice(0, cell.traffic["batch"] // 2)})):
            low = check.train_reference(cell, drawn, seed, dev, **kw)
            _emit(out, {"seed": seed, "kind": kind,
                        **check.train_numbers(low, ref),
                        "loss": low["loss"]})
        del drawn
        torch.cuda.empty_cache()


def serve_readings(cell, seeds, control_seeds, dev, out, seconds) -> None:
    for seed in seeds:
        t = time.perf_counter()
        rec = serve.run(cell, seed, seconds, False, dev, t)
        picked = serve.sample(rec, cell.traffic, seed)
        params = rec.pop("params")
        rec.clear()
        torch.cuda.empty_cache()
        gaps = check.serve_gaps(cell, params, picked)
        _emit(out, {"seed": seed, "kind": "program", **gaps,
                    "requests": len(picked), "s": time.perf_counter() - t})
        if seed in control_seeds:
            _emit(out, {"seed": seed, "kind": "control_fp8",
                        **check.control_gaps(cell, params, picked)})
        del params
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out: list = []
    if cell.traffic["kind"] == "train":
        train_readings(cell, seeds, controls, "cuda", out)
    else:
        serve_readings(cell, seeds, controls, "cuda", out, args.seconds)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"cell": cell.name, "readings": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
