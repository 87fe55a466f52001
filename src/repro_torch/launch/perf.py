"""Roofline deltas of named variants of a cell: PyTorch port of
`repro.launch.perf`.  It counts a cell under a variant with the dry run's
counter (`launch.dryrun.trace_cell`, on the meta device), re-derives the
roofline terms at the H100's rates, and writes the (hypothesis, counts,
terms) record to `experiments/perf_torch/`.

Variants are small, explicit deltas over the paper-faithful baseline:

    base          — the dry run's cell as it is
    nochunk_loss  — disable the chunked loss (isolates its cost)
    *_noremat     — any of these with remat "none" (e.g. base_noremat)

The reference's `dp`, `dp_mb1`, `dp_mb4` (data parallelism over 256/512
chips, ZeRO-3) and `flash1024` (the Pallas kernel's block size) have no
meaning on one card with the port's kernels: they are refused.  The
record keeps the reference's keys; there is no XLA buffer assignment
(`xla_temp_bytes` is None) and `compile_s` is the seconds of the trace.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch granite-3-2b \\
        --shape train_4k --variant nochunk_loss --hypothesis "..."
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.analysis import cost
from repro_torch.configs import base as cb
from repro_torch.launch import dryrun

__all__ = ["VARIANTS", "EXCLUDED", "variant_config", "measure", "main"]

VARIANTS = ("base", "nochunk_loss")
EXCLUDED = {
    "dp": "data parallelism over a 256/512-chip mesh: one card has no mesh",
    "dp_mb1": "dp without microbatching: one card has no mesh",
    "dp_mb4": "dp with 4 microbatches: one card has no mesh",
    "flash1024": "the Pallas kernel's block size: the port's flash kernel "
                 "tiles for Hopper and takes no block size",
}


def variant_config(arch: str, variant: str):
    """`arch`'s config under `variant` (see the module docstring)."""
    head = variant[:-len("_noremat")] if variant.endswith("_noremat") \
        else variant
    if head in EXCLUDED:
        raise ValueError(f"variant {variant!r} is not ported: "
                         f"{EXCLUDED[head]}")
    if head not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: expected one of "
                         f"{VARIANTS}, optionally with _noremat")
    cfg = cb.get_config(arch)
    if head == "nochunk_loss":
        cfg = dataclasses.replace(cfg, loss_chunk=0)
    if variant.endswith("_noremat"):
        cfg = dataclasses.replace(cfg, remat="none")
    return cfg


def measure(arch: str, shape: str, variant: str) -> dict:
    t0 = time.time()
    traced = dryrun.trace_cell(variant_config(arch, variant), shape)
    c = traced["count"]
    terms = cost.roofline_terms(c["flops"], c["bytes"], 0.0)
    return {
        "arch": arch, "shape": shape, "variant": variant,
        "flops_per_device": c["flops_total"],
        "flops_by_class": c["flops"],
        "bytes_per_device": c["bytes"],
        "collective_bytes_per_device": 0,
        "roofline": terms,
        "xla_temp_bytes": None,
        "compile_s": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="base")
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--out", default="experiments/perf_torch")
    args = ap.parse_args(argv)
    cb.load_all()
    r = measure(args.arch, args.shape, args.variant)
    r["hypothesis"] = args.hypothesis
    os.makedirs(args.out, exist_ok=True)
    fn = f"{args.arch}_{args.shape}_{args.variant}.json"
    with open(os.path.join(args.out, fn), "w") as f:
        json.dump(r, f, indent=1)
    rf = r["roofline"]
    print(f"{args.arch} x {args.shape} [{args.variant}]: "
          f"compute={rf['compute_s']:.3e}s mem={rf['memory_s']:.3e}s "
          f"coll={rf['collective_s']:.3e}s dominant={rf['dominant']}")


if __name__ == "__main__":
    main()
