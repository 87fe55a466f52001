"""Roofline deltas of named variants of a cell: PyTorch port of
`repro.launch.perf`.  It counts one rank's step of a cell under a
variant on the production mesh's shape and re-derives the roofline
terms at the H100's rates, and writes the (hypothesis, counts, terms)
record to `experiments/perf_torch/`.

The reference lowers every variant under its plan on the production
mesh (16 x 16, or 2 x 16 x 16 with `multi_pod`) and walks the compiled
HLO of one device.  Here rank 0's step under the same plan runs on the
meta device over `launch.mesh.CountingMesh` of that shape, a stand-in
that moves nothing and charges each collective its result's bytes, under
the dry run's counter (`launch.dryrun.trace_cell`: the layers counted at
1 and 2 repeats and extrapolated).  So FLOPs and bytes are a rank's and
`collective_bytes_per_device` is what rank 0's collectives return, which
the roofline's collective term reads.  `launch.dryrun` stays the
one-card count.

Variants are small, explicit deltas over the paper-faithful baseline:

    base          — the cell under its plan as it is
    dp            — pure data parallelism + ZeRO-3 (batch over all 256/512
                    ranks, each layer's weights all-gathered) for train
                    cells: the plan's `strategy_override="dp"`
    dp_mb1        — dp with microbatching disabled
    dp_mb4        — dp with 4 microbatches (64 rows of train_4k's 256 a
                    microbatch do not divide over 256 ranks: every rank
                    computes them, as the reference's `act` drops the axes)
    nochunk_loss  — disable the chunked loss (isolates its cost)
    *_noremat     — any of these with remat "none" (e.g. base_noremat)

`flash1024` (the Pallas kernel's block size) has no meaning for the
port's flash kernel, which tiles for Hopper: it is refused.  The record
keeps the reference's keys, with the FLOPs by dtype class beside them;
there is no XLA buffer assignment (`xla_temp_bytes` is None) and
`compile_s` is the seconds of the count.  `count_variant` gives the whole
count, the collectives by kind among it.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch granite-3-2b \\
        --shape train_4k --variant dp --hypothesis "..."
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
from repro_torch.launch.mesh import CountingMesh

__all__ = ["VARIANTS", "EXCLUDED", "variant_config", "production_shape",
           "count_variant", "measure", "main"]

VARIANTS = ("base", "dp", "dp_mb1", "dp_mb4", "nochunk_loss")
EXCLUDED = {
    "flash1024": "the Pallas kernel's block size: the port's flash kernel "
                 "tiles for Hopper and takes no block size",
}
_DP_MICROBATCHES = {"dp_mb1": 1, "dp_mb4": 4}


def _head(variant: str) -> str:
    head = variant[:-len("_noremat")] if variant.endswith("_noremat") \
        else variant
    if head in EXCLUDED:
        raise ValueError(f"variant {variant!r} is not ported: "
                         f"{EXCLUDED[head]}")
    if head not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: expected one of "
                         f"{VARIANTS}, optionally with _noremat")
    return head


def variant_config(arch: str, variant: str):
    """`arch`'s config under `variant` (see the module docstring)."""
    head = _head(variant)
    cfg = cb.get_config(arch)
    if head == "nochunk_loss":
        cfg = dataclasses.replace(cfg, loss_chunk=0)
    if variant.endswith("_noremat"):
        cfg = dataclasses.replace(cfg, remat="none")
    return cfg


def production_shape(multi_pod: bool = False) -> dict:
    """The production mesh's axes (`launch.mesh.make_production_mesh`)."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def count_variant(arch: str, shape: str, variant: str,
                  multi_pod: bool = False) -> dict:
    """`dryrun.trace_cell`'s record of rank 0's step of the cell under
    `variant` on the production mesh's shape (meta tensors, a
    `CountingMesh`)."""
    head = _head(variant)
    cfg = variant_config(arch, variant)
    sharded = {"mesh": CountingMesh(production_shape(multi_pod))}
    if head.startswith("dp") and cb.SHAPES[shape].kind == "train":
        sharded.update(strategy="dp",
                       microbatches=_DP_MICROBATCHES.get(head))
    return dryrun.trace_cell(cfg, shape, **sharded)


def measure(arch: str, shape: str, variant: str, multi_pod=False) -> dict:
    """The variant's record (the reference's keys): rank 0's FLOPs,
    bytes and collective bytes of one step on the production mesh's
    shape, and their roofline terms."""
    t0 = time.time()
    c = count_variant(arch, shape, variant, multi_pod)["count"]
    terms = cost.roofline_terms(c["flops"], c["bytes"],
                                c["collective_bytes"])
    return {
        "arch": arch, "shape": shape, "variant": variant,
        "flops_per_device": c["flops_total"],
        "flops_by_class": c["flops"],
        "bytes_per_device": c["bytes"],
        "collective_bytes_per_device": c["collective_bytes"],
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
