"""§Roofline — the baseline table from the port's dry-run records: PyTorch
port of `benchmarks/roofline_table.py`.

Reads experiments/dryrun_torch/*.json (written by
`repro_torch.launch.dryrun`, one H100 a cell) and emits, per (arch x
shape x mesh): the three roofline terms at the H100's rates, the
dominant term, MODEL_FLOPS = 6·N(_active)·D (train) or 2·N(_active)·tokens
(decode/prefill-forward-only: 2·N·D), and the usefulness ratio
MODEL_FLOPS / (counted FLOPs · chips), the same columns as the
reference's.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import base as cb

__all__ = ["model_flops", "run", "main", "DRYRUN_DIR"]

DRYRUN_DIR = "experiments/dryrun_torch"


def model_flops(cfg, shape_name) -> float:
    spec = cb.SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    n = cfg.active_param_count()
    if spec.kind == "train":
        return 6.0 * n * spec.seq_len * spec.global_batch
    if spec.kind == "prefill":
        return 2.0 * n * spec.seq_len * spec.global_batch
    return 2.0 * n * spec.global_batch  # decode: one token per sequence


def run(dryrun_dir: str = DRYRUN_DIR) -> list[str]:
    cb.load_all()
    rows = ["arch,shape,mesh,compute_s,memory_s,collective_s,dominant,"
            "model_tflops,useful_ratio,fits_hbm"]
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        cfg = cb.get_config(r["arch"])
        mf = model_flops(cfg, r["shape"])
        total = r["flops_per_device"] * r["chips"]
        ratio = mf / total if total else float("nan")
        rf = r["roofline"]
        rows.append(
            f"{r['arch']},{r['shape']},{r['mesh']},"
            f"{rf['compute_s']:.3e},{rf['memory_s']:.3e},"
            f"{rf['collective_s']:.3e},{rf['dominant']},"
            f"{mf / 1e12:.1f},{ratio:.2f},"
            f"{r['memory'].get('fits_hbm')}")
    return rows


def main(print_fn=print, dryrun_dir: str = DRYRUN_DIR):
    for row in run(dryrun_dir):
        print_fn(row)


if __name__ == "__main__":
    main()
