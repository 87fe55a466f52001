"""The control: the reference in float8 (e4m3) put in the program's place
reads farther from the float32 reference than the program in bf16 does,
here at a size the CPU holds.  At the cells' own sizes the control runs
on the card (`cardbench/calibrate.py`; the `cuda` test below)."""
import os
import subprocess
import sys
import time

import pytest
import torch

from cardbench import check, spec
from cardbench.drivers import serve, train
from cardbench.tests import tiny

SEED = 2 ** 34 + 5


def test_training_control_reads_farther_than_bf16():
    cell = tiny.cell(tiny.TRAIN, "bfloat16")
    rec = train.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    sound = train.correctness(rec, cell, SEED, "cpu")
    w = cell.reference.draw(cell.model, SEED, "cpu")
    ref = check.train_reference(cell, w, SEED, "cpu")
    low = check.train_reference(cell, w, SEED, "cpu", "fp8")
    control = check.train_numbers(low, ref)
    assert max(control[k] / max(sound[k], 1e-12)
               for k in ("loss_gap", "grad_gap", "change_gap")) > 3


def test_serving_control_reads_farther_than_bf16():
    cell = tiny.cell(tiny.SERVE, "bfloat16")
    cell.traffic["sample_tokens"] = 64
    rec = serve.run(cell, SEED, 3.0, False, "cpu", time.perf_counter())
    picked = serve.sample(rec, cell.traffic, SEED)
    w = rec.pop("params")
    sound = check.serve_gaps(cell, w, picked)
    control = check.control_gaps(cell, w, picked)
    assert control["logit_gap"] > sound["logit_gap"]
    assert control["route_gap"] > sound["route_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_control_fails_the_limits_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = tmp_path / "readings.json"
    subprocess.run([sys.executable, os.path.join(spec.HERE, "calibrate.py"),
                    "--workload", name, "--seeds", "101",
                    "--control-seeds", "101", "--out", str(out)],
                   check=True, cwd=spec.ROOT)
    import json
    rows = json.loads(out.read_text())["readings"]
    cell = spec.cell(name)
    for row in rows:
        ok, _ = check.judge(row, cell.limits)
        assert ok is (row["kind"] == "program"), row
