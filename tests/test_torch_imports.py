"""Guards of the PyTorch port's boundary: `src/repro_torch/` and
`chip_smoke.py` never import jax or the JAX package, every port module
imports with jax made unimportable, and the device is explicit (no silent
move to the CPU, no kernel on CPU tensors)."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import isa, simulator, stackdist_interleaved
from repro_torch.kernels import window_distance

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line) for name, line in _imported_roots(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "repro_torch.kernels.window_distance" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _fleet():
    rng = np.random.default_rng(0)
    return rng.integers(0, isa.NUM_INSTRUCTIONS, (1, 2, 64)).astype(np.int32)


def test_default_device_is_cuda_and_raises_without_a_card(no_cuda):
    fl = _fleet()
    sched = simulator.SchedulerConfig(quantum_cycles=500)
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.sweep_fleet(fl, [10], isa.SCENARIO_2, sched,
                              slot_counts=[4], total_steps=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.simulate_many(fl[0], cfg, isa.SCENARIO_2, sched,
                                total_steps=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.simulate_single(fl[0, 0], cfg, isa.SCENARIO_2)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.init_fleet_state(2, 4)
    # the same calls run when the CPU is asked for explicitly
    res = simulator.sweep_fleet(fl, [10], isa.SCENARIO_2, sched,
                                slot_counts=[4], total_steps=100,
                                device="cpu")
    assert res.cycles.device.type == "cpu"


def test_forced_kernel_on_cpu_tensors_raises():
    fl = _fleet()
    sched = simulator.SchedulerConfig(quantum_cycles=500)
    with pytest.raises(ValueError, match="CUDA"):
        simulator.sweep_fleet(fl, [10], isa.SCENARIO_2, sched,
                              slot_counts=[4], total_steps=100,
                              path="interleaved", use_kernel="kernel",
                              device="cpu")
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    with pytest.raises(ValueError, match="CUDA"):
        simulator.simulate_many(fl[0], cfg, isa.SCENARIO_2, sched,
                                total_steps=100, return_state=True,
                                path="interleaved", use_kernel=True,
                                device="cpu")
    before = (window_distance.window_grid.launches,
              window_distance.window_cell.launches)
    with pytest.raises(ValueError, match="CUDA"):
        stackdist_interleaved.sweep_preempted(
            torch.as_tensor(fl), simulator.fleet_tag_table(isa.SCENARIO_2, 2),
            isa.INSTR_HW_CYCLES, [4], [10], [[500, 500]], [0, 1], 150, 100,
            num_tags=10, total_steps=100, window=16, use_kernel="kernel")
    assert (window_distance.window_grid.launches,
            window_distance.window_cell.launches) == before
