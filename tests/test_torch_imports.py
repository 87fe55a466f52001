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

from repro_torch.configs import base as cb
from repro_torch.core import isa, simulator, stackdist_interleaved
from repro_torch.core import expert_slots
from repro_torch.kernels import decode_attention, flash_attention, moe_gmm
from repro_torch.kernels import rglru_scan, rwkv6_scan, window_distance
from repro_torch.models import convert, kvcache, moe, transformer
from repro_torch.serve import engine

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
    for m in ("kernels.window_distance", "kernels.flash_attention",
              "kernels.decode_attention", "kernels.moe_gmm",
              "kernels.rglru_scan", "kernels.rwkv6_scan", "configs.base",
              "models.layers", "models.kvcache", "models.transformer",
              "models.moe", "models.rglru", "models.rwkv6",
              "models.convert", "core.expert_slots", "serve.batching",
              "serve.engine", "launch.serve", "bench.bench_expert_slots",
              "workloads", "workloads.opcounts", "workloads.lowering",
              "bench.model_serve_study", "bench.perf_sweep",
              "bench.window_kernel", "tree_util", "data.pipeline",
              "optim.adamw", "optim.compress", "train.step",
              "checkpoint.ckpt", "runtime.fault", "launch.train",
              "examples.train_lm", "examples.quickstart", "analysis",
              "analysis.cost", "launch.dryrun", "launch.perf",
              "bench.roofline_table", "bench.perf_gate",
              "examples.paper_repro", "examples.serve_models",
              "examples.serve_multitenant", "examples.serve_online",
              "examples.serve_faulty"):
        assert f"repro_torch.{m}" in mods
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


def test_model_entry_points_default_to_cuda_and_raise_without_a_card(
        no_cuda):
    cb.load_all()
    cfg = cb.get_config("granite-3-2b").smoke()
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_numpy(convert.numpy_params(cfg, 0))
    params = transformer.init_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.model_batcher(cfg, params, 2, 16)
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    assert cache[0][0]["k"].device.type == "cpu"
    # the MoE half: the slot engine, its tracker and the expert weights
    cfg = cb.get_config("arctic-480b").smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg, gen)
    params = transformer.init_params(cfg, gen, device="cpu")
    tenant = lambda: [engine.Tenant("t", np.zeros((1, 4), np.int32))]
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.SlotServeEngine(cfg, params, engine.EngineConfig(), tenant())
    slot_cfg = expert_slots.ExpertSlotConfig(8, 2, 1 << 20)
    with pytest.raises(RuntimeError, match="CUDA"):
        expert_slots.init_state(slot_cfg)
    eng = engine.SlotServeEngine(cfg, params, engine.EngineConfig(),
                                 tenant(), max_len=8, device="cpu")
    assert eng.run(2)["steps"] == 2
    assert eng.tenants[0].cache[0][0]["k"].device.type == "cpu"


def test_forced_attention_kernels_on_cpu_tensors_raise():
    q = torch.zeros((1, 4, 4, 64))
    kv = torch.zeros((1, 4, 2, 64))
    before = (flash_attention.flash_attention.launches,
              decode_attention.decode_attention.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, kv, kv, use_kernel="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(
            q[:, 0], kv, kv, torch.ones(1, dtype=torch.int32),
            use_kernel=True)
    cache = {"k": kv.clone(), "v": kv.clone()}
    with pytest.raises(TypeError, match="Mesh"):
        kvcache.decode_attention(q[:, :1], cache, kv[:, :1], kv[:, :1],
                                 torch.zeros(1, dtype=torch.int32), None,
                                 mesh=object())
    # mesh=None is the single-device path (the plain version on the CPU)
    cfg = type("Cfg", (), {"num_kv_heads": 2})()
    got, _ = kvcache.decode_attention(
        q[:, :1], {"k": kv.clone(), "v": kv.clone()}, kv[:, :1], kv[:, :1],
        torch.zeros(1, dtype=torch.int32), cfg, mesh=None)
    want, _ = kvcache.decode_attention_local(
        q[:, :1], {"k": kv.clone(), "v": kv.clone()}, kv[:, :1], kv[:, :1],
        torch.zeros(1, dtype=torch.int32), cfg)
    assert torch.equal(got, want)
    assert (flash_attention.flash_attention.launches,
            decode_attention.decode_attention.launches) == before


def test_forced_moe_kernels_on_cpu_tensors_raise():
    """The grouped-FFN kernels run only on CUDA tensors: forcing them on
    CPU tensors raises, through the wrappers and through the model's MoE
    layer, and launches nothing."""
    x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 32))
    wo = torch.zeros((2, 32, 16))
    counts = torch.ones(2, dtype=torch.int32)
    before = (moe_gmm.moe_gmm.launches, moe_gmm.moe_gmm_skip.launches)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm.moe_gmm(x, w, w, wo, use_kernel="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm.moe_gmm_skip(x, w, w, wo, counts, use_kernel=True)
    cb.load_all()
    cfg = cb.get_config("arctic-480b").smoke()
    p = {k: v[0] for k, v in moe.init_moe(torch.Generator(), cfg, 1,
                                          "cpu").items()}
    with pytest.raises(ValueError, match="CUDA"):
        moe.moe_apply(p, torch.zeros((1, 3, cfg.d_model)), cfg,
                      skip_empty=True, use_kernel="kernel")
    assert (moe_gmm.moe_gmm.launches, moe_gmm.moe_gmm_skip.launches) == \
        before


def test_forced_scan_kernels_on_cpu_tensors_raise(no_cuda):
    """The RG-LRU and WKV kernels run only on CUDA tensors: forcing them
    on CPU tensors raises, through the wrappers and through the model's
    recurrent blocks, and launches nothing; their caches default to the
    card too."""
    w = torch.zeros(8)
    before = (rglru_scan.rglru_scan.launches, rwkv6_scan.rwkv6_scan.launches)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan.rglru_scan(torch.zeros((1, 3, 8)), w, w, w, w, w,
                              use_kernel="kernel")
    x = torch.zeros((1, 3, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan.rwkv6_scan(x, x, x, x, torch.zeros((2, 16)),
                              use_kernel=True)
    cb.load_all()
    for arch in ("recurrentgemma-9b", "rwkv6-7b"):
        cfg = cb.get_config(arch).smoke()
        params = transformer.init_params(cfg, torch.Generator(), "cpu")
        with pytest.raises(ValueError, match="CUDA"):
            transformer.prefill(cfg, params,
                                {"tokens": np.zeros((1, 3), np.int32)},
                                use_kernel="kernel")
        with pytest.raises(RuntimeError, match="CUDA"):
            transformer.init_cache(cfg, 2, 8)
    assert (rglru_scan.rglru_scan.launches,
            rwkv6_scan.rwkv6_scan.launches) == before
