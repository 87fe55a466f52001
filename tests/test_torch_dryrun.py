"""The port's dry run and its counter (`repro_torch.launch.dryrun`,
`repro_torch.analysis.cost`, `launch.perf`, `bench.roofline_table`)
against the JAX package's on the CPU.

The pure functions equal the reference's exactly (`opt_config_for`,
`microbatches_for`, `model_flops`, `hbm_budget` at the reference's mesh
sizes, `roofline_terms` with the reference's constants).  The counter
gives the same count on the meta device as on real CPU tensors for every
arch's smoke config in train, prefill and decode, and the dry run's
extrapolation from one and two repeats of a segment equals the count of
the whole depth.  Against the JAX package's HLO walker on the granite
smoke train step the gaps are named and pinned:

  * contractions: the JAX step runs the model's padded block-scan
    attention, 2 products in the forward and 5 in the backward (it
    recomputes the scores); the port charges the flash kernel its visible
    (query, key) pairs and takes the plain block scan's 2 recomputed and
    4 backward products (the card's route, `KernelVjp`).  So the JAX
    step's dot FLOPs are the port's contractions and kernel FLOPs plus,
    a layer, one padded product less the kernel's count: exactly;
  * elementwise: XLA:CPU's instruction stream materialises broadcasts,
    copies, transposes and the masks' selects, which eager PyTorch runs
    as views or not at all: the port counts 0.15-0.22 of them.
  * in all, the port's total is within 0.25 of the JAX step's."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import roofline_table as j_roof
from repro.analysis import hlo
from repro.configs import base as jcb
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.analysis import cost
from repro_torch.bench import roofline_table as t_roof
from repro_torch.configs import base as cb
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun
from repro_torch.launch import perf as t_perf
from torch_asserts import DEV


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module; its import sets XLA_FLAGS to 512
    host devices, which is put back at once (jax reads it when a backend
    starts)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


cb.load_all()
jcb.load_all()
CELLS = cb.cells()
SPECS = {"train": cb.ShapeSpec("t", 32, 2, "train"),
         "prefill": cb.ShapeSpec("p", 32, 2, "prefill"),
         "decode": cb.ShapeSpec("d", 32, 2, "decode")}
# the totals a count is held by; `by_op` names ops, which the devices
# lower differently (a scalar written into a slice: `fill_` on the CPU,
# `copy_` on meta, the same count)
TOTALS = ("flops", "flops_total", "bytes", "bytes_read", "bytes_written",
          "kernel_bytes", "ops", "kernels")


def _totals(count: dict) -> dict:
    return {k: count[k] for k in TOTALS}


def test_cells_are_the_reference_cells():
    assert CELLS == jcb.cells() and len(CELLS) == 32


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_opt_config_and_microbatches_equal(arch, jdry):
    cfg, jcfg = cb.get_config(arch), jcb.get_config(arch)
    assert dataclasses.asdict(dryrun.opt_config_for(cfg)) == \
        dataclasses.asdict(jdry.opt_config_for(jcfg))
    assert dryrun.microbatches_for(cfg) == jdry.microbatches_for(jcfg)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_budget_equal(arch, shape, jdry):
    assert t_roof.model_flops(cb.get_config(arch), shape) == \
        j_roof.model_flops(jcb.get_config(arch), shape)
    for chips in (256, 512):
        assert dryrun.hbm_budget(arch, shape, chips) == \
            jdry.hbm_budget(arch, shape, chips)


def test_one_card_budget_holds_the_model_whole():
    spec = cb.ShapeSpec("train_granite", 1024, 4, "train")
    b = dryrun.hbm_budget("granite-3-2b", spec, chips=1)
    n = cb.get_config("granite-3-2b").param_count()
    assert b["params"] == b["grads"] == 2 * n
    assert b["opt_mv"] == 8 * n and b["master"] == 4 * n
    assert b["act_checkpoints"] == 40 * 4 * 1024 * 2048 * 2
    assert b["layer_workspace"] == 4 * 1024 * 2048 * 4 * 3
    assert round(b["total"] / 1e9, 1) == 41.3


@pytest.mark.parametrize("args", [(1e15, 3e12, 0.0), (2e12, 8e13, 5e11),
                                  (0.0, 1.0, 0.0), (7.7e17, 1.1e15, 4e13)])
def test_roofline_terms_equal_with_the_reference_constants(args):
    ref = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    want = hlo.roofline_terms(*args, **ref)
    assert cost.roofline_terms(*args, **ref) == want
    assert cost.roofline_terms({"bf16": args[0]}, *args[1:], **ref) == want


def test_roofline_terms_sum_the_classes_at_the_card_rates():
    got = cost.roofline_terms({"bf16": 989e12, "f32": 67e12,
                               "int": cost.H100_PEAK["int"]}, 3.35e12)
    assert got == {"compute_s": 3.0, "memory_s": 1.0, "collective_s": 0.0,
                   "dominant": "compute"}


def test_counter_rules():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    with cost.CostCounter() as c:
        y = a @ b                       # mm: 2 M N K
        y.t()[1:].unsqueeze(0)          # views: nothing
        z = (y + 1.0).to(torch.bfloat16)
        (z > 0).sum()
        torch.empty(5)
    assert c.by_op["mm"]["flops"]["f32"] == 2 * 8 * 4 * 16
    assert c.by_op["mm"]["bytes"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert c.by_op["_to_copy"]["flops"] == {"bf16": 32, "f32": 0, "int": 0}
    assert c.by_op["gt"]["flops"] == {"bf16": 32, "f32": 0, "int": 0}
    assert c.ops == 5 and set(c.by_op) == {"mm", "add", "_to_copy", "gt",
                                           "sum"}
    assert c.flops == {"bf16": 64, "f32": 2 * 8 * 4 * 16 + 32,
                       "int": 1}


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_meta_count_equals_the_cpu_count(arch, kind):
    """The same step on meta tensors and on real CPU tensors: the same
    FLOPs by class, bytes, ops and kernel charges; and the meta count
    extrapolated from one and two repeats of the segment equals the CPU
    count of four."""
    cfg = cb.get_config(arch).smoke()
    unit, tail, _ = dryrun.repeats(cfg)
    cfg = dataclasses.replace(cfg, num_layers=4 * unit + tail)
    on_cpu = dryrun.trace_cell(cfg, SPECS[kind], DEV, extrapolate=False)
    on_meta = dryrun.trace_cell(cfg, SPECS[kind], "meta", extrapolate=False)
    assert _totals(on_meta["count"]) == _totals(on_cpu["count"])
    scaled = dryrun.trace_cell(cfg, SPECS[kind], "meta")
    assert scaled["layers_traced"] == [unit + tail, 2 * unit + tail]
    assert _totals(scaled["count"]) == _totals(on_cpu["count"])
    kernels = set(on_cpu["count"]["kernels"])
    assert kernels and kernels <= {"flash_attention", "decode_attention",
                                   "moe_gmm", "moe_gmm_skip", "rglru_scan",
                                   "rwkv6_scan"}


def test_granite_train_step_against_the_jax_hlo_walk():
    b, t = 4, 64
    jcfg = jcb.get_config("granite-3-2b").smoke()
    opt = jadamw.AdamWConfig()
    txt = jax.jit(jstep.make_train_step(jcfg, opt, None)).lower(
        jstep.abstract_state(jcfg, opt),
        {"tokens": jax.ShapeDtypeStruct((b, t), jnp.int32)}).compile(
    ).as_text()
    walk, hist = hlo.analyze_module(txt), hlo.op_histogram(txt)
    cfg = cb.get_config("granite-3-2b").smoke()
    c = dryrun.trace_cell(cfg, cb.ShapeSpec("t", t, b, "train"), DEV,
                          extrapolate=False)["count"]
    dots = sum(sum(v["flops"].values()) for k, v in c["by_op"].items()
               if k in cost.CONTRACTIONS)
    kernel = sum(c["kernels"]["flash_attention"]["flops"].values())
    h, dh, layers = cfg.num_heads, cfg.head_dim, cfg.num_layers
    padded = 2 * b * t * h * 512 * dh          # one block-scan product
    per_layer = fa.cost(b, t, t, h, cfg.num_kv_heads, dh, torch.float32)
    assert kernel == layers * per_layer["flops"]["f32"]
    assert hist["dot:f"] == dots + kernel + layers * (
        padded - per_layer["flops"]["f32"])
    elementwise = c["flops_total"] - dots - kernel
    ratio = elementwise / (walk["flops"] - hist["dot:f"])
    assert 0.15 <= ratio <= 0.22
    assert abs(c["flops_total"] / walk["flops"] - 1) <= 0.25


def test_dryrun_writes_every_cell(tmp_path, capsys):
    dryrun.main(["--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "32 passed, 0 failed" in out
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 32
    r = json.loads((tmp_path / "granite-3-2b_train_4k_1.json").read_text())
    assert r["chips"] == 1 and r["mesh"] == "1"
    assert r["flops_per_device"] == sum(r["flops_by_class"].values())
    assert r["memory"]["hbm_budget"] == dryrun.hbm_budget(
        "granite-3-2b", "train_4k", 1)
    assert set(r["kernels"]) == {"flash_attention"}
    rows = t_roof.run(str(tmp_path))
    assert len(rows) == 33 and rows[0] == (
        "arch,shape,mesh,compute_s,memory_s,collective_s,dominant,"
        "model_tflops,useful_ratio,fits_hbm")
    # granite trains at ~0.8 of 6 N D: remat's recompute and attention
    row = [r for r in rows if r.startswith("granite-3-2b,train_4k")][0]
    assert 0.5 < float(row.split(",")[8]) < 1.0


def test_perf_variants(tmp_path):
    base = t_perf.measure("granite-3-2b", "train_4k", "base")
    nochunk = t_perf.measure("granite-3-2b", "train_4k", "nochunk_loss")
    noremat = t_perf.measure("granite-3-2b", "train_4k", "base_noremat")
    # the chunked loss recomputes each chunk's logits in the backward;
    # remat "full" recomputes every layer's forward
    assert nochunk["flops_per_device"] < base["flops_per_device"]
    assert noremat["flops_per_device"] < base["flops_per_device"]
    assert set(base) == {"arch", "shape", "variant", "flops_per_device",
                         "flops_by_class", "bytes_per_device",
                         "collective_bytes_per_device", "roofline",
                         "xla_temp_bytes", "compile_s"}
    for variant in ("flash1024", "flash1024_noremat"):
        with pytest.raises(ValueError, match="not ported"):
            t_perf.variant_config("granite-3-2b", variant)
    # the dp variants keep the config (the plan takes the strategy);
    # test_torch_gspmd_dp.py counts them
    for variant in ("dp", "dp_mb1", "dp_mb4"):
        assert t_perf.variant_config("granite-3-2b", variant).remat == "full"
    assert t_perf.variant_config("granite-3-2b", "dp_noremat").remat == \
        "none"
    t_perf.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--hypothesis", "h"])
    r = json.loads((tmp_path / "granite-3-2b_decode_32k_base.json")
                   .read_text())
    assert r["hypothesis"] == "h" and r["roofline"]["dominant"] == "memory"
