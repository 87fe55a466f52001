"""The cases and the rank body of the `dp` training tests
(`test_torch_gspmd_dp.py`): one job of `RANKS` gloo ranks
(`repro_torch.launch.mesh.spawn(run_ranks, (cases,))`) trains each case
under the port's plan with `strategy_override="dp"` (the batch's rows
over every axis, every leaf cut over every axis and gathered a layer at
a time: ZeRO-3) on a (data 2, model 2) mesh, each rank returning its
blocks as `torch_gspmd_train_checks._case` gives them.  The JAX side is
`jax_gspmd_train_reference.py` given `OPTIONS` (the same strategy, rows
and microbatches).  Rank 0 also counts one `dp` step of granite under
`analysis.cost.CostCounter` on its CPU tensors, and the same rank's step
on the meta device through `launch.mesh.CountingMesh` (`counts`)."""
import json

import torch

import torch_gspmd_train_checks as tchk
from torch_gspmd_checks import Case

RANKS, MESH, T = tchk.RANKS, tchk.MESH, tchk.T
STRATEGY = "dp"
# head-TP's arch with remat "full"; two microbatches of 4 rows (one row
# a rank); four microbatches of 1 row, which does not divide over the 4
# ranks (every rank computes it, the loss counted on rank 0); the
# sequence-parallel arch with remat "dots" and the loss in chunks of 4;
# RG-LRU and local attention; experts (expert-parallel over `model`
# inside the layer) with the factored second moment
CASES = (Case("granite-3-2b", "granite-3-2b", True,
              (("remat", "full"),), T),
         Case("granite-3-2b-mb2", "granite-3-2b", True, (), T),
         Case("granite-3-2b-mb4", "granite-3-2b", True, (), T),
         Case("qwen1.5-4b", "qwen1.5-4b", False,
              (("loss_chunk", 4), ("remat", "dots")), T),
         Case("recurrentgemma-9b", "recurrentgemma-9b", True, (), T),
         Case("arctic-480b", "arctic-480b", True, (), T))
ROWS = {"granite-3-2b-mb2": 8}
MICROBATCHES = {"granite-3-2b-mb2": 2, "granite-3-2b-mb4": 4}
# every leaf `numpy_params` sets to a constant (norm scales, biases, the
# recurrent blocks' gates and mixes) drawn about it: "dp" cuts these
# over every axis and gathers them, and a block put back in the wrong
# place shows only where the blocks differ (a zero bias also leaves its
# state after three steps to Adam's normalised updates alone, where f32
# rounding of the gradients moves it ~1e-4 relative)
DRAWN = r"(ln1|ln2|final_norm|b[qkv]|w_r|b_r|w_i|b_i|mu|mu_cm|w0|ln_o" \
        r"|ln_o_b)$"
OPTIONS = json.dumps({"strategy": STRATEGY, "rows": ROWS,
                      "microbatches": MICROBATCHES, "drawn": DRAWN})
COUNTED = CASES[0]
# granite's prefill under the "dp" plan (the decode plan takes no
# strategy), held to the reference's `serve.step` prefill
PREFILL = Case("granite-3-2b-dp-prefill", "granite-3-2b", True)
PREFILL_OPTIONS = json.dumps({"strategy": STRATEGY, "prefill_only": True})


def prefill(mesh) -> dict:
    """PREFILL's `jit_prefill_step` on this rank's "dp" blocks of the
    weights: its logits and expert loads (as `calls[0]`) and its blocks
    of the prompt's cache (the decode layout)."""
    from repro_torch.configs import base as cb
    from repro_torch.models import convert
    from repro_torch.serve import step
    from repro_torch.sharding import ShardingPlan
    from repro_torch.tree_util import tree_map
    import torch_gspmd_checks as gchk
    cfg = gchk.config(cb, PREFILL)
    plan = ShardingPlan(mesh, cfg, mode="prefill", fsdp=PREFILL.fsdp,
                        strategy_override=STRATEGY)
    params = tree_map(torch.clone, plan.shard_params(
        convert.params_from_numpy(gchk.weights(cfg), "cpu")))
    batch, _ = gchk.inputs(PREFILL)
    fn, _ = step.jit_prefill_step(
        cfg, plan, {k: (v.shape, v.dtype) for k, v in batch.items()})
    logits, cache, loads = fn(params, batch)
    return {"calls": [(logits, loads)], "prefill_cache": cache}


def counts(mesh) -> dict:
    """One `dp` train step of COUNTED on this rank's CPU blocks under a
    `CostCounter` (the CPU's ops), and this rank's step of the same
    plan on meta blocks through a `CountingMesh` of the same shape:
    both counters' results."""
    from repro_torch.analysis import cost
    from repro_torch.configs import base as cb
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.sharding import ShardingPlan
    from repro_torch.train import step
    from repro_torch.tree_util import tree_map
    import torch_gspmd_checks as gchk
    cfg = gchk.config(cb, COUNTED)
    opt = tchk.opt_config(adamw, COUNTED)
    batch = tchk.batches(COUNTED)[0]
    specs_in = {k: (v.shape, v.dtype) for k, v in batch.items()}
    out = {}
    for name, m, dev in (("real", mesh, "cpu"),
                         ("stand_in", CountingMesh(MESH, mesh.rank),
                          "meta")):
        plan = ShardingPlan(m, cfg, mode="train", fsdp=COUNTED.fsdp,
                            strategy_override=STRATEGY)
        train, shapes, specs = step.jit_train_step(cfg, opt, plan,
                                                   specs_in)
        if dev == "meta":
            state = plan.shard_state(shapes, specs)
            data = {k: torch.zeros(v.shape, dtype=torch.int32,
                                   device="meta") for k, v in batch.items()}
        else:
            whole = adamw.init_state(opt, convert.params_from_numpy(
                gchk.weights(cfg, DRAWN), "cpu"))
            state = tree_map(torch.clone, plan.shard_state(whole, specs))
            data = {k: torch.from_numpy(v) for k, v in batch.items()}
        with cost.CostCounter(device=dev) as counter:
            train(state, data)
        out[name] = counter.result()
    return out


def run_ranks(cases=CASES) -> dict:
    """Every case on this rank under the `dp` strategy, and on rank 0
    the counts; returns its blocks and records."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    cb.load_all()
    mesh = Mesh(MESH)
    out = {"coords": dict(mesh.coords), "rank": mesh.rank}
    for case in cases:
        out[case.name] = tchk._case(
            mesh, case, STRATEGY, ROWS.get(case.name, tchk.B),
            MICROBATCHES.get(case.name, 1), DRAWN)
    out["counts"] = counts(mesh)
    out[PREFILL.name] = prefill(mesh)
    return out
