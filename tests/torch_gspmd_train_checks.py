"""The inputs and the rank bodies of the GSPMD training tests
(`test_torch_gspmd_train.py`): one job of `RANKS` gloo ranks
(`repro_torch.launch.mesh.spawn(run_ranks, (cases,))`) trains each
case's smoke config under the port's plan on a (data 2, model 2) mesh,
each rank returning its blocks: the loss and every gradient leaf of
`loss_fn(shd=plan)` at the first step (as its ZeRO-1 block), the metrics
of `TRAIN_STEPS` `jit_train_step` calls and the state after them.  The
JAX side (`jax_gspmd_train_reference.py`) runs the reference's
`jit_train_step` on the same cases; `RANKS` ranks also check each
`Mesh` collective's backward (`adjoints`), `apply_updates` on ZeRO-1
blocks against one rank's (`optimizer`) and `launch.train.run` under a
mesh with an injected failure (`launcher`), each in the same job."""
import dataclasses
import json
import os

import numpy as np
import torch

import torch_gspmd_checks as gchk
from torch_gspmd_checks import Case

RANKS = 4
MESH = {"data": 2, "model": 2}
B, T = 4, 16
TRAIN_STEPS = 3
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
# head-TP under FSDP with remat "full"; sequence-parallel with remat
# "dots" (the collectives under selective checkpointing) and a chunked
# loss (global chunks over each rank's rows); sequence-parallel with
# experts and the dense residual under FSDP (the factored second
# moment); RG-LRU and local attention under FSDP; RWKV6 without FSDP
# (ZeRO-1 alone cuts m, v over data); granite in two microbatches
CASES = (Case("granite-3-2b", "granite-3-2b", True,
              (("remat", "full"),), T),
         Case("qwen1.5-4b", "qwen1.5-4b", False,
              (("loss_chunk", 4), ("remat", "dots")), T),
         Case("arctic-480b", "arctic-480b", True, (), T),
         Case("recurrentgemma-9b", "recurrentgemma-9b", True, (), T),
         Case("rwkv6-7b", "rwkv6-7b", False, (), T),
         Case("granite-3-2b-mb2", "granite-3-2b", True, (), T))
MICROBATCHES = {"granite-3-2b-mb2": 2}
FACTORED = {"arctic-480b"}


def opt_config(adamw, case: Case):
    """The case's AdamW config from module `adamw` (either package's)."""
    return adamw.AdamWConfig(**OPT, factored_v=case.name in FACTORED)


def batches(case: Case, seed: int = 3, rows: int = B) -> list:
    """The TRAIN_STEPS batches of the case: tokens (rows, T) int32."""
    from repro_torch.configs import base as cb
    cb.load_all()
    cfg = gchk.config(cb, case)
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (rows, case.t0)).astype(
        np.int32)} for _ in range(TRAIN_STEPS)]


def _case(mesh, case: Case, strategy=None, rows: int = B,
          microbatches: int | None = None, drawn: str | None = None
          ) -> dict:
    from repro_torch.configs import base as cb
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.sharding import ShardingPlan
    from repro_torch.train import step
    from repro_torch.tree_util import leaves, tree_map
    cfg = gchk.config(cb, case)
    plan = ShardingPlan(mesh, cfg, mode="train", fsdp=case.fsdp,
                        strategy_override=strategy)
    opt = opt_config(adamw, case)
    data = batches(case, rows=rows)
    specs_in = {k: (v.shape, v.dtype) for k, v in data[0].items()}
    if microbatches is None:
        microbatches = MICROBATCHES.get(case.name, 1)
    train, shapes, specs = step.jit_train_step(
        cfg, opt, plan, specs_in, microbatches)
    whole = adamw.init_state(opt, convert.params_from_numpy(
        gchk.weights(cfg, drawn), "cpu"))
    state = tree_map(torch.clone, plan.shard_state(whole, specs))
    del whole
    loss, grads = step._grads(cfg, plan, specs=specs)(state.params, data[0])
    metrics = []
    for batch in data:
        state, m = train(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss": float(loss), "grads": [g.detach() for g in grads],
            "metrics": metrics, "state": leaves(state),
            "shapes": [tuple(t.shape) for t in leaves(state)]}


def adjoints(mesh) -> dict:
    """<f(x), g> and <x, f^T(g)> on this rank for every collective f over
    every axis set of the mesh (x, g drawn per rank; f^T by autograd):
    the sums over the ranks of the two must agree."""
    from repro_torch.launch.mesh import world
    rank = world()[1]
    out = {}
    for axes in (("data",), ("model",), ("data", "model")):
        for kind in ("all_reduce", "all_gather", "reduce_scatter"):
            gen = torch.Generator().manual_seed(100 * rank + len(out))
            x = torch.randn((4, 6), generator=gen, dtype=torch.float64,
                            requires_grad=True)
            if kind == "all_reduce":
                y = mesh.all_reduce(x, axes)
            else:
                y = getattr(mesh, kind)(x, axes, dim=0)
            g = torch.randn(y.shape, generator=gen, dtype=torch.float64)
            (xt,) = torch.autograd.grad(y, x, g)
            out[f"{kind}/{'+'.join(axes)}"] = (float((y.detach() * g).sum()),
                                               float((x * xt).sum()))
    try:
        mesh.all_reduce(torch.ones(2, requires_grad=True), "model", "max")
        out["max_raises"] = False
    except ValueError:
        out["max_raises"] = True
    return out


def optimizer(mesh) -> dict:
    """`apply_updates` on this rank's ZeRO-1 blocks against one rank's on
    the whole state, the same gradients: granite's smoke tree in bf16
    (an f32 master) and arctic's in f32 with the factored second moment,
    2 steps each; each leaf's largest gap and the grad norms."""
    from repro_torch.configs import base as cb
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.sharding import ShardingPlan
    from repro_torch.sharding.partition import state_spec_leaves
    from repro_torch.train import step
    from repro_torch.tree_util import leaves, tree_map, unflatten
    out = {}
    for arch, dtype, factored in (("granite-3-2b", "bfloat16", False),
                                  ("arctic-480b", "float32", True)):
        cfg = dataclasses.replace(cb.get_config(arch).smoke(), dtype=dtype)
        plan = ShardingPlan(mesh, cfg, mode="train", fsdp=False)
        opt = adamw.AdamWConfig(**OPT, factored_v=factored)
        specs = step.state_shardings(cfg, plan, step.abstract_state(cfg,
                                                                    opt))
        whole = adamw.init_state(opt, convert.params_from_numpy(
            gchk.weights(cfg), "cpu", cfg.torch_dtype))
        mine = tree_map(torch.clone, plan.shard_state(whole, specs))
        gen = torch.Generator().manual_seed(7)
        gaps, norms = [], []
        for _ in range(2):
            g = [torch.randn(p.shape, generator=gen).to(p.dtype)
                 for p in leaves(whole.params)]
            blocks = [plan.local_shard(x, s) for x, s in zip(
                g, state_spec_leaves(specs.m))]
            whole, wm = adamw.apply_updates(opt, whole,
                                            unflatten(whole.params, g))
            mine, mm = adamw.apply_updates(
                opt, mine, unflatten(mine.params, blocks), plan, specs)
            norms.append((float(wm["grad_norm"]), float(mm["grad_norm"])))
        want = plan.shard_state(whole, specs)
        gaps = [float((a.double() - b.double()).abs().max())
                for a, b in zip(leaves(mine), leaves(want))]
        out[arch] = {"gaps": gaps, "norms": norms,
                     "master": mine.master is not None}
    return out


def launcher(mesh, ckpt_dir: str) -> dict:
    """granite's smoke config trained by `launch.train.run(mesh=...)` for
    6 steps, checkpointing every 2, with a failure injected at step 3 (a
    restart from step 2's checkpoint), and without; each run's losses,
    restarts and per-rank report."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.sharding.partition import state_spec_leaves
    from repro_torch.tree_util import leaves
    common = dict(smoke=True, steps=6, batch=B, seq=T, mesh=mesh,
                  device="cpu", log_every=0, ckpt_every=2)
    clean = train.run("granite-3-2b", **common)
    save, gathered = ckpt.save, []

    def spy(directory, step, tree, plan=None, specs=None):
        # the state each save is given, put together by its specs
        gathered[:] = [plan.relayout(x, s, ()).clone() for x, s in zip(
            leaves(tree), state_spec_leaves(specs))]
        return save(directory, step, tree, plan, specs)

    ckpt.save = spy
    try:
        failed = train.run("granite-3-2b", ckpt_dir=ckpt_dir, fail_at=3,
                           **common)
    finally:
        ckpt.save = save
    keys = ("losses", "restarts", "final_step", "resident_bytes")
    return {"clean": {k: clean[k] for k in keys},
            "failed": {k: failed[k] for k in keys}, "gathered": gathered}


def run_ranks(cases=CASES, ckpt_dir=None) -> dict:
    """Every case on this rank, then the collectives' adjoints, the
    optimizer on blocks and the launcher; returns its blocks and
    records."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    cb.load_all()
    mesh = Mesh(MESH)
    out = {"coords": dict(mesh.coords), "rank": mesh.rank,
           "adjoints": adjoints(mesh), "optimizer": optimizer(mesh)}
    for case in cases:
        out[case.name] = _case(mesh, case)
    if ckpt_dir is not None:
        out["launcher"] = launcher(mesh, ckpt_dir)
    return out


def to_json(cases) -> str:
    return json.dumps([list(c) for c in cases])


def leaf_names(tree) -> list:
    """The '/'-joined paths of a tree's leaves in jax's flatten order."""
    from repro_torch.tree_util import leaves_with_paths
    return ["/".join(map(str, p)) for p, _ in leaves_with_paths(tree)]


def ckpt_path(tmp) -> str:
    return os.path.join(str(tmp), "ckpt")
