"""End-to-end training driver with the fault-tolerant runtime: PyTorch
port of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 50 --batch 8 --seq 128 --device cpu

On the card, the full config through the kernels (the smoke configs' head
dim 16 is not one the attention kernels take):

    python -m repro_torch.launch.train --arch granite-3-2b --steps 8 \\
        --batch 4 --seq 1024

Where the JAX package differs, and why:

* Fresh weights come from `models.convert.numpy_params(cfg, seed=0)` (the
  port cannot draw JAX's `PRNGKey(0)` tree); `run(init_params=...)` takes
  another numpy tree, e.g. the JAX package's, leaf dtypes kept, or a tree
  of tensors (e.g. `transformer.init_params` drawn on the card), which the
  run trains in place: it starts the run once, so a restart before the
  first checkpoint raises.
* An arch without embedding inputs trains on embeds drawn each step from
  `np.random.default_rng(step)` (standard normal, times 0.02 in the
  config's dtype), where the JAX package draws
  `jax.random.normal(PRNGKey(step))`: the same distribution, other
  numbers.
* The heartbeat file lies in the checkpoint directory, not in /tmp.

`run(..., mesh=...)` takes a `launch.mesh.Mesh` over the ranks of a
`torch.distributed` job (one process a rank; every rank calls `run`
alike), as the reference's takes a device mesh: the step is
`train.step.jit_train_step` under the train-mode `ShardingPlan`, each
rank keeps only its blocks of the state (the params by the plan, m, v
and master ZeRO-1 blocks: `state_shardings`), cut from the fresh weights
(or `init_params`, a whole tree on every rank: its blocks are copied),
and every rank takes the whole batch (its rows are cut inside the
step); `fsdp` sets the plan's FSDP (None: by the parameter count, as
the reference's plan).  Checkpoints are written whole by rank 0 and
restored as each rank's blocks (`checkpoint.ckpt`), so a supervised
restart works under the mesh; rank 0 alone logs and keeps the
heartbeat.

`run` reports, beside the JAX package's keys, each step's seconds (up to
a synchronisation), their median over the steps after the first two
(`step_s`), the tokens a second at that median, the peak memory the card
allocated (`torch.cuda.max_memory_allocated`) and the bytes of the
final state's params, m, v and master (`resident_bytes`: this rank's
blocks under a mesh, beside its `coords`).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as cb
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.runtime import fault
from repro_torch.sharding.partition import ShardingPlan
from repro_torch.train import step as train_step_mod
from repro_torch.tree_util import leaves, tree_map

__all__ = ["build", "batch_for", "run", "main"]


def build(cfg, opt_cfg, batch: int, seq: int, microbatches: int = 1,
          use_kernel=None, mesh=None, fsdp: bool | None = None):
    """(the train step, its plan (None without a mesh), the batch's
    {name: (shape, dtype)}, the state's specs (None without a mesh)).
    `fsdp` is the plan's (None: by the parameter count)."""
    specs = {"tokens": ((batch, seq), torch.int32)}
    if not cfg.embed_inputs:
        specs = {"embeds": ((batch, seq, cfg.d_model), cfg.torch_dtype),
                 "labels": ((batch, seq), torch.int32)}
    if cfg.pos == "mrope":
        specs["positions"] = ((batch, seq, 3), torch.int32)
    if mesh is None:
        return (train_step_mod.make_train_step(cfg, opt_cfg, microbatches,
                                               use_kernel), None, specs, None)
    plan = ShardingPlan(mesh, cfg, mode="train", fsdp=fsdp)
    step, _, state_specs = train_step_mod.jit_train_step(
        cfg, opt_cfg, plan, specs, microbatches, use_kernel)
    return step, plan, specs, state_specs


def batch_for(cfg, dcfg, step, specs, device="cuda") -> dict:
    """The step's batch on `device`: the pipeline's tokens (as labels
    beside seeded embeds for an arch without embedding inputs), M-RoPE's
    text positions where the arch takes them."""
    dev = resolve_device(device)
    tokens = torch.from_numpy(pipeline.global_batch_at(dcfg, step))
    out = {}
    if "tokens" in specs:
        out["tokens"] = tokens
    else:
        shape, dtype = specs["embeds"]
        draw = np.random.default_rng(step).standard_normal(
            shape, dtype=np.float32)
        out["embeds"] = torch.from_numpy(draw).to(dtype) * 0.02
        out["labels"] = tokens
    if "positions" in specs:
        b, t = tokens.shape
        out["positions"] = torch.arange(t, dtype=torch.int32)[
            None, :, None].expand(b, t, 3)
    return {k: v.to(dev) for k, v in out.items()}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def run(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
        seq: int = 128, ckpt_dir: str | None = None, ckpt_every: int = 20,
        mesh=None, fail_at: int | None = None, lr: float = 1e-3,
        log_every: int = 10, microbatches: int = 1, device="cuda",
        use_kernel=None, init_params=None, fsdp: bool | None = None) -> dict:
    cb.load_all()
    cfg = cb.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    dev = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup=max(steps // 10, 1),
                                total_steps=steps)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch)
    train_step, plan, specs, state_specs = build(
        cfg, opt_cfg, batch, seq, microbatches, use_kernel, mesh, fsdp)
    lead = plan is None or plan.mesh.rank == 0
    losses, times, last = [], [], {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    taken = False

    def fresh_state():
        nonlocal taken
        if init_params is None:
            tree = convert.numpy_params(cfg, seed=0)
            if plan is not None:
                tree = plan.shard_params(tree)
            params = convert.params_from_numpy(tree, dev, cfg.torch_dtype)
        elif isinstance(leaves(init_params)[0], torch.Tensor):
            if plan is not None:     # this rank's blocks, copied
                params = tree_map(lambda p: p.to(dev, copy=True),
                                  plan.shard_params(init_params))
            elif taken:
                raise RuntimeError(
                    "a tree of tensors passed as init_params was trained in "
                    "place and cannot start the run again: restarting "
                    "before the first checkpoint needs a numpy tree")
            else:
                taken = True
                params = tree_map(lambda p: p.to(dev), init_params)
        else:   # copied: on the CPU a tensor would share the array's memory
            tree = init_params if plan is None else plan.shard_params(
                init_params)
            params = convert.params_from_numpy(tree_map(np.array, tree), dev)
        return adamw.init_state(opt_cfg, params, plan, state_specs)

    def init_fn():
        if ckpt_dir:
            last_step = ckpt.latest_step(ckpt_dir)
            if last_step is not None:
                like = train_step_mod.abstract_state(cfg, opt_cfg)
                return ckpt.restore(ckpt_dir, last_step, like, dev, plan,
                                    state_specs), last_step
        return fresh_state(), 0

    def step_fn(state, step):
        t0 = time.perf_counter()
        b = batch_for(cfg, dcfg, step, specs, dev)
        state, metrics = train_step(state, b)
        loss = float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        last["state"] = state
        if lead and log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        return state, metrics

    def save_fn(state, step):
        if ckpt_dir:
            ckpt.save(ckpt_dir, step, state, plan, state_specs)

    failed = {"done": False}

    def fail_hook(step):
        if fail_at is not None and step == fail_at and not failed["done"]:
            failed["done"] = True
            raise fault.TrainingFailure(f"injected failure at step {step}")

    hb = (fault.Heartbeat(os.path.join(ckpt_dir, f"heartbeat_{arch}.json"))
          if ckpt_dir and lead else None)
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
    report = fault.run_supervised(
        init_fn=init_fn, step_fn=step_fn, save_fn=save_fn,
        restore_fn=lambda: init_fn(), num_steps=steps,
        ckpt_every=ckpt_every, heartbeat=hb,
        straggler=fault.StragglerMonitor(),
        fail_hook=fail_hook if fail_at is not None else None)
    step_s = statistics.median(times[2:] if len(times) > 2 else times) \
        if times else None
    final = last.get("state")
    report.update(
        losses=losses, step_times=times, step_s=step_s,
        tokens_per_s=batch * seq / step_s if step_s else None,
        peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        resident_bytes=None if final is None else {
            k: _bytes(getattr(final, k)) for k in ("params", "m", "v",
                                                   "master")},
        device=str(dev))
    if plan is not None:
        report.update(mesh=dict(plan.mesh.shape),
                      coords=dict(plan.mesh.coords))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    report = run(args.arch, smoke=args.smoke, steps=args.steps,
                 batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                 device=args.device)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("losses", "step_times")}, indent=1))


if __name__ == "__main__":
    main()
