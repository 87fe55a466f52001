"""Train-step builder: PyTorch port of `repro.train.step`.

`make_train_step` returns `step(state, batch) -> (state, metrics)`: the
loss and its gradients through `transformer.loss_fn` (the kernels on CUDA
tensors, with their plain versions' gradients), then one AdamW update in
place (`optim.adamw.apply_updates`).  `abstract_state` builds the state
on the meta device, where the JAX package traces it with
`jax.eval_shape`.

Under a `ShardingPlan` (one process a rank of a `torch.distributed`
job) the reference jits the step with the plan's shardings and lets
GSPMD place every tensor; here every rank runs the step on its blocks:

* the state is a rank's blocks by `state_shardings`: the params by the
  plan's `param_specs`, m, v and master by the plan with FSDP forced on
  (ZeRO-1: over the data axes even where the params are not);
* a step takes the whole batch (cut to the rank's rows inside, by
  `input_shardings`), takes each leaf's gradient term by one backward,
  sums it over the axes its spec leaves replicated into its ZeRO-1 block
  (`ShardingPlan.grad_block`, leaf by leaf in tree order: the
  invariant of `sharding.partition`) and updates the blocks;
* the metrics are replicated (`metric_shardings`): the loss the global
  mean, the grad norm over the whole leaves.

Microbatches split the whole batch first, then each microbatch's rows go
over the data axes (over every axis under the "dp" strategy), or stay on
every rank where they do not divide (each token's loss term then counts
on one rank), as the reference's `act` drops an axis that does not
divide.

PyTorch runs eagerly and has no jit: `jit_train_step` builds nothing
ahead; it returns the per-rank step, the abstract state and its specs,
the tuple the reference returns, and the step checks each input's shape
against `batch_specs`.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.serve.step import _checked
from repro_torch.sharding.partition import state_spec_leaves
from repro_torch.tree_util import leaves, unflatten

__all__ = ["make_train_step", "abstract_state", "state_shardings",
           "metric_shardings", "jit_train_step"]


def _grads(cfg, plan=None, microbatches: int = 1, use_kernel=None,
           specs=None):
    """`grads(params, batch) -> (loss, gradient leaves in tree order)`: the
    mean loss and gradients over `microbatches` parts of the batch (split
    on its first axis, each part's gradients added in the param dtype,
    then divided by the count).  Under `plan` (`specs` the state's
    `TrainState` of specs) `params` are this rank's blocks, the batch is
    whole (each part's rows go over the data axes) and each gradient
    comes back summed over the ranks, as this rank's ZeRO-1 block."""

    def one(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, _aux = transformer.loss_fn(cfg, params, batch, shd=plan,
                                         use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def grads_of(params, batch):
        batch = transformer._on_device(params, batch)
        if microbatches > 1:
            split = {k: v.reshape((microbatches, -1) + v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=split[next(iter(split))].device)
            grads = [torch.zeros_like(p) for p in leaves(params)]
            for i in range(microbatches):
                mb_loss, g = one(params, {k: v[i] for k, v in split.items()})
                for acc, gi in zip(grads, g, strict=True):
                    acc.add_(gi.to(acc.dtype))
                loss = loss + mb_loss
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        else:
            loss, grads = one(params, batch)
        if plan is not None:
            with torch.no_grad():
                grads = [plan.grad_block(g, ps, zs) for g, ps, zs in zip(
                    grads, state_spec_leaves(specs.params),
                    state_spec_leaves(specs.m), strict=True)]
        return loss, grads

    return grads_of


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1,
                    use_kernel=None, plan=None):
    """microbatches > 1 = gradient accumulation: the batch is split on
    its first axis, each part's gradients are added in the param dtype,
    and the sums (and the loss) are divided by the count.  Under `plan`
    the step runs on this rank's blocks of the state
    (`state_shardings`; see the module docstring)."""
    specs = None if plan is None else state_shardings(
        cfg, plan, abstract_state(cfg, opt_cfg))
    grads_of = _grads(cfg, plan, microbatches, use_kernel, specs)

    def train_step(state: adamw.TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        new_state, metrics = adamw.apply_updates(
            opt_cfg, state, unflatten(state.params, grads), plan, specs)
        return new_state, dict(metrics, loss=loss)

    return train_step


def abstract_state(cfg, opt_cfg: adamw.AdamWConfig) -> adamw.TrainState:
    """The full train state as meta tensors: every leaf's shape and
    dtype, nothing allocated."""
    params = transformer.init_params(cfg, torch.Generator(), device="meta")
    return adamw.init_state(opt_cfg, params)


def state_shardings(cfg, plan, state_shapes) -> adamw.TrainState:
    """A `TrainState` of specs: the params by the plan, m, v and master
    by the plan with FSDP forced on (ZeRO-1), the step replicated.
    `state_shapes` is the whole state (`abstract_state`)."""
    zero1 = plan.zero1()
    return adamw.TrainState(
        step=(), params=plan.param_shardings(state_shapes.params),
        m=zero1.param_shardings(state_shapes.m),
        v=zero1.param_shardings(state_shapes.v),
        master=(zero1.param_shardings(state_shapes.master)
                if state_shapes.master is not None else None))


def metric_shardings(plan) -> dict:
    """Every metric replicated."""
    return {"grad_norm": (), "lr": (), "loss": ()}


def jit_train_step(cfg, opt_cfg, plan, batch_specs: dict,
                   microbatches: int = 1, use_kernel=None):
    """(the per-rank train step for batches of `batch_specs`, the
    abstract state, its `state_shardings`)."""
    state_shapes = abstract_state(cfg, opt_cfg)
    step = _checked(make_train_step(cfg, opt_cfg, microbatches, use_kernel,
                                    plan), batch_specs, 1)
    return step, state_shapes, state_shardings(cfg, plan, state_shapes)
