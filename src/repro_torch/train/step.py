"""Train-step builder: PyTorch port of `repro.train.step`.

`make_train_step` returns `step(state, batch) -> (state, metrics)`: the
loss and its gradients through `transformer.loss_fn` (the kernels on CUDA
tensors, with their plain versions' gradients), then one AdamW update in
place (`optim.adamw.apply_updates`).  One card holds the whole state, so
the JAX package's sharding plumbing (`state_shardings`,
`metric_shardings`, `jit_train_step`) has no counterpart here, and
`abstract_state` builds the state on the meta device, where the JAX
package traces it with `jax.eval_shape`.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.tree_util import leaves, unflatten

__all__ = ["make_train_step", "abstract_state"]


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1,
                    use_kernel=None):
    """microbatches > 1 = gradient accumulation: the batch is split on
    its first axis, each part's gradients are added in the param dtype,
    and the sums (and the loss) are divided by the count."""

    def grad_of(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, _aux = transformer.loss_fn(cfg, params, batch,
                                         use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(state: adamw.TrainState, batch):
        batch = transformer._on_device(state.params, batch)
        if microbatches > 1:
            split = {k: v.reshape((microbatches, -1) + v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=split[next(iter(split))].device)
            grads = [torch.zeros_like(p) for p in leaves(state.params)]
            for i in range(microbatches):
                mb_loss, g = grad_of(state.params,
                                     {k: v[i] for k, v in split.items()})
                for acc, gi in zip(grads, g, strict=True):
                    acc.add_(gi.to(acc.dtype))
                loss = loss + mb_loss
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        else:
            loss, grads = grad_of(state.params, batch)
        new_state, metrics = adamw.apply_updates(
            opt_cfg, state, unflatten(state.params, grads))
        return new_state, dict(metrics, loss=loss)

    return train_step


def abstract_state(cfg, opt_cfg: adamw.AdamWConfig) -> adamw.TrainState:
    """The full train state as meta tensors: every leaf's shape and
    dtype, nothing allocated."""
    params = transformer.init_params(cfg, torch.Generator(), device="meta")
    return adamw.init_state(opt_cfg, params)
