"""AdamW with dtype-configurable state: PyTorch port of
`repro.optim.adamw`.

Functional code over the parameter tree, not `torch.optim`, so that the
arithmetic is the JAX package's op for op: the cosine schedule with
warmup, global-norm clipping, bias-corrected moments in f32, decoupled
weight decay on the leaves `_decay_mask` selects (by the same key paths:
norms, biases, RWKV's mixes and decay), m and v in `state_dtype`, the
factored (Adafactor-style row/column) second moment for >= 2-D leaves,
and an f32 master copy when any parameter is bf16.

`apply_updates` updates the state's tensors in place, leaf by leaf, where
the JAX train step donates the state to its jitted call
(`donate_argnums=(0,)`): the state passed in is consumed.  A leaf's f32
temporaries are freed before the next leaf's are made, so the update
needs a few times the largest leaf beside the state (granite-3-2b's
stacked MLP leaf is 40 x 2,048 x 8,192 elements, 2.7 GB in f32).

Under a `ShardingPlan` (one process a rank) the state is a rank's
blocks: the params by the plan's specs, m, v and master by its ZeRO-1
specs (`train.step.state_shardings`), and so are the gradients, each
already summed over the ranks (`ShardingPlan.grad_block`).  Each leaf's
update runs on its ZeRO-1 block (the params' block sliced to it where
there is no master), and the new parameter block is all-gathered over
the data axes back into the parameter's spec.  `global_norm` counts each
element once: a leaf's sum of squares on the ranks of index 0 along the
axes it is replicated over, then summed over the whole mesh.  The
factored second moment takes its row and column means over the whole
leaf (sums over the axes that split the averaged dimension).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.launch.mesh import flat_axes
from repro_torch.tree_util import (keystr, leaves, leaves_with_paths,
                                   tree_map, unflatten)

__all__ = ["AdamWConfig", "TrainState", "init_state", "global_norm",
           "apply_updates"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# substrings of a leaf's key path that exempt it from weight decay
_NO_DECAY = ("ln1", "ln2", "final_norm", "mu", "w0", "lam", "b_r", "b_i",
             "ln_o")


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"    # "bfloat16" for >=100B models
    master_fp32: bool = True        # keep fp32 master when params are bf16
    factored_v: bool = False        # Adafactor-style row/col second moment
                                    # for >=2D leaves (>=300B models): cuts
                                    # v from O(params) to O(rows+cols)
    warmup: int = 100
    schedule: str = "cosine"        # cosine | constant
    total_steps: int = 10_000


class TrainState(NamedTuple):
    step: torch.Tensor   # () int32
    params: Any
    m: Any
    v: Any
    master: Any          # fp32 master copy or None


def _lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    if cfg.schedule == "cosine":
        frac = torch.clamp((step - cfg.warmup) /
                           max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
        base = 0.5 * (1 + torch.cos(math.pi * frac))
    else:
        base = 1.0
    return cfg.lr * warm * base


def _v_init(cfg: AdamWConfig, p: torch.Tensor):
    if cfg.factored_v and p.dim() >= 2:
        return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                 device=p.device),
                "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                 dtype=torch.float32, device=p.device)}
    return torch.zeros(p.shape, dtype=_DTYPES[cfg.state_dtype],
                       device=p.device)


def init_state(cfg: AdamWConfig, params, plan=None, specs=None
               ) -> TrainState:
    """The initial state of `params`.  Under `plan` `params` are this
    rank's blocks by `specs` (the state's `TrainState` of specs) and so is
    the state: m, v and master their ZeRO-1 blocks."""
    if plan is not None:
        return _init_blocks(cfg, params, plan, specs)
    sd = _DTYPES[cfg.state_dtype]
    flat = leaves(params)
    needs_master = cfg.master_fp32 and any(
        p.dtype == torch.bfloat16 for p in flat)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if needs_master else None)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=flat[0].device),
        params=params,
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=sd,
                                         device=p.device), params),
        v=tree_map(lambda p: _v_init(cfg, p), params),
        master=master,
    )


def _init_blocks(cfg, params, plan, specs) -> TrainState:
    """`init_state` on this rank's blocks: the whole state's shapes on the
    meta device, each of m and v allocated as its block, master the f32
    copy of the params' ZeRO-1 blocks."""
    from repro_torch.sharding.partition import state_spec_leaves, zip_map
    flat = leaves(params)
    ps, zs = state_spec_leaves(specs.params), state_spec_leaves(specs.m)
    whole = init_state(cfg, unflatten(params, [
        torch.empty(plan.global_shape(p.shape, s), dtype=p.dtype,
                    device="meta") for p, s in zip(flat, ps, strict=True)]))
    dev = flat[0].device

    def zeros(leaf, spec):
        return torch.zeros(plan.local_shape(leaf.shape, spec),
                           dtype=leaf.dtype, device=dev)

    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
        m=zip_map(zeros, whole.m, specs.m), v=zip_map(zeros, whole.v, specs.v),
        master=None if whole.master is None else unflatten(params, [
            plan.relayout(p.detach(), a, b).to(torch.float32, copy=True)
            for p, a, b in zip(flat, ps, zs, strict=True)]))


def _decay_mask(params):
    """A tree of bools like `params`: does the leaf take weight decay?"""
    return unflatten(params, [
        leaf.dim() >= 2 and not any(t in keystr(path) for t in _NO_DECAY)
        for path, leaf in leaves_with_paths(params)])


def global_norm(tree, plan=None, specs=None) -> torch.Tensor:
    """The L2 norm over every leaf; under `plan` of the whole leaves of
    which `tree` holds this rank's blocks by `specs` (a tree of specs
    like it)."""
    if plan is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in leaves(tree)))
    from repro_torch.sharding.partition import state_spec_leaves
    total = sum(torch.sum(torch.square(leaf.float())) * float(all(
        plan.mesh.axis_index(a) == 0 for a in plan.replicated_axes(spec)))
        for leaf, spec in zip(leaves(tree), state_spec_leaves(specs),
                              strict=True))
    return torch.sqrt(plan.mesh.all_reduce(total, plan.mesh.axis_names))


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


class _Whole:
    """The factored moment's means over a dimension of the whole leaf.
    On one card (`plan` None) the leaf's own; under a plan the leaf is a
    rank's block under spec `zs`, its v's `r` and `c` under `zr` and
    `zc`, and a mean sums over the axes that split its dimension."""

    def __init__(self, plan=None, zs=(), zr=(), zc=(), shape=()):
        self.plan, self.zs, self.zr, self.zc = plan, zs, zr, zc
        self.n = shape      # the leaf's global shape

    def _sum(self, x, have, want, axes):
        """x, a term under spec `have` of a sum over `axes`, summed and
        laid out by `want`."""
        return self.plan.relayout(x, have, want, flat_axes(axes) or None)

    def row_mean(self, g2):
        """mean(-1), laid out as `r`."""
        if self.plan is None:
            return g2.mean(dim=-1)
        return self._sum(g2.sum(dim=-1), self.zs[:-1], self.zr,
                         self.zs[-1]) / self.n[-1]

    def col_mean(self, g2):
        """mean(-2), laid out as `c`."""
        if self.plan is None:
            return g2.mean(dim=-2)
        s = self._sum(g2.sum(dim=-2), self.zs[:-2] + self.zs[-1:], self.zc,
                      self.zs[-2])
        return s / self.n[-2]

    def denom(self, rhat):
        """rhat.mean(-1, keepdim=True) over r's whole last dimension,
        laid out as the leaf's leading dimensions."""
        if self.plan is None:
            return rhat.mean(dim=-1, keepdim=True)
        return (self._sum(rhat.sum(dim=-1), self.zr[:-1], self.zs[:-2],
                          self.zr[-1]) / self.n[-2])[..., None]

    def row_as_leaf(self, rhat):
        """`r` laid out as the leaf's rows."""
        if self.plan is None:
            return rhat
        return self.plan.relayout(rhat, self.zr, self.zs[:-1])

    def col_as_leaf(self, chat):
        """`c` laid out as the leaf's columns."""
        if self.plan is None:
            return chat
        return self.plan.relayout(chat, self.zc, self.zs[:-2] + self.zs[-1:])


def _update(cfg, g, m, v, p_ref, decay, scale, lr, b1c, b2c,
            whole=_Whole()):
    """One leaf's step, in place on m, v and (when it is f32) p_ref, in
    the JAX package's order of operations; returns the new f32 value of
    the parameter.  `whole` (a `_Whole`) takes the factored moment's
    means over the whole leaf."""
    g32 = g.to(torch.float32, copy=True).mul_(scale)
    m32 = m.float()                      # m itself when it is f32
    m32.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    if isinstance(v, dict):              # factored second moment
        g2 = (g32 * g32).add_(1e-30)
        r = (v["r"] * cfg.b2).add_(whole.row_mean(g2) * (1 - cfg.b2))
        c = (v["c"] * cfg.b2).add_(whole.col_mean(g2) * (1 - cfg.b2))
        del g2
        rhat, chat = r / b2c, c / b2c
        denom = whole.denom(rhat)
        vhat = (whole.row_as_leaf(rhat)[..., None]
                * whole.col_as_leaf(chat)[..., None, :]
                ).div_(torch.clamp(denom[..., None], min=1e-30))
        v["r"].copy_(r)
        v["c"].copy_(c)
    else:
        v32 = v.float()
        v32.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
        vhat = v32 / b2c
        if v32 is not v:
            v.copy_(v32)
        del v32
    del g32
    delta = (m32 / b1c).div_(vhat.sqrt_().add_(cfg.eps))
    del vhat
    if m32 is not m:
        m.copy_(m32)
    del m32
    p32 = p_ref.float()                  # p_ref itself when it is f32
    if decay:
        delta.add_(p32 * cfg.weight_decay)
    p32.sub_(delta.mul_(lr))
    return p32


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, state: TrainState, grads, plan=None,
                  specs=None) -> tuple[TrainState, dict]:
    """One AdamW step from `grads` (a tree like the params), in place on
    the state's tensors (see the module docstring).  Returns the new
    state and {"grad_norm", "lr"} as tensors.  Under `plan` the state and
    the gradients are this rank's blocks by `specs` (the state's
    `TrainState` of specs; the gradients laid out as m)."""
    step = state.step + 1
    flat_g = leaves(grads)
    gnorm = global_norm(flat_g) if plan is None else global_norm(
        grads, plan, specs.m)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = _lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    ref = state.master if state.master is not None else state.params
    mask = leaves(_decay_mask(ref))
    params = leaves(state.params)
    for (path, p_ref), g, p, decay in zip(leaves_with_paths(ref), flat_g,
                                          params, mask, strict=True):
        whole = _Whole()
        if plan is not None:
            ps, zs = _at(specs.params, path), _at(specs.m, path)
            zv = _at(specs.v, path)
            if isinstance(zv, dict):
                whole = _Whole(plan, zs, zv["r"], zv["c"],
                               plan.global_shape(p.shape, ps))
            if state.master is None:     # the params' block, sliced
                p_ref = plan.relayout(p_ref, ps, zs)
        p32 = _update(cfg, g, _at(state.m, path), _at(state.v, path), p_ref,
                      decay, scale, lr, b1c, b2c, whole)
        if plan is not None:             # back to the params' spec
            p32 = plan.relayout(p32.to(p.dtype), zs, ps)
        if p32 is not p:
            p.copy_(p32)
    return state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
