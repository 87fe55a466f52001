"""The inputs and the rank body of the elastic re-meshing tests
(`test_torch_elastic.py`): one job of `RANKS` gloo ranks trains
granite-3-2b's smoke config on a (data 2, model 2) mesh for `SAVED`
steps and checkpoints it, then shrinks to `shrink_mesh(*SHRUNK)`, (data
1, model 2) over ranks 0-1: those restore the checkpoint through
`runtime.elastic.reshard_state` and train `AFTER` more steps on the next
batches, while ranks 2-3 (no members) idle to the job's end.  Every
`torch.distributed` call each rank makes after the shrink is counted.
The JAX side is `jax_elastic_reference.py`."""
import numpy as np
import torch
import torch.distributed as dist

import torch_gspmd_checks as gchk
from torch_gspmd_checks import Case

RANKS = 4
MESH = {"data": 2, "model": 2}
B, T = 4, 16
SAVED, AFTER = 2, 2
SHRUNK = (3, 2)             # (devices_available, model)
CASE = Case("granite-3-2b", "granite-3-2b", False)
# (devices_available, model) whose shrunk shape is held to the
# reference's; the last leaves fewer ranks than the model axis needs
SHRINKS = ((16, 4), (15, 4), (7, 2), (3, 2), (1, 1), (1, 2))
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
# the calls that make a group or move data
CALLS = ("all_reduce", "all_gather", "reduce_scatter", "barrier",
         "broadcast", "new_group")


def opt_config(adamw):
    return adamw.AdamWConfig(**OPT)


def batches(seed: int = 5) -> list:
    """SAVED + AFTER batches of tokens (B, T) int32."""
    from repro_torch.configs import base as cb
    cb.load_all()
    cfg = gchk.config(cb, CASE)
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
            for _ in range(SAVED + AFTER)]


class Spy:
    """Counts each `torch.distributed` call of CALLS made inside it."""

    def __init__(self):
        self.calls = dict.fromkeys(CALLS, 0)
        self._real = {}

    def __enter__(self):
        for name in CALLS:
            real = self._real[name] = getattr(dist, name)

            def spy(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            setattr(dist, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(dist, name, real)


def run_ranks(ckpt_dir: str) -> dict:
    """Train on the (2, 2) mesh, checkpoint, shrink, restore on the
    members and train on; returns this rank's records."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import base as cb
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    from repro_torch.sharding import ShardingPlan
    from repro_torch.sharding.partition import state_spec_leaves
    from repro_torch.train import step
    from repro_torch.tree_util import leaves, tree_map
    torch.set_num_threads(1)
    cb.load_all()
    cfg = gchk.config(cb, CASE)
    opt = opt_config(adamw)
    data = batches()
    specs_in = {k: (v.shape, v.dtype) for k, v in data[0].items()}
    mesh = Mesh(MESH)
    plan = ShardingPlan(mesh, cfg, mode="train")
    train, _, specs = step.jit_train_step(cfg, opt, plan, specs_in)
    whole = adamw.init_state(opt, convert.params_from_numpy(
        gchk.weights(cfg), "cpu"))
    state = tree_map(torch.clone, plan.shard_state(whole, specs))
    before = []
    for b in data[:SAVED]:
        state, m = train(state, b)
        before.append(float(m["loss"]))
    ckpt.save(ckpt_dir, SAVED, state, plan, specs)
    saved = [plan.relayout(x, s, ()).clone() for x, s in zip(
        leaves(state), state_spec_leaves(specs))]
    out = {"rank": mesh.rank, "before": before, "saved": saved}
    with Spy() as spy:
        new = elastic.shrink_mesh(*SHRUNK)
        out.update(member=new.member, shape=dict(new.shape),
                   coords=new.coords)
        if new.member:
            state, nplan = elastic.reshard_state(ckpt_dir, SAVED, cfg, opt,
                                                 new, "cpu")
            out["restored"] = [t.clone() for t in leaves(state)]
            train, _, nspecs = step.jit_train_step(cfg, opt, nplan,
                                                   specs_in)
            out["specs"] = state_spec_leaves(nspecs)
            out["metrics"] = []
            for b in data[SAVED:]:
                state, m = train(state, b)
                out["metrics"].append({k: float(v) for k, v in m.items()})
            out["state"] = leaves(state)
        else:
            try:
                new.all_reduce(torch.ones(2), "model")
                out["refused"] = False
            except ValueError:
                out["refused"] = True
    out["calls"] = spy.calls
    return out
