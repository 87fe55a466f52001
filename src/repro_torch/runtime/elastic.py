"""Elastic re-meshing: continue training after permanent device loss.
PyTorch port of `repro.runtime.elastic`.

Strategy (the reference's): the `model` axis is kept (the layers' math
depends on it); a loss of capacity shrinks the `data` axis to the
largest power of two that the survivors hold, and the checkpoint is
re-sharded onto the new mesh through the host (`checkpoint.ckpt.restore`
keeps each rank's block).  The data pipeline is keyed by step, so
training resumes on the batches the lost configuration would have run.

Where the reference takes the first n devices of `jax.devices()`, the
new `launch.mesh.Mesh` spans the first n ranks of the job: a rank past
them is no member (`mesh.member` False), takes part in no collective
and makes none of the new mesh's groups.  Only members call
`reshard_state`.
"""
from __future__ import annotations

from repro_torch.checkpoint import ckpt
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.partition import ShardingPlan
from repro_torch.train import step as train_step

__all__ = ["shrunk_axes", "shrink_mesh", "reshard_state"]


def shrunk_axes(devices_available: int, model: int = 16,
                axis_names=("data", "model")) -> dict:
    """The axes of `shrink_mesh`'s mesh: {data axis: the largest power of
    two <= devices_available // model, model axis: model}.  Raises
    ValueError where fewer than `model` ranks survive."""
    if devices_available < model:
        raise ValueError(
            f"{devices_available} surviving ranks cannot hold the "
            f"{model}-wide model axis")
    data = devices_available // model
    # largest power of two <= data (keeps the global batch divisible)
    while data & (data - 1):
        data &= data - 1
    return dict(zip(axis_names, (data, model)))


def shrink_mesh(devices_available: int, model: int = 16,
                axis_names=("data", "model")) -> Mesh:
    """Largest (data, model) mesh that fits the surviving ranks, over the
    first data * model ranks of the job (`shrunk_axes`)."""
    return Mesh(shrunk_axes(devices_available, model, axis_names))


def reshard_state(directory: str, step: int, cfg, opt_cfg, new_mesh,
                  device="cuda"):
    """(this rank's blocks of the step-`step` checkpoint in `directory`
    laid out by the train plan on `new_mesh`, that plan): the state's
    blocks by `train.step.state_shardings`, on `device`."""
    plan = ShardingPlan(new_mesh, cfg, mode="train")
    shapes = train_step.abstract_state(cfg, opt_cfg)
    specs = train_step.state_shardings(cfg, plan, shapes)
    state = ckpt.restore(directory, step, shapes, device, plan, specs)
    return state, plan
