"""The JAX package's side of the elastic re-meshing tests (not
collected), in two modes:

    XLA_FLAGS=--xla_force_host_platform_device_count=16 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/jax_elastic_reference.py \\
        shapes OUT

writes, as JSON, `repro.runtime.elastic.shrink_mesh`'s mesh shape (or its
error) for each (devices_available, model) of
`torch_elastic_checks.SHRINKS`;

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/jax_elastic_reference.py \\
        reshard OUT CKPT_DIR

restores the checkpoint the ranks wrote at step `SAVED` onto
`shrink_mesh(*SHRUNK)` through the reference's `reshard_state`, and
writes to an `.npz` each state leaf's shard on each device of the new
mesh (`restored{i}_{position}`, the devices in the mesh's row-major
order), then the metrics of `AFTER` steps of its `jit_train_step` on the
next batches and the state after them (whole), f32 products in full
precision."""
import json
import sys

import jax

jax.config.update("jax_default_matmul_precision", "float32")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_elastic_checks as chk  # noqa: E402
import torch_gspmd_checks as gchk  # noqa: E402
from repro.configs import base as cb  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.runtime import elastic  # noqa: E402
from repro.train import step  # noqa: E402


def shapes(dst: str) -> None:
    out = {}
    for avail, model in chk.SHRINKS:
        try:
            mesh = elastic.shrink_mesh(avail, model=model)
            out[f"{avail}/{model}"] = dict(mesh.shape)
        except Exception as e:  # noqa: BLE001 — the reference's own error
            out[f"{avail}/{model}"] = f"{type(e).__name__}: {e}"
    with open(dst, "w") as f:
        json.dump(out, f)


def reshard(dst: str, ckpt_dir: str) -> None:
    cb.load_all()
    cfg = gchk.config(cb, chk.CASE)
    opt = chk.opt_config(adamw)
    mesh = elastic.shrink_mesh(*chk.SHRUNK)
    state, plan = elastic.reshard_state(ckpt_dir, chk.SAVED, cfg, opt, mesh)
    out = {}
    devices = list(mesh.devices.flat)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state)):
        for shard in leaf.addressable_shards:
            pos = devices.index(shard.device)
            out[f"restored{i}_{pos}"] = np.asarray(shard.data)
    data = [{k: jnp.asarray(v) for k, v in b.items()}
            for b in chk.batches()[chk.SAVED:]]
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in data[0].items()}
    train, _, _ = step.jit_train_step(cfg, opt, plan, specs)
    with mesh:
        for k, batch in enumerate(data):
            state, metrics = train(state, batch)
            for key, v in metrics.items():
                out[f"step{k}_{key}"] = np.asarray(v)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state)):
        out[f"state{i}"] = np.asarray(leaf)
    np.savez(dst, **out)


if __name__ == "__main__":
    {"shapes": shapes, "reshard": reshard}[sys.argv[1]](*sys.argv[2:])
