"""The JAX package's side of the GSPMD training tests (not collected): run
on `RANKS` forced host devices, it trains every case it is given (a JSON
list of `torch_gspmd_checks.Case`s; the smoke configs, the weights of
`torch_gspmd_checks.weights`, the batches of
`torch_gspmd_train_checks.batches`) through the reference's
`repro.train.step.jit_train_step` under its plan on a (data 2, model 2)
mesh, f32 products in full precision, and writes to an `.npz`:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/jax_gspmd_train_reference.py \\
        OUT CASES [OPTIONS]

per case the loss and every gradient leaf of `loss_fn(shd=plan)` at the
initial weights on the first batch (`jax.value_and_grad`, whole leaves),
then the metrics of `TRAIN_STEPS` steps and every leaf of the state after
them (whole, in jax's flatten order); and the same gradients and steps
without a plan (`*_one*` keys): how far the reference's own sums in
another order move them.  OPTIONS, a JSON object, may set the plans'
`strategy_override` ("strategy"), each case's batch rows ("rows")
and microbatches ("microbatches"), by case name, and the leaves
`torch_gspmd_checks.weights` draws ("drawn")."""
import json
import sys

import jax

jax.config.update("jax_default_matmul_precision", "float32")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_gspmd_checks as gchk  # noqa: E402
import torch_gspmd_train_checks as chk  # noqa: E402
from repro.configs import base as cb  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.sharding.partition import ShardingPlan  # noqa: E402
from repro.train import step  # noqa: E402


def main(dst: str, cases: str, options: str = "{}") -> None:
    opts = json.loads(options)
    rows = opts.get("rows", {})
    micro = dict(chk.MICROBATCHES, **opts.get("microbatches", {}))
    drawn = opts.get("drawn")
    assert jax.device_count() == chk.RANKS, jax.devices()
    cb.load_all()
    # Auto axes: the reference's plans constrain layouts for GSPMD
    mesh = jax.make_mesh(
        tuple(chk.MESH.values()), tuple(chk.MESH),
        axis_types=(jax.sharding.AxisType.Auto,) * len(chk.MESH))
    out = {}
    for case in gchk.from_json(cases):
        name, cfg = case.name, gchk.config(cb, case)
        plan = ShardingPlan(mesh, cfg, mode="train", fsdp=case.fsdp,
                            strategy_override=opts.get("strategy"))
        opt = chk.opt_config(adamw, case)
        data = [{k: jnp.asarray(v) for k, v in b.items()}
                for b in chk.batches(case, rows=rows.get(name, chk.B))]
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in data[0].items()}
        train, shapes, st_sh = step.jit_train_step(
            cfg, opt, plan, specs, micro.get(name, 1))
        params = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, gchk.weights(cfg, drawn)),
            st_sh.params)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(cfg, p, data[0], shd=plan)[0]))(params)
        out[f"{name}_loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
            out[f"{name}_grad{i}"] = np.asarray(g)
        one = jax.jit(jax.grad(
            lambda p: jt.loss_fn(cfg, p, data[0])[0]))(params)
        for i, g in enumerate(jax.tree_util.tree_leaves(one)):
            out[f"{name}_grad_one{i}"] = np.asarray(g)
        # the steps under the plan, then on one device (the reference's own
        # spread, as for the gradients)
        one_step = jax.jit(step.make_train_step(
            cfg, opt, None, micro.get(name, 1)))
        for tag, fn, sh in (("", train, st_sh), ("_one", one_step, None)):
            # fresh weights: the jitted step donates its state
            state = adamw.init_state(opt, jax.tree_util.tree_map(
                jnp.asarray, gchk.weights(cfg, drawn)))
            if sh is not None:
                state = jax.device_put(state, sh)
            for k, batch in enumerate(data):
                state, metrics = fn(state, batch)
                for key, v in metrics.items():
                    out[f"{name}{tag}_step{k}_{key}"] = np.asarray(v)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(state)):
                out[f"{name}{tag}_state{i}"] = np.asarray(leaf)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
