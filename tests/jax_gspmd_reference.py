"""The JAX package's side of the GSPMD serving tests (not collected): run
on `RANKS` forced host devices, it serves every case it is given (a JSON
list of `torch_gspmd_checks.Case`s; the smoke configs, the weights of
`torch_gspmd_checks.weights`, the inputs of `torch_gspmd_checks.inputs`)
through the reference's `repro.serve.step` under its plans on a (data 2,
model 2) mesh, f32 products in full precision, and writes the outputs to
an `.npz`:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/jax_gspmd_reference.py OUT CASES \\
        [OPTIONS]

`jit_prefill_step` over the prompt (logits, the prompt's cache, expert
loads), then the cache set into a longer one by leaf (a state or a window
cache whole, a full cache's first positions) and STEPS `jit_decode_step`
calls (logits and loads each, the final cache).  OPTIONS, a JSON object,
may set the prefill plan's `strategy_override` ("strategy") and stop
after the prefill ("prefill_only")."""
import json
import sys

import jax

jax.config.update("jax_default_matmul_precision", "float32")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_gspmd_checks as chk  # noqa: E402
from repro.configs import base as cb  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import step  # noqa: E402
from repro.sharding.partition import ShardingPlan  # noqa: E402


def _leaves(prefix: str, cache) -> dict:
    out = {}
    for si, seg in enumerate(cache):
        for j, blk in enumerate(seg):
            for name, leaf in blk.items():
                out[f"{prefix}_{si}_{j}_{name}"] = np.asarray(leaf)
    return out


def _loads(prefix: str, loads) -> dict:
    return {f"{prefix}_load{j}": np.asarray(ld)
            for j, ld in enumerate(loads)}


def _specs(batch: dict) -> dict:
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in batch.items()}


def _set(c, s):
    """A cache leaf set from the prompt's: whole where the shapes agree,
    else (a full cache) its first positions."""
    return s if c.shape == s.shape else c.at[:, :, :s.shape[2]].set(s)


def main(dst: str, cases: str, options: str = "{}") -> None:
    opts = json.loads(options)
    assert jax.device_count() == chk.RANKS, jax.devices()
    cb.load_all()
    # Auto axes: the reference's plans constrain layouts for GSPMD
    mesh = jax.make_mesh(
        tuple(chk.MESH.values()), tuple(chk.MESH),
        axis_types=(jax.sharding.AxisType.Auto,) * len(chk.MESH))
    out = {}
    for case in chk.from_json(cases):
        name, cfg = case.name, chk.config(cb, case)
        pre_plan = ShardingPlan(mesh, cfg, mode="prefill", fsdp=case.fsdp,
                                strategy_override=opts.get("strategy"))
        dec_plan = ShardingPlan(mesh, cfg, mode="decode", fsdp=case.fsdp)
        pre_in, dec_in = chk.inputs(case)
        prefill, shapes = step.jit_prefill_step(cfg, pre_plan,
                                                _specs(pre_in))
        params = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray, chk.weights(cfg)),
            pre_plan.param_shardings(shapes))
        logits, pre, loads = prefill(
            params, {k: jnp.asarray(v) for k, v in pre_in.items()})
        out[f"{name}_0_logits"] = np.asarray(logits)
        out.update(_leaves(f"{name}_prefill", pre))
        out.update(_loads(f"{name}_0", loads))
        if opts.get("prefill_only"):
            continue
        decode, _, cshapes = step.jit_decode_step(
            cfg, dec_plan, _specs(dec_in[0]), chk.B, chk.length(case.t0))
        cache = jt.init_cache(cfg, chk.B, chk.length(case.t0))
        cache = jax.tree_util.tree_map(_set, cache, pre)
        cache = jax.device_put(cache, dec_plan.cache_shardings(cshapes))
        for c, batch in enumerate(dec_in, 1):
            logits, cache, loads = decode(
                params, cache, {k: jnp.asarray(v) for k, v in batch.items()})
            out[f"{name}_{c}_logits"] = np.asarray(logits)
            out.update(_loads(f"{name}_{c}", loads))
        out.update(_leaves(f"{name}_decode", cache))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
