"""The JAX package's side of `test_torch_gspmd_serve.py` (not collected):
run on `RANKS` forced host devices, it serves every arch of
`torch_gspmd_checks.ARCHS` (smoke configs, the weights of
`repro_torch.models.convert.numpy_params(cfg, 0)`) through the
reference's `repro.serve.step` under its plans on a (data 2, model 2)
mesh, f32 products in full precision, and writes the outputs to an
`.npz`:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/jax_gspmd_reference.py OUT

`jit_prefill_step` over the first T0 tokens (logits, the prompt's cache,
expert loads), then the cache set into a LEN-long one and STEPS
`jit_decode_step` calls (logits and loads each, the final cache)."""
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
from repro_torch.models import convert  # noqa: E402


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


def main(dst: str) -> None:
    assert jax.device_count() == chk.RANKS, jax.devices()
    cb.load_all()
    # Auto axes: the reference's plans constrain layouts for GSPMD
    mesh = jax.make_mesh(
        tuple(chk.MESH.values()), tuple(chk.MESH),
        axis_types=(jax.sharding.AxisType.Auto,) * len(chk.MESH))
    out = {}
    for arch, fsdp in chk.ARCHS:
        cfg = cb.get_config(arch).smoke()
        pre_plan = ShardingPlan(mesh, cfg, mode="prefill", fsdp=fsdp)
        dec_plan = ShardingPlan(mesh, cfg, mode="decode", fsdp=fsdp)
        toks = chk.tokens(cfg.vocab)
        prefill, shapes = step.jit_prefill_step(
            cfg, pre_plan,
            {"tokens": jax.ShapeDtypeStruct((chk.B, chk.T0), jnp.int32)})
        params = jax.device_put(
            jax.tree_util.tree_map(jnp.asarray,
                                   convert.numpy_params(cfg, 0)),
            pre_plan.param_shardings(shapes))
        logits, pre, loads = prefill(
            params, {"tokens": jnp.asarray(toks[:, :chk.T0])})
        out[f"{arch}_0_logits"] = np.asarray(logits)
        out.update(_leaves(f"{arch}_prefill", pre))
        out.update(_loads(f"{arch}_0", loads))
        decode, _, cshapes = step.jit_decode_step(
            cfg, dec_plan,
            {"tokens": jax.ShapeDtypeStruct((chk.B, 1), jnp.int32),
             "positions": jax.ShapeDtypeStruct((chk.B,), jnp.int32)},
            chk.B, chk.LEN)
        cache = jt.init_cache(cfg, chk.B, chk.LEN)
        cache = jax.tree_util.tree_map(
            lambda c, s: c.at[:, :, :chk.T0].set(s), cache, pre)
        cache = jax.device_put(cache, dec_plan.cache_shardings(cshapes))
        for c, i in enumerate(range(chk.T0, chk.T0 + chk.STEPS), 1):
            batch = {k: jnp.asarray(v)
                     for k, v in chk.decode_batch(toks, i).items()}
            logits, cache, loads = decode(params, cache, batch)
            out[f"{arch}_{c}_logits"] = np.asarray(logits)
            out.update(_loads(f"{arch}_{c}", loads))
        out.update(_leaves(f"{arch}_decode", cache))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1])
