"""The JAX package's side of `test_torch_mesh.py` (not collected): run on
`RANKS` forced host devices, it reads the inputs `.npz` and writes the
reference's outputs to another:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/jax_mesh_reference.py IN OUT

the fleet-sharded interleaved sweep, the sequence-sharded decode
attention and the expert-parallel MoE on a (data 2, model 2) mesh (the
latter unchunked and with `MOE_TOKEN_CHUNK` set to the test's chunk),
the int8 cross-pod mean on a (pod 2, data 2) mesh over its error-feedback
rounds, and the unsharded smoke models' prefill and decode steps."""
import sys

import jax

jax.config.update("jax_default_matmul_precision", "float32")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_mesh_checks as chk  # noqa: E402
from repro.configs import base as cb  # noqa: E402
from repro.core import isa, simulator  # noqa: E402
from repro.models import kvcache, moe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim.compress import cross_pod_mean_tree  # noqa: E402
from repro_torch.models import convert  # noqa: E402


def main(src: str, dst: str) -> None:
    assert jax.device_count() == chk.RANKS, jax.devices()
    cb.load_all()
    x = dict(np.load(src))
    out = {}
    sched = simulator.SchedulerConfig(quantum_cycles=500)
    assert simulator.fleet_mesh_size() == chk.RANKS
    res = simulator.sweep_fleet(x["fleet"], [50], isa.SCENARIO_2, sched,
                                path="interleaved", interleave_window=64,
                                **chk.FLEET_KW)
    for f, a in zip(res._fields, res):
        out[f"fleet_{f}"] = np.asarray(a)

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    cfg = cb.get_config("arctic-480b").smoke()
    o, cache = kvcache.decode_attention(
        *(jnp.asarray(x[k]) for k in ("dec_q",)),
        {"k": jnp.asarray(x["dec_k"]), "v": jnp.asarray(x["dec_v"])},
        jnp.asarray(x["dec_kn"]), jnp.asarray(x["dec_vn"]),
        jnp.asarray(x["dec_pos"]), cfg, mesh)
    out.update(dec_o=np.asarray(o), dec_k=np.asarray(cache["k"]),
               dec_v=np.asarray(cache["v"]))

    mcfg = chk.moe_cfg(cb)
    p = {k: jnp.asarray(x[f"moe_{k}"]) for k in ("router", "wi", "wg", "wo")}
    for name, chunk in (("unchunked", moe.MOE_TOKEN_CHUNK),
                        ("chunked", chk.MOE_CHUNK)):
        saved, moe.MOE_TOKEN_CHUNK = moe.MOE_TOKEN_CHUNK, chunk
        try:
            y, aux = moe.moe_apply(p, jnp.asarray(x["moe_x"]), mcfg, mesh)
        finally:
            moe.MOE_TOKEN_CHUNK = saved
        out[f"moe_{name}_y"] = np.asarray(y)
        out[f"moe_{name}_load"] = np.asarray(aux["expert_load"])

    pods = jax.make_mesh((2, 2), ("pod", "data"))
    g = {"w": jnp.asarray(x["cp_w"]), "b": jnp.asarray(x["cp_b"])}
    ef = None
    for r in range(1 + chk.EF_ROUNDS):
        with pods:
            mean, ef = cross_pod_mean_tree(g, ef, pods)
        for k in ("w", "b"):
            out[f"cp_{r}_mean_{k}"] = np.asarray(mean[k])
            out[f"cp_{r}_ef_{k}"] = np.asarray(ef[k])

    for arch in chk.MODEL_ARCHS:
        mcfg = cb.get_config(arch).smoke()
        params = jax.tree_util.tree_map(
            jnp.asarray, convert.numpy_params(mcfg, 0))
        tokens = chk.model_tokens(mcfg)
        logits, pre, aux = jt.prefill(
            mcfg, params, {"tokens": jnp.asarray(tokens[:, :chk.T0_MODEL])})
        calls = [(logits, aux)]
        cache = jt.init_cache(mcfg, chk.B_MODEL, chk.LEN_MODEL)
        cache = jax.tree_util.tree_map(
            lambda c, s: c.at[:, :, :chk.T0_MODEL].set(s), cache, pre)
        for i in range(chk.T0_MODEL, chk.T0_MODEL + chk.STEPS_MODEL):
            logits, cache, aux = jt.decode_step(
                mcfg, params,
                {"tokens": jnp.asarray(tokens[:, i:i + 1]),
                 "positions": jnp.full((chk.B_MODEL,), i, jnp.int32)},
                cache)
            calls.append((logits, aux))
        for c, (logits, aux) in enumerate(calls):
            out[f"{arch}_{c}_logits"] = np.asarray(logits)
            loads = [a["expert_load"] for seg in aux for a in seg
                     if "expert_load" in a]
            for j, load in enumerate(loads):
                out[f"{arch}_{c}_load{j}"] = np.asarray(load)
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
