"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's (`repro.models.moe`) on the same numpy inputs, in f32 at smoke
size: the router's expert ids exactly and its gates to 1e-6, the capacity
and the first-come dispatch exactly (drops included), the layer's output
to 1e-5 and its `expert_load` exactly, with and without a router bias;
and the port's expert FFN (the plain grouped-FFN kernel) against the JAX
model's einsum `_expert_ffn` (cf. test_kernels.py:151)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.models import moe as jm
from repro_torch.configs import base as tcb
from repro_torch.models import moe as tm

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()


def _cfgs(arch="arctic-480b", **kw):
    return (dataclasses.replace(jcb.get_config(arch).smoke(), **kw),
            dataclasses.replace(tcb.get_config(arch).smoke(), **kw))


def _layer(cfg, seed=0):
    """One layer's router/expert weights as numpy (the JAX init's scales)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    n = lambda shape, s: (rng.standard_normal(shape) * s).astype(np.float32)
    return {"router": n((d, e), d ** -0.5), "wi": n((e, d, f), d ** -0.5),
            "wg": n((e, d, f), d ** -0.5), "wo": n((e, f, d), f ** -0.5)}


def _bias(e, seed=1):
    """A banded router bias, as the serving engine's tenants carry."""
    rng = np.random.default_rng(seed)
    bias = np.full((e,), -6.0, np.float32)
    bias[: e // 3 + 1] = 6.0 + rng.normal(0, 0.5, e // 3 + 1)
    return bias


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("with_bias", [False, True])
def test_route_matches_jax(with_bias):
    jcfg, tcfg = _cfgs()
    p = _layer(tcfg)
    x = _x((40, tcfg.d_model))
    bias = _bias(tcfg.num_experts) if with_bias else None
    jids, jgates = jm.route(jnp.asarray(x), jnp.asarray(p["router"]), jcfg,
                            None if bias is None else jnp.asarray(bias))
    tids, tgates = tm.route(torch.from_numpy(x),
                            torch.from_numpy(p["router"]), tcfg,
                            None if bias is None else torch.from_numpy(bias))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates),
                               atol=1e-6, rtol=1e-6)


def test_route_breaks_ties_to_the_lower_id():
    """jax.lax.top_k's order on exact ties, which torch.topk does not
    promise: equal logits route to the lowest ids."""
    jcfg, tcfg = _cfgs()
    e = tcfg.num_experts
    x = np.zeros((3, tcfg.d_model), np.float32)
    bias = np.zeros((e,), np.float32)
    bias[[1, 4, 6]] = 2.0
    jids, _ = jm.route(jnp.asarray(x), jnp.zeros((tcfg.d_model, e)), jcfg,
                       jnp.asarray(bias))
    tids, _ = tm.route(torch.from_numpy(x), torch.zeros((tcfg.d_model, e)),
                       tcfg, torch.from_numpy(bias))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[0].tolist() == [1, 4]


def test_capacity_matches_jax():
    for cf in (1.0, 1.25, 8.0):
        jcfg, tcfg = _cfgs(capacity_factor=cf)
        for n in (1, 2, 8, 40, 97, 100, 1500, 4096):
            assert tm._capacity(n, tcfg) == jm._capacity(n, jcfg)
    arctic = tcb.get_config("arctic-480b")
    assert [tm._capacity(n, arctic) for n in (8, 100, 1000, 1500)] == \
        [8, 8, 24, 32]


@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("with_bias", [False, True])
def test_dispatch_indices_match_jax_with_drops(cf, with_bias):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    p = _layer(tcfg)
    x = _x((64, tcfg.d_model))
    bias = _bias(tcfg.num_experts) if with_bias else None
    ids, _ = tm.route(torch.from_numpy(x), torch.from_numpy(p["router"]),
                      tcfg, None if bias is None else torch.from_numpy(bias))
    cap = tm._capacity(64, tcfg)
    tpos, tkept = tm._dispatch_indices(ids, tcfg.num_experts, cap)
    jpos, jkept = jm._dispatch_indices(jnp.asarray(ids.numpy(), jnp.int32),
                                       jcfg.num_experts, cap)
    assert tpos.dtype == torch.int32
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(jkept))
    if with_bias:
        assert not tkept.all(), "the banded bias must overflow a capacity"


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
@pytest.mark.parametrize("skip_empty", [False, True])
def test_moe_apply_dense_matches_jax(cf, with_bias, mlp, skip_empty):
    jcfg, tcfg = _cfgs(capacity_factor=cf, mlp=mlp)
    p = _layer(tcfg)
    x = _x((2, 24, tcfg.d_model))
    bias = _bias(tcfg.num_experts) if with_bias else None
    jy, jaux = jm.moe_apply_dense(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        None if bias is None else jnp.asarray(bias))
    ty, taux = tm.moe_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcfg, router_bias=None if bias is None else torch.from_numpy(bias),
        skip_empty=skip_empty)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert taux["expert_load"].dtype == torch.int32
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_expert_ffn_matches_jax_einsum(mlp):
    """The plain kernel behind the port's `_expert_ffn` (both entry
    points) equals the JAX model's einsums; an expert whose buffer is
    zeros gives zeros in both."""
    _, tcfg = _cfgs(mlp=mlp)

    class Cfg:
        pass

    Cfg.mlp = mlp
    rng = np.random.default_rng(7)
    buf = rng.standard_normal((3, 16, 64)).astype(np.float32)
    buf[1] = 0.0
    wi, wg = (rng.standard_normal((3, 64, 128)).astype(np.float32) * 0.1
              for _ in range(2))
    wo = rng.standard_normal((3, 128, 64)).astype(np.float32) * 0.1
    want = np.asarray(jm._expert_ffn(*map(jnp.asarray, (buf, wi, wg, wo)),
                                     Cfg))
    t = [torch.from_numpy(a) for a in (buf, wi, wg, wo)]
    got = tm._expert_ffn(*t, tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    counts = torch.tensor([16, 0, 3], dtype=torch.int32)
    got = tm._expert_ffn(*t, tcfg, counts=counts)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert not got[1].any() and not want[1].any()


def test_unported_forms_raise():
    _, tcfg = _cfgs(mlp="gelu_glu")
    p = {k: torch.from_numpy(v) for k, v in _layer(tcfg).items()}
    x = torch.from_numpy(_x((1, 4, tcfg.d_model)))
    with pytest.raises(NotImplementedError, match="swiglu"):
        tm.moe_apply(p, x, tcfg)
    _, tcfg = _cfgs()
    with pytest.raises(TypeError, match="Mesh"):
        tm.moe_apply(p, x, tcfg, mesh=object())
    # mesh=None is the single-device path, unchanged
    y, aux = tm.moe_apply(p, x, tcfg, mesh=None)
    y0, aux0 = tm.moe_apply_dense(p, x, tcfg)
    assert torch.equal(y, y0)
    assert torch.equal(aux["expert_load"], aux0["expert_load"])


def test_init_moe_matches_jax_tree():
    """Leaf shapes (stacked over the layers) and dtypes of JAX's
    init_moe, the router float32 in a bf16 model."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    want = jm.init_moe(jax.random.PRNGKey(0), jcfg)
    got = tm.init_moe(torch.Generator().manual_seed(0), tcfg, 3, "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == (3, *v.shape)
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype)
    assert got["router"].dtype == torch.float32
