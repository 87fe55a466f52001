"""The port's sharding plan (`repro_torch.sharding.ShardingPlan`) against
the JAX package's (`repro.sharding.partition.ShardingPlan`): for every
arch, mode and production mesh, `param_specs`, `cache_specs` and
`act_spec` equal the reference's spec for spec (a port spec is the plain
tuple of a `PartitionSpec`'s entries), on each package's own parameter
and cache trees at full size (the port's on the meta device, JAX's by
`eval_shape`), and every spec divides its dimension; `act` lays a
whole activation out as its block under the reference's fitted spec."""
import functools

import jax
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.models import transformer as jt
from repro.sharding.partition import ShardingPlan as JPlan
from repro_torch.configs import base as tcb
from repro_torch.launch.mesh import flat_axes
from repro_torch.models import transformer as tt
from repro_torch.sharding.partition import ShardingPlan as TPlan
from repro_torch.sharding.partition import spec_leaves

jcb.load_all()
tcb.load_all()


class FakeMesh:
    """Shape-only stand-in (plans never touch devices for their specs),
    seen from rank 0 (the first block along every axis)."""

    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)
        self.devices = np.empty((0,))

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in flat_axes(axes)]))

    def axis_index(self, axes) -> int:
        return 0


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]
KINDS = ("hidden", "attn_in", "mlp_in", "q_heads", "kv_heads", "attn_out",
         "logits", "nothing")
CACHE_BATCH, CACHE_LEN = 128, 32768


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(the port's meta params, JAX's abstract params) of `arch`."""
    t = tt.init_params(tcb.get_config(arch), torch.Generator(), "meta")
    j = jax.eval_shape(lambda: jt.init_params(jcb.get_config(arch),
                                              jax.random.PRNGKey(0)))
    return t, j


@functools.lru_cache(maxsize=None)
def _caches(arch):
    t = tt.init_cache(tcb.get_config(arch), CACHE_BATCH, CACHE_LEN, "meta")
    j = jax.eval_shape(lambda: jt.init_cache(jcb.get_config(arch),
                                             CACHE_BATCH, CACHE_LEN))
    return t, j


def _jax_specs(specs) -> list:
    """[(name, spec as a tuple)] of a tree of PartitionSpecs, jax's order."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(spec)) for path, spec in flat]


def _shapes(tree) -> dict:
    return dict((name, tuple(leaf.shape))
                for name, leaf in spec_leaves(tree))


def _divides(mesh, specs, shapes):
    size = lambda e: 1 if e is None else int(np.prod(
        [mesh.shape[a] for a in ((e,) if isinstance(e, str) else e)]))
    for name, spec in specs:
        shape = shapes[name]
        assert len(spec) <= len(shape), (name, spec, shape)
        for dim, e in zip(shape, spec):
            assert dim % size(e) == 0, (name, spec, shape)


@pytest.mark.parametrize("arch", tcb.ARCH_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=["1pod", "2pod"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_param_specs_equal_the_reference(arch, mesh, mode):
    tparams, jparams = _params(arch)
    tplan = TPlan(mesh, tcb.get_config(arch), mode=mode)
    jplan = JPlan(mesh, jcb.get_config(arch), mode=mode)
    assert (tplan.strategy, tplan.fsdp, tplan.data_axes) == \
        (jplan.strategy, jplan.fsdp, jplan.data_axes)
    got = spec_leaves(tplan.param_specs(tparams))
    assert got == _jax_specs(jplan.param_specs(jparams))
    _divides(mesh, got, _shapes(tparams))


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-110b"])
def test_dp_strategy_specs_equal_the_reference(arch):
    tparams, jparams = _params(arch)
    mesh = MESHES[0]
    tplan = TPlan(mesh, tcb.get_config(arch), mode="train",
                  strategy_override="dp")
    jplan = JPlan(mesh, jcb.get_config(arch), mode="train",
                  strategy_override="dp")
    assert tplan.strategy == jplan.strategy == "dp"
    got = spec_leaves(tplan.param_specs(tparams))
    assert got == _jax_specs(jplan.param_specs(jparams))
    _divides(mesh, got, _shapes(tparams))
    for kind in KINDS:
        want = jplan.act_spec(kind)
        assert tplan.act_spec(kind) == (None if want is None
                                        else tuple(want))


@pytest.mark.parametrize("arch", tcb.ARCH_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=["1pod", "2pod"])
def test_cache_specs_equal_the_reference(arch, mesh):
    tcache, jcache = _caches(arch)
    tplan = TPlan(mesh, tcb.get_config(arch), mode="decode")
    jplan = JPlan(mesh, jcb.get_config(arch), mode="decode")
    got = spec_leaves(tplan.cache_specs(tcache))
    assert got == _jax_specs(jplan.cache_specs(jcache))
    _divides(mesh, got, _shapes(tcache))


@pytest.mark.parametrize("arch", ["granite-3-2b", "minitron-4b",
                                  "rwkv6-7b"])
@pytest.mark.parametrize("mesh", MESHES, ids=["1pod", "2pod"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_act_specs_equal_the_reference(arch, mesh, mode):
    tplan = TPlan(mesh, tcb.get_config(arch), mode=mode)
    jplan = JPlan(mesh, jcb.get_config(arch), mode=mode)
    for kind in KINDS:
        want = jplan.act_spec(kind)
        assert tplan.act_spec(kind) == (None if want is None
                                        else tuple(want)), kind
        # a whole activation relaid to the spec is this rank's block
        x = torch.zeros((64,) * (4 if kind.endswith("heads") else 3))
        spec = (None,) * x.dim() if want is None else jplan._fit_cache(
            want, x.shape)
        assert tplan.act(x, kind).shape == tplan.local_shape(
            x.shape, tuple(spec)), kind
