"""The port's `SlotServeEngine` (`repro_torch.serve.engine`) against the
JAX package's (`repro.serve.engine`) on arctic-480b's and
llama4-maverick's smoke configs, f32, with the JAX package's weights
carried across (`params_from_numpy`) and the same numpy tenants: the
stats dict (fills, accesses, steps, per_tenant, hit_rate, fill_seconds)
equals JAX's exactly at 2/4 slots with slot-hit routing off and on; and
the port's `bench_expert_slots` rows equal the JAX module's at the same
small step count."""
import jax
import numpy as np
import pytest

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from benchmarks import bench_expert_slots as jbench
from repro.configs import base as jcb
from repro.models import transformer as jt
from repro.serve import engine as je
from repro_torch.bench import bench_expert_slots as tbench
from repro_torch.configs import base as tcb
from repro_torch.models import convert
from repro_torch.serve import engine as te

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

STEPS = 24
KEYS = ("fills", "accesses", "steps", "per_tenant", "hit_rate",
        "fill_seconds")


def _models(arch):
    jcfg, tcfg = jcb.get_config(arch).smoke(), tcb.get_config(arch).smoke()
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b"])
def test_engine_stats_match_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    for slots in (2, 4):
        for bias in (0.0, 4.0):
            kw = dict(quantum_tokens=16, slots_per_shard=slots,
                      hit_bias=bias)
            # bench_expert_slots' banded tenants: the same numpy draws
            want = je.SlotServeEngine(
                jcfg, jp, je.EngineConfig(**kw), jbench.make_tenants(jcfg),
                max_len=STEPS + 4).run(STEPS)
            got = te.SlotServeEngine(
                tcfg, tp, te.EngineConfig(**kw), tbench.make_tenants(tcfg),
                max_len=STEPS + 4, device="cpu").run(STEPS)
            for k in KEYS:
                assert got[k] == want[k], (arch, slots, bias, k)
            assert got == want


def test_bench_rows_match_jax(monkeypatch):
    monkeypatch.setattr(jbench, "STEPS", 3)
    want = jbench.run()
    _, _, _, tp = _models("arctic-480b")
    assert tbench.run(params=tp, steps=3, device="cpu") == want
