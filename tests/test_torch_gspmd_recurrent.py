"""The recurrent families served under the reference's GSPMD layouts, one
process a rank: one job of 4 gloo ranks (`torch_gspmd_checks.run_ranks`
with this file's `ARCHS`) serves the smoke configs of recurrentgemma-9b
(RG-LRU and local attention, head-TP, FSDP), rwkv6-7b (FSDP),
recurrentgemma-9b under `attn_sharding="seq"` and recurrentgemma-9b
with a 64-token prompt, twice its window (the prefill cache's ring
slots), through `repro_torch.serve.step` on a (data 2, model 2) mesh,
while one JAX subprocess on 4 forced host devices runs the reference's
`repro.serve.step` under its plans on the same cases
(`jax_gspmd_reference.py`).  Every rank's blocks are held
(`gspmd_asserts`) within 1e-5 relative L2 (f32): the prefill logits and
every cache leaf (the states, the window caches), 3 decode steps' logits
and the final cache; each weight leaf, cache leaf
(`init_cache(..., shd=plan)`) and tagged activation has its block's
shape by the reference's `param_specs`, `cache_specs` and `act_spec`;
`rglru_scan` runs on lru_width/2 channels, `rwkv6_scan` on H/2 heads and
the windowed flash on H/2 heads (under `seq` on all heads, at q_offset
T/2 on the second model rank); `model_batcher` under a plan serves as
the one-rank batcher does.  Training under a (1, 1) plan gives the
loss and gradients of training without one (the 4-rank training cases
are `test_torch_gspmd_train.py`'s)."""
import jax
import numpy as np
import pytest
import torch

import gspmd_asserts as ga
import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_gspmd_checks as chk
from repro.models import transformer as jt
from repro_torch.configs import base as tcb
from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.sharding import ShardingPlan
from repro_torch.tree_util import leaves, tree_map

jax.config.update("jax_default_matmul_precision", "float32")

ARCHS = (chk.Case("recurrentgemma-9b", "recurrentgemma-9b", True),
         chk.Case("rwkv6-7b", "rwkv6-7b", True),
         chk.Case("recurrentgemma-9b-seq", "recurrentgemma-9b", False,
                  (("attn_sharding", "seq"),)),
         chk.Case("recurrentgemma-9b-t64", "recurrentgemma-9b", False,
                  (), 64))
SERVE_ARCHS = ("recurrentgemma-9b", "rwkv6-7b")
CASES = pytest.mark.parametrize("case", ARCHS, ids=[c.name for c in ARCHS])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays)."""
    return ga.run_job(tmp_path_factory, ARCHS, SERVE_ARCHS)


@CASES
def test_prefill_step_matches_jax_serve_step(run, case):
    ga.hold_prefill(run, case)


@CASES
def test_decode_steps_match_jax_serve_step(run, case):
    ga.hold_decode(run, case)


@CASES
def test_each_rank_holds_its_blocks_of_the_weights(run, case):
    ga.hold_weights(run, case)


@CASES
def test_init_cache_allocates_the_ranks_blocks(run, case):
    """`init_cache(..., shd=plan)`: each leaf of the decode cache has its
    block's shape by the reference's `cache_specs` on every rank, and
    the states' channels and heads are cut over `model`."""
    ranks, _ = run
    cfg = ga.jconfig(case)
    length = chk.length(case.t0)
    shapes = jax.eval_shape(lambda: jt.init_cache(cfg, chk.B, length))
    specs = ga.jplan(case, "decode").cache_specs(shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for r in ranks:
        want = {}
        for path, spec in flat:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            want[name] = ga.block_shape(
                spec, tuple(ga.leaf_at(shapes, name).shape), r["coords"])
        assert dict(r[case.name]["init_cache"]) == want
    model = [n for n, s in flat if "model" in tuple(s)]
    assert model, "no state is cut over model"


@CASES
def test_tagged_activations_have_their_blocks_shapes(run, case):
    """As the attention archs', with the kinds the reference tags for the
    arch: rwkv6 only the residual stream and the logits."""
    kinds = {"hidden", "logits"} if case.arch == "rwkv6-7b" \
        else ga.ATTN_KINDS
    ga.hold_acts(run, case, kinds)


@CASES
def test_kernels_run_on_each_ranks_blocks(run, case):
    """Each rank's `rglru_scan` calls take lru_width/2 channels and its
    `rwkv6_scan` calls H/2 heads, once a layer at prefill and at each
    decode step; its flash calls (one a local-attention layer) take the
    window on H/2 heads at offset 0, under `seq` all H heads at q_offset
    T/2 on the second model rank."""
    ranks, _ = run
    cfg = ga.jconfig(case)
    types = [t for ts, n in tt.segments(cfg) for t in ts * n]
    calls = 1 + chk.STEPS
    for r in ranks:
        got = r[case.name]
        assert got["scans"]["rglru_scan"] == \
            [cfg.lru_width // 2] * (types.count("rec") * calls)
        assert got["scans"]["rwkv6_scan"] == \
            [cfg.d_model // cfg.head_dim // 2] * (types.count("rwkv") * calls)
        assert len(got["flash"]) == types.count("lattn")
        if cfg.attn_sharding == "seq":
            want = (cfg.num_heads, r["coords"]["model"] * case.t0 // 2,
                    cfg.window)
        else:
            want = (cfg.num_heads // 2, 0, cfg.window)
        assert set(got["flash"]) <= {want}
    assert any(ranks[0][c.name]["scans"]["rglru_scan"] for c in ARCHS)
    assert any(ranks[0][c.name]["scans"]["rwkv6_scan"] for c in ARCHS)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_model_batcher_under_a_plan_serves_as_one_rank(run, arch):
    ga.hold_serve(run, arch)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_training_under_a_one_rank_plan_matches_no_plan(arch):
    """The train-mode loss and every gradient leaf under a (1, 1) plan
    equal those without a plan (the same sums, but the sharded blocks'
    order of a few of them); serving on one rank's mesh runs."""
    tcb.load_all()
    cfg = tcb.get_config(arch).smoke()
    plan = ShardingPlan(Mesh({"data": 1, "model": 1}), cfg, mode="train")
    params = convert.params_from_numpy(chk.weights(cfg), "cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)}
    out = []
    for shd in (None, plan):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, _ = tt.loss_fn(cfg, params, batch, shd=shd)
        out.append((loss.detach(), torch.autograd.grad(loss, flat)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for got, want in zip(out[1][1], out[0][1], strict=True):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    params = tree_map(lambda p: p.detach(), params)
    logits, _, _ = tt.prefill(cfg, params, batch, shd=ShardingPlan(
        plan.mesh, cfg, mode="prefill"))
    want, _, _ = tt.prefill(cfg, params, batch)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
