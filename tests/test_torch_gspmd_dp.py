"""Training under the reference's "dp" strategy (pure data parallelism
with ZeRO-3: the batch's rows over every axis, every leaf cut over every
axis on its largest dimension and gathered a layer at a time), one
process a rank: one job of 4 gloo ranks (`torch_gspmd_dp_checks`) trains
granite-3-2b (remat "full"; in 2 microbatches of 4 rows; in 4
microbatches of 1 row, which does not divide over the ranks),
qwen1.5-4b (remat "dots", the loss in chunks of 4), recurrentgemma-9b
and arctic-480b (experts, the factored second moment) on a (data 2,
model 2) mesh with `strategy_override="dp"`, while one JAX subprocess
on 4 forced host devices runs the reference's
`repro.train.step.jit_train_step` under the same plans
(`jax_gspmd_train_reference.py` with `OPTIONS`).  Each rank's blocks are
held as the GSPMD training tests hold theirs (`gspmd_train_asserts`):
the first loss, every gradient block, three steps' metrics, the state
after them and each block's shape by the reference's `state_shardings`.

The same job counts one granite `dp` step on rank 0 twice: under
`analysis.cost.CostCounter` on the rank's CPU tensors, and through the
counting stand-in `launch.mesh.CountingMesh` on meta; the two counts are
equal.  `launch.perf` counts the `dp` variants per rank on the
production mesh's shape, its all-gather bytes the weights gathered."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import gspmd_asserts as ga
import gspmd_train_asserts as gta
import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_gspmd_dp_checks as dchk
import torch_gspmd_checks as gchk
from repro.sharding.partition import ShardingPlan as JPlan
from repro_torch.configs import base as tcb
from repro_torch.launch import dryrun, perf
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import CountingMesh, flat_axes
from repro_torch.serve.step import abstract_params
from repro_torch.sharding import ShardingPlan
from repro_torch.sharding.partition import zip_map
from repro_torch.tree_util import leaves

jax.config.update("jax_default_matmul_precision", "float32")

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = pytest.mark.parametrize("case", dchk.CASES,
                                ids=[c.name for c in dchk.CASES])
COUNTED = ("flops", "flops_total", "bytes", "bytes_read", "bytes_written",
           "kernel_bytes", "ops", "kernels", "collective_bytes",
           "collectives")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays: its
    training and its prefill)."""
    tmp = tmp_path_factory.mktemp("gspmd_dp")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ga.SRC, HERE]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = {"train": ("jax_gspmd_train_reference.py", dchk.CASES,
                      dchk.OPTIONS),
            "prefill": ("jax_gspmd_reference.py", (dchk.PREFILL,),
                        dchk.PREFILL_OPTIONS)}
    refs = {k: subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), str(tmp / f"{k}.npz"),
         gchk.to_json(cases), options], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for k, (script, cases, options) in jobs.items()}
    try:
        ranks = tmesh.spawn(dchk.run_ranks, dchk.RANKS, (dchk.CASES,),
                            timeout=400.0)
        for ref in refs.values():
            out, err = ref.communicate(timeout=400)
            assert ref.returncode == 0, out + err
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
    arrays = {}
    for k in jobs:
        arrays.update(np.load(tmp / f"{k}.npz"))
    return ranks, arrays


@CASES
def test_dp_loss_matches_jax(run, case):
    ranks, ref = run
    gta.hold_loss(ranks, ref, case)


@CASES
def test_dp_gradient_blocks_match_jax_grad(run, case):
    ranks, ref = run
    gta.hold_grads(ranks, ref, case, dchk.STRATEGY)


@CASES
def test_dp_train_steps_metrics_match_jax(run, case):
    ranks, ref = run
    gta.hold_metrics(ranks, ref, case)


@CASES
def test_dp_state_after_three_steps_matches_jax(run, case):
    ranks, ref = run
    gta.hold_state(ranks, ref, case, dchk.STRATEGY)


@CASES
def test_dp_state_blocks_have_state_shardings_shapes(run, case):
    """Each block's shape is the reference's; under "dp" every leaf
    large enough is cut over both axes, params and optimizer alike."""
    ranks, _ = run
    gta.hold_shapes(ranks, case, dchk.STRATEGY)
    flat, _, specs = gta.state_specs(case, dchk.STRATEGY)
    assert any(("data", "model") in tuple(s) for s in flat)
    assert jax.tree_util.tree_leaves(specs.params) == \
        jax.tree_util.tree_leaves(specs.m)


def test_dp_prefill_matches_jax_serve_step(run):
    """granite's `jit_prefill_step` under the "dp" plan: each rank's block
    of the logits (rows over both axes) and of the prompt's cache (the
    decode layout) within 1e-5 of the reference's under the same plan."""
    ranks, ref = run
    case = dchk.PREFILL
    plan = JPlan(ga.FakeMesh(dchk.MESH), ga.jconfig(case), mode="prefill",
                 fsdp=case.fsdp, strategy_override=dchk.STRATEGY)
    shape = (gchk.B, 1, ga.jconfig(case).vocab)
    spec = plan._fit_cache(plan.act_spec("logits", 3), shape)
    assert tuple(spec)[0] == ("data", "model")
    ga.hold(ranks, lambda r: r[case.name]["calls"][0][0],
            ref[f"{case.name}_0_logits"], spec, f"{case.name} logits")
    ga._check_cache(ranks, ref, case, "prefill", case.t0)


def test_stand_in_count_equals_the_real_ranks_count(run):
    """Rank 0's `dp` step counted on its CPU tensors over the real mesh
    and on meta through `CountingMesh`: FLOPs, bytes, ops, kernels and
    collectives equal; the step gathers, reduce-scatters and all-reduces
    bytes."""
    ranks, _ = run
    for r in ranks:
        real, stand_in = r["counts"]["real"], r["counts"]["stand_in"]
        assert {k: real[k] for k in COUNTED} == \
            {k: stand_in[k] for k in COUNTED}
        assert set(real["collectives"]) == {"all-gather", "reduce-scatter",
                                            "all-reduce"}
        assert real["collective_bytes"] > 0


def _gathered_weight_bytes(cfg) -> int:
    """The bytes a rank gathers of the weights in one `dp` step of
    granite on the 16 x 16 mesh: every leaf that "dp" cuts (all but the
    embedding, whose 49,155 rows divide over neither 256 nor 16 ranks)
    whole, its own block included, as an all-gather's result holds it:
    each layer's in the forward and again in remat's recompute ("full"),
    the top-level leaves once."""
    plan = ShardingPlan(CountingMesh(perf.production_shape()), cfg,
                        strategy_override="dp")
    sizes = zip_map(lambda t, spec: t.numel() * t.element_size() * any(
        "data" in flat_axes(e) for e in spec), abstract_params(cfg),
        plan.model_specs())
    layers = sum(leaves(sizes.pop("segments")))
    top = sum(sizes.values())
    assert top < 0.01 * layers
    return layers * (2 if cfg.remat == "full" else 1) + top


@pytest.fixture(scope="module")
def dp_counts():
    """`launch.perf`'s count of rank 0's granite train_4k step under each
    `dp` variant on the 16 x 16 mesh's shape."""
    tcb.load_all()
    return {v: perf.count_variant("granite-3-2b", "train_4k", v)["count"]
            for v in ("dp", "dp_mb1", "dp_mb4")}


def test_perf_dp_gathers_the_weights(dp_counts):
    """granite train_4k under "dp" on the 16 x 16 mesh's shape: the
    all-gather bytes of rank 0's step are the weights gathered (each
    layer in the forward and in remat's recompute, the top-level leaves
    once), within 1 %; the record's collective bytes are the count's and
    enter the roofline's collective term."""
    c = dp_counts["dp"]
    cfg = tcb.get_config("granite-3-2b")
    want = _gathered_weight_bytes(cfg)
    got = c["collectives"]["all-gather"]["bytes"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    r = perf.measure("granite-3-2b", "train_4k", "dp")
    assert r["collective_bytes_per_device"] == c["collective_bytes"] > got
    assert r["flops_per_device"] == c["flops_total"]
    assert r["roofline"]["collective_s"] == pytest.approx(
        c["collective_bytes"] / 450e9)


def test_perf_dp_mb1_is_dp_and_mb4_gathers_more(dp_counts):
    """granite takes one microbatch (`microbatches_for`), so `dp` and
    `dp_mb1` count the same step; four microbatches gather the weights
    once each."""
    assert dryrun.microbatches_for(tcb.get_config("granite-3-2b")) == 1
    dp, mb1, mb4 = (dp_counts[v] for v in ("dp", "dp_mb1", "dp_mb4"))
    for k in ("flops", "bytes", "collective_bytes", "collectives"):
        assert dp[k] == mb1[k]
    assert mb4["collectives"]["all-gather"]["bytes"] > \
        dp["collectives"]["all-gather"]["bytes"]
