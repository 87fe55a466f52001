"""The port's multi-device paths on `torch.distributed` against the JAX
package's `shard_map` sections: one job of 4 gloo ranks
(`repro_torch.launch.mesh.spawn`) runs every check
(`torch_mesh_checks.run_ranks`) while one JAX subprocess on 4 forced host
devices computes the reference's (`jax_mesh_reference.py`); the ranks'
blocks are put together here and held

* bit for bit: the fleet-sharded interleaved sweep (B=3 P=2, 400 steps,
  window 64; each rank sweeps one fleet of the padded 4) against the
  reference's mesh sweep and the port's scan; `ContentionModel.predict`
  on 3 groups against the scan; the expert loads; the int8 cross-pod
  mean and residuals over 9 error-feedback rounds on (pod 2, data 2)
  against the reference and the port's leading-dimension form;
* within 2e-5: the sequence-sharded decode attention on (data 2, model
  2), positions in both sequence blocks and on their edge, and the
  expert-parallel MoE output (unchunked, and in chunks of 32 tokens);
* within 1e-5: a smoke MoE model's (and granite's, head-TP with GQA)
  prefill and 3 decode steps under the port's plans, against the port's
  one-rank run and the JAX package's unsharded one;
* equal: the smoke MoE model served by `model_batcher` and the
  `SlotServeEngine` under a plan, against one rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_mesh_checks as chk
from repro_torch.configs import base as tcb
from repro_torch.core import isa, simulator
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import compress
from repro_torch.sched import ContentionModel, PlacementConfig

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
TOL_ATTN = TOL_MOE = 2e-5
TOL_MODEL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays, the
    inputs)."""
    tmp = tmp_path_factory.mktemp("mesh")
    x = chk.make_inputs()
    src, dst = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    np.savez(src, **x)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_mesh_reference.py"), src,
         dst], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = tmesh.spawn(chk.run_ranks, chk.RANKS, (x,), timeout=500.0)
        out, err = ref.communicate(timeout=560)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, out + err
    return ranks, dict(np.load(dst)), x


def _by_coords(ranks, **fixed):
    return [r for r in ranks
            if all(r["coords"][a] == v for a, v in fixed.items())]


def test_fleet_sweep_shards_over_the_ranks_bit_for_bit(run):
    ranks, ref, x = run
    sched = simulator.SchedulerConfig(quantum_cycles=500)
    scan = simulator.sweep_fleet(x["fleet"], [50], isa.SCENARIO_2, sched,
                                 path="scan", device="cpu", **chk.FLEET_KW)
    for r in ranks:
        assert r["mesh_size"] == chk.RANKS
        assert r["blocks"][0] == 1          # B=3 padded to 4, one a rank
        for f, a, b in zip(scan._fields, r["fleet"], scan):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
            np.testing.assert_array_equal(a.numpy(), ref[f"fleet_{f}"],
                                          err_msg=f)


def test_contention_model_on_ranks_equals_the_scan(run):
    ranks, _, _ = run
    scan = ContentionModel(PlacementConfig(**chk.PLACEMENT), path="scan",
                           device="cpu").predict(chk.GROUPS)
    for r in ranks:
        # the candidate batch rounds up to the ranks: 3 groups -> 4
        assert r["mesh_size"] == chk.RANKS
        for g, a, b in zip(chk.GROUPS, r["predict"], scan):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(g))


def test_sequence_sharded_decode_attention_matches_jax(run):
    ranks, ref, _ = run
    s_loc = chk.S_DEC // 2
    o = np.zeros_like(ref["dec_o"])
    k, v = np.zeros_like(ref["dec_k"]), np.zeros_like(ref["dec_v"])
    for r in ranks:
        d, m = r["coords"]["data"], r["coords"]["model"]
        rows, seq = slice(2 * d, 2 * d + 2), slice(m * s_loc,
                                                   (m + 1) * s_loc)
        o[rows] = r["decode"]["o"].numpy()
        k[rows, seq] = r["decode"]["k"].numpy()
        v[rows, seq] = r["decode"]["v"].numpy()
    # every model rank of a data row returns the same combined output
    for d in range(2):
        a, b = _by_coords(ranks, data=d)
        assert torch.equal(a["decode"]["o"], b["decode"]["o"])
    np.testing.assert_allclose(o, ref["dec_o"], atol=TOL_ATTN, rtol=TOL_ATTN)
    np.testing.assert_array_equal(k, ref["dec_k"])
    np.testing.assert_array_equal(v, ref["dec_v"])


@pytest.mark.parametrize("form", ["unchunked", "chunked"])
def test_expert_parallel_moe_matches_jax(run, form):
    ranks, ref, _ = run
    y = np.zeros_like(ref[f"moe_{form}_y"])
    for r in ranks:
        d = r["coords"]["data"]
        got, load = r["moe"][form]
        y[2 * d:2 * d + 2] = got.numpy()
        assert load.dtype == torch.int32
        np.testing.assert_array_equal(load.numpy(), ref[f"moe_{form}_load"])
    np.testing.assert_allclose(y, ref[f"moe_{form}_y"], atol=TOL_MOE,
                               rtol=TOL_MOE)
    # capacities 16 and 8 drop tokens: the forms differ, each as the JAX one
    assert not np.array_equal(ref["moe_unchunked_load"],
                              ref["moe_chunked_load"])


def test_cross_pod_mean_over_ranks_is_bit_equal(run):
    ranks, ref, x = run
    g = {"w": torch.from_numpy(x["cp_w"]), "b": torch.from_numpy(x["cp_b"])}
    ef = None
    for rnd in range(1 + chk.EF_ROUNDS):
        mean, ef = compress.cross_pod_mean_tree(g, ef)   # leading pods
        for r in ranks:
            i = r["compress"]["pod"]
            got_m, got_e = r["compress"]["rounds"][rnd]
            for k in ("w", "b"):
                for got, lead, key in ((got_m, mean, "mean"),
                                       (got_e, ef, "ef")):
                    a = got[k].numpy()
                    np.testing.assert_array_equal(
                        a, lead[k][i:i + 1].numpy(), err_msg=f"{rnd} {k}")
                    np.testing.assert_array_equal(
                        a, ref[f"cp_{rnd}_{key}_{k}"][i:i + 1],
                        err_msg=f"{rnd} {k}")


@pytest.mark.parametrize("arch", chk.MODEL_ARCHS)
def test_model_under_plans_matches_one_rank_and_jax(run, arch):
    ranks, ref, _ = run
    tcb.load_all()
    one_l, one_a = chk.model_run(arch)
    for r in ranks:
        logits, loads = r["models"][arch]
        assert len(logits) == 1 + chk.STEPS_MODEL
        for c, (got, want) in enumerate(zip(logits, one_l)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=TOL_MODEL, rtol=TOL_MODEL,
                                       err_msg=f"call {c}")
            np.testing.assert_allclose(got.numpy(), ref[f"{arch}_{c}_logits"],
                                       atol=TOL_MODEL, rtol=TOL_MODEL,
                                       err_msg=f"call {c}")
        for c, (got, want) in enumerate(zip(loads, one_a)):
            assert len(got) == len(want)
            for j, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b)
                np.testing.assert_array_equal(a.numpy(),
                                              ref[f"{arch}_{c}_load{j}"])


def test_serving_under_a_plan_equals_one_rank(run):
    """`model_batcher` and the `SlotServeEngine` on (data 1, model 4), each
    rank holding 2 of the 8 experts and a quarter of each cache's
    positions: every request's tokens and the engine's stats equal the
    one-rank serve's."""
    ranks, _, _ = run
    one = chk.serve_run()
    for r in ranks:
        assert r["serve"]["report"] == one["report"]
        assert r["serve"]["tokens"] == one["tokens"]
        assert r["serve"]["slots"] == one["slots"]


def test_without_a_process_group_every_axis_is_one():
    m = tmesh.Mesh({"data": 1, "model": 1})
    x = torch.arange(6.0).reshape(2, 3)
    assert m.axis_index(("data", "model")) == 0 and m.size == 1
    assert torch.equal(m.all_reduce(x, "model", "max"), x)
    assert torch.equal(m.all_gather(x, ("data", "model"), dim=1), x)
    assert simulator.fleet_mesh_size() == 1
    with pytest.raises(ValueError, match="4 ranks"):
        tmesh.make_host_mesh(2, 2)
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="nope"):
        m.axis_size("nope")


def test_spawn_returns_in_rank_order_and_raises_on_a_failed_rank():
    assert tmesh.spawn(chk.fails, 2, (-1,), timeout=120.0) == [0, 1]
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        tmesh.spawn(chk.fails, 2, (1,), timeout=120.0)
