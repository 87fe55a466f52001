"""Training under the reference's GSPMD layouts, one process a rank: one
job of 4 gloo ranks (`torch_gspmd_train_checks.run_ranks`) trains the
smoke configs of granite-3-2b (head-TP, FSDP, remat "full"), qwen1.5-4b
(sequence-parallel, remat "dots", the loss in chunks of 4 tokens), arctic-480b
(sequence-parallel with experts, FSDP, the factored second moment),
recurrentgemma-9b (RG-LRU and local attention, FSDP), rwkv6-7b (no FSDP:
ZeRO-1 alone cuts m and v over data) and granite-3-2b in two
microbatches on a (data 2, model 2) mesh, while one JAX subprocess on 4
forced host devices runs the reference's `repro.train.step.jit_train_step`
on the same cases (`jax_gspmd_train_reference.py`; f32 products in full
precision, batch 4 x 16).  Every rank's blocks are held within 1e-5: the
first batch's loss of `loss_fn(shd=plan)` and every gradient leaf (the
rank's ZeRO-1 block, summed over the ranks) against the reference's
`jax.value_and_grad` under the plan; three steps' losses, grad norms and
learning rates; params, m and v after them (relative L2); each block's
shape is its block's by the reference's `state_shardings`.  Where the
reference's own result without a plan sits farther from its GSPMD one
than 1e-5 (rwkv6-7b: its gradients through the WKV recurrence up to
7.8e-5 apart, 9.5e-4 after three steps; the gradient of qwen's key bias,
zero but for rounding, and Adam's update of it), that leaf or metric is
held within SPREAD (2) times the reference's own gap.

The same job holds each `Mesh` collective's backward to its transpose
(<f(x), g> = <x, f^T(g)> summed over the ranks, every axis set),
`all_reduce(op="max")` refusing a tensor that requires grad,
`apply_updates` on ZeRO-1 blocks (bf16 params with an f32 master; the
factored second moment) against one rank's on the whole state, and
`launch.train.run(mesh=...)` restarting from a checkpoint written under
the mesh to the losses of an uninterrupted run, the checkpoint restoring
on one rank leaf for leaf as the ranks' state gathered."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gspmd_asserts as ga
import gspmd_train_asserts as gta
import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_gspmd_train_checks as chk
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tcb
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep
from repro_torch.tree_util import leaves

jax.config.update("jax_default_matmul_precision", "float32")

HERE = os.path.dirname(os.path.abspath(__file__))
TOL, NORM_RTOL, SPREAD = gta.TOL, gta.NORM_RTOL, gta.SPREAD
CASES = pytest.mark.parametrize("case", chk.CASES,
                                ids=[c.name for c in chk.CASES])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays, the
    launcher's checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("gspmd_train")
    dst, ckpt_dir = str(tmp / "reference.npz"), chk.ckpt_path(tmp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ga.SRC, HERE]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_gspmd_train_reference.py"),
         dst, chk.to_json(chk.CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = tmesh.spawn(chk.run_ranks, chk.RANKS, (chk.CASES, ckpt_dir),
                            timeout=400.0)
        out, err = ref.communicate(timeout=400)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, out + err
    return ranks, dict(np.load(dst)), ckpt_dir


_specs = gta.state_specs
_fields = gta.fields
_hold = gta.hold


@CASES
def test_loss_matches_jax_under_the_plan(run, case):
    ranks, ref, _ = run
    want = float(ref[f"{case.name}_loss"])
    for r in ranks:
        assert abs(r[case.name]["loss"] - want) <= TOL * abs(want)


@CASES
def test_each_gradient_block_matches_jax_grad(run, case):
    """Every leaf's gradient on every rank, its ZeRO-1 block (m's spec)
    summed over the ranks, within 1e-5 relative L2 of the same block of
    the reference's `jax.grad` of `loss_fn` under the plan, the blocks put
    together within 1e-5 of the whole leaf (or within SPREAD times the
    reference's own gap: see the module docstring)."""
    ranks, ref, _ = run
    _, _, specs = _specs(case)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    m_specs = jax.tree_util.tree_leaves(specs.m, is_leaf=is_spec)
    assert len(ranks[0][case.name]["grads"]) == len(m_specs)
    for i, spec in enumerate(m_specs):
        _hold(ranks, lambda r: r[case.name]["grads"][i],
              ref[f"{case.name}_grad{i}"], ref[f"{case.name}_grad_one{i}"],
              spec, f"{case.name} grad {i}")


@CASES
def test_train_steps_metrics_match_jax(run, case):
    """Three `jit_train_step` calls: the loss, the grad norm and the
    learning rate of each on every rank, within NORM_RTOL (or SPREAD
    times the reference's own gap)."""
    ranks, ref, _ = run
    for k in range(chk.TRAIN_STEPS):
        for key in ("loss", "grad_norm", "lr"):
            want = float(ref[f"{case.name}_step{k}_{key}"])
            one = float(ref[f"{case.name}_one_step{k}_{key}"])
            tol = max(NORM_RTOL, SPREAD * abs(one - want) / abs(want))
            for r in ranks:
                got = r[case.name]["metrics"][k][key]
                assert abs(got - want) <= tol * abs(want), (k, key, tol)


@CASES
def test_state_after_three_steps_matches_jax(run, case):
    """params, m, v (and master where there is one) after 3 steps, each
    rank's block of each leaf within 1e-5 relative L2 of the reference's
    block of it by `state_shardings` (or SPREAD times the reference's own
    gap), the step count equal."""
    ranks, ref, _ = run
    flat, _, specs = _specs(case)
    fields = _fields(specs)
    assert len(ranks[0][case.name]["state"]) == len(flat)
    for i, (spec, field) in enumerate(zip(flat, fields)):
        want = ref[f"{case.name}_state{i}"]
        if field == "step":
            for r in ranks:
                assert int(r[case.name]["state"][i]) == int(want) == 3
            continue
        _hold(ranks, lambda r: r[case.name]["state"][i], want,
              ref[f"{case.name}_one_state{i}"], spec,
              f"{case.name} state {field} {i}")


@CASES
def test_state_blocks_have_state_shardings_shapes(run, case):
    """Each rank's block of every state leaf has the shape of its block
    by the reference's `state_shardings`; some m leaf is cut over data
    where its param is not (ZeRO-1)."""
    ranks, _, _ = run
    flat, shapes, specs = _specs(case)
    for r in ranks:
        want = [ga.block_shape(spec, tuple(s.shape), r["coords"])
                for spec, s in zip(flat, shapes)]
        assert [tuple(s) for s in r[case.name]["shapes"]] == want
    if not case.fsdp:
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
        pairs = zip(jax.tree_util.tree_leaves(specs.params, is_leaf=is_spec),
                    jax.tree_util.tree_leaves(specs.m, is_leaf=is_spec))
        assert any("data" in tuple(m) and "data" not in tuple(p)
                   for p, m in pairs)


@pytest.mark.parametrize("kind", ["all_reduce", "all_gather",
                                  "reduce_scatter"])
@pytest.mark.parametrize("axes", ["data", "model", "data+model"])
def test_collective_backward_is_its_transpose(run, kind, axes):
    """<f(x), g> summed over the ranks equals <x, f^T(g)> summed over
    them, f^T the collective's backward (float64)."""
    ranks, _, _ = run
    fx = sum(r["adjoints"][f"{kind}/{axes}"][0] for r in ranks)
    xt = sum(r["adjoints"][f"{kind}/{axes}"][1] for r in ranks)
    assert abs(fx - xt) <= 1e-12 * max(1.0, abs(fx))


def test_all_reduce_max_refuses_a_tensor_that_requires_grad(run):
    ranks, _, _ = run
    assert all(r["adjoints"]["max_raises"] for r in ranks)
    with pytest.raises(ValueError, match="gradient"):
        Mesh({"data": 1}).all_reduce(torch.ones(2, requires_grad=True),
                                     "data", "max")


@pytest.mark.parametrize("arch", ["granite-3-2b", "arctic-480b"])
def test_apply_updates_on_zero1_blocks_matches_one_rank(run, arch):
    """Two AdamW steps on each rank's ZeRO-1 blocks against one rank's on
    the whole state (the same gradients): every leaf of the state within
    1e-6 (bf16 params: a rounding), the grad norms within NORM_RTOL;
    granite's bf16 tree keeps an f32 master, arctic's takes the factored
    second moment."""
    ranks, _, _ = run
    for r in ranks:
        got = r["optimizer"][arch]
        assert got["master"] == (arch == "granite-3-2b")
        assert max(got["gaps"]) <= (1e-2 if arch == "granite-3-2b"
                                    else 1e-6), got["gaps"]
        for whole, mine in got["norms"]:
            assert abs(whole - mine) <= NORM_RTOL * whole


def test_launcher_restarts_under_the_mesh(run):
    """`launch.train.run(mesh=...)` with a failure injected at step 3
    restarts from step 2's checkpoint, written under the mesh, and ends
    with the losses of an uninterrupted run on every rank; each rank
    reports its resident bytes of params, m, v (m and v its ZeRO-1
    blocks: smaller than one rank's whole state)."""
    ranks, _, _ = run
    for r in ranks:
        clean, failed = r["launcher"]["clean"], r["launcher"]["failed"]
        assert clean["restarts"] == 0 and failed["restarts"] == 1
        assert failed["final_step"] == clean["final_step"] == 6
        np.testing.assert_allclose(failed["losses"][-3:],
                                   clean["losses"][-3:], rtol=1e-6)
        held = failed["resident_bytes"]
        assert held["m"] == held["v"] < held["params"]
        assert held["master"] == 0


def test_mesh_checkpoint_restores_on_one_rank(run):
    """The launcher's last checkpoint (written under the mesh) restores
    on one rank without a plan, leaf for leaf equal to the ranks' final
    state put together by its specs."""
    ranks, _, ckpt_dir = run
    tcb.load_all()
    cfg = tcb.get_config("granite-3-2b").smoke()
    like = tstep.abstract_state(cfg, tadamw.AdamWConfig())
    whole = ckpt.restore(ckpt_dir, ckpt.latest_step(ckpt_dir), like, "cpu")
    got = ranks[0]["launcher"]["gathered"]
    assert len(got) == len(leaves(whole))
    for a, b in zip(got, leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
