"""Elastic re-meshing (`repro_torch.runtime.elastic`) against the JAX
package's `repro.runtime.elastic`.

`shrunk_axes` (the shape `shrink_mesh` builds) equals the reference's
`shrink_mesh` shape on 16 forced host devices for each case of
`torch_elastic_checks.SHRINKS`; where fewer ranks survive than the model
axis needs the port raises, where the reference takes the devices the
loss left out (`jax.devices()[:n]`).

One job of 4 gloo ranks (`torch_elastic_checks.run_ranks`) trains
granite-3-2b's smoke config 2 steps on a (data 2, model 2) mesh and
checkpoints it, then `shrink_mesh(3, model=2)`: ranks 0-1 form a (1, 2)
mesh, restore the checkpoint through `reshard_state` and train 2 more
steps; ranks 2-3 lie outside it.  Each restored block equals the
reference's `reshard_state` shard of the same leaf from the same
directory (JAX on 4 forced host devices) and the gathered state at the
save; the 2 steps match the reference's (metrics and state within
1e-5); ranks 2-3 make no `torch.distributed` call after the shrink."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import gspmd_asserts as ga
import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_elastic_checks as chk
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import elastic

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
SHRUNK = {"data": 1, "model": 2}


def _reference(mode: str, devices: int, *args) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ga.SRC, HERE]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "jax_elastic_reference.py"),
         mode, *args], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture(scope="module")
def reference_shapes(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("elastic_shapes") / "shapes.json")
    _reference("shapes", 16, dst)
    with open(dst) as f:
        return json.load(f)


@pytest.mark.parametrize("avail,model", chk.SHRINKS,
                         ids=[f"{a}-{m}" for a, m in chk.SHRINKS])
def test_shrunk_shape_matches_the_reference(reference_shapes, avail, model):
    want = reference_shapes[f"{avail}/{model}"]
    if avail < model:
        # the reference builds its mesh from jax.devices(), lost ones too
        assert want == {"data": 1, "model": model}
        with pytest.raises(ValueError, match="model axis"):
            elastic.shrunk_axes(avail, model)
        return
    assert elastic.shrunk_axes(avail, model) == want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays)."""
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt_dir, dst = str(tmp / "ckpt"), str(tmp / "reference.npz")
    ranks = tmesh.spawn(chk.run_ranks, chk.RANKS, (ckpt_dir,),
                        timeout=300.0)
    _reference("reshard", chk.RANKS, dst, ckpt_dir)
    return ranks, dict(np.load(dst))


def test_shrink_keeps_the_first_ranks(run):
    ranks, _ = run
    for r in ranks:
        assert r["shape"] == SHRUNK
        assert r["member"] == (r["rank"] < 2)
        assert r["coords"] == ({"data": 0, "model": r["rank"]}
                               if r["member"] else None)


def test_restored_blocks_equal_the_reference_shards(run):
    """Each member's block of every state leaf equals, bit for bit, the
    reference's `reshard_state` shard on the device at its place, and its
    block of the state gathered at the save."""
    ranks, ref = run
    for r in ranks[:2]:
        assert len(r["restored"]) == len(r["saved"])
        for i, (got, saved, spec) in enumerate(zip(
                r["restored"], r["saved"], r["specs"])):
            want = ref[f"restored{i}_{r['rank']}"]
            assert got.shape == want.shape, i
            assert np.array_equal(got.float().numpy(),
                                  want.astype(np.float32)), i
            sl = ga.block(spec, tuple(saved.shape), r["coords"], SHRUNK)
            assert got.dtype == saved.dtype and \
                bool((got == saved[sl]).all()), i


def test_training_goes_on_to_the_reference_state(run):
    """The members' 2 steps after the shrink: losses, grad norms and
    learning rates within 1e-5 of the reference's; every leaf of the
    state after them, each member's block, within 1e-5 relative L2."""
    ranks, ref = run
    for r in ranks[:2]:
        for k, m in enumerate(r["metrics"]):
            for key in ("loss", "grad_norm", "lr"):
                want = float(ref[f"step{k}_{key}"])
                assert abs(m[key] - want) <= TOL * abs(want), (k, key)
        for i, (got, spec) in enumerate(zip(r["state"], r["specs"])):
            want = ref[f"state{i}"]
            sl = ga.block(spec, want.shape, r["coords"], SHRUNK)
            if want.ndim == 0:
                assert int(got) == int(want) == chk.SAVED + chk.AFTER
                continue
            assert ga.rel(got.float().numpy(), want[sl]) <= TOL, i


def test_ranks_outside_the_shrunk_mesh_make_no_collective(run):
    """Ranks 2-3 make no `torch.distributed` call after the shrink, and a
    collective on the mesh they lie outside raises."""
    ranks, _ = run
    for r in ranks[2:]:
        assert r["calls"] == dict.fromkeys(chk.CALLS, 0)
        assert r["refused"] and "restored" not in r
    for r in ranks[:2]:
        assert r["calls"]["all_reduce"] > 0 and r["calls"]["new_group"] > 0


def test_counting_mesh_places_its_rank():
    """The stand-in of a mesh runs one rank's program: its coordinates,
    and a rank past the mesh refused."""
    m = tmesh.CountingMesh({"data": 2, "model": 2}, rank=3)
    assert m.coords == {"data": 1, "model": 1} and m.member
    assert m.axis_index(("data", "model")) == 3
    with pytest.raises(ValueError, match="outside"):
        tmesh.CountingMesh({"data": 2}, rank=2)
