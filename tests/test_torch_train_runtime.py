"""The port's training runtime against the JAX package's: checkpoints
(`repro_torch.checkpoint.ckpt`), the fault-tolerant supervisor
(`repro_torch.runtime.fault`) and the train driver
(`repro_torch.launch.train`), on the CPU.

The cases of `tests/test_runtime.py` and `tests/test_compress_batching.py`
run on the port.  A checkpoint that either package writes restores leaf
for leaf in the other (same files, same leaf order, bf16 as uint16
views, the sha1s checked).  The driver passes the reference's two
driver tests, and its first 5 losses on a smoke arch of each family
(dense, MoE, RG-LRU, RWKV6) equal the JAX driver's, from the JAX
package's weights (`run(init_params=...)`) and the same token stream,
within TRAJ_TOL (f32: rounding apart in the gradients, amplified by
five AdamW steps at lr 1e-3)."""
import dataclasses
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jcb
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tcb
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.runtime import fault
from repro_torch.train import step as train_step
from repro_torch.tree_util import leaves

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()
TRAJ_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)]}
    ckpt.save(str(tmp_path), 42, tree)
    assert ckpt.latest_step(str(tmp_path)) == 42
    back = ckpt.restore(str(tmp_path), 42, tree, "cpu")
    for x, y in zip(leaves(tree), leaves(back), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    path = ckpt.save(str(tmp_path), 1, tree)
    arr = np.load(os.path.join(path, "arr_0.npy"))
    arr[0] = 999.0
    np.save(os.path.join(path, "arr_0.npy"), arr)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), 1, tree, "cpu")


def test_partial_checkpoint_invisible(tmp_path):
    os.makedirs(tmp_path / "step_00000009")  # no manifest -> torn write
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_restore_refuses_another_tree(tmp_path):
    ckpt.save(str(tmp_path), 3, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path), 3, {"a": torch.zeros(2),
                                        "b": torch.zeros(2)}, "cpu")


def test_async_checkpoint_roundtrip(tmp_path):
    """The saver's host copies are its own: updating the tensor in place
    after `save` changes nothing on disk."""
    saver = ckpt.AsyncSaver()
    tree = {"a": torch.arange(10, dtype=torch.float32)}
    saver.save(str(tmp_path), 5, tree)
    tree["a"].add_(100.0)
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 5
    back = ckpt.restore(str(tmp_path), 5, tree, "cpu")
    assert torch.equal(back["a"], torch.arange(10, dtype=torch.float32))


def _states(arch):
    """The same bf16 train state (params, f32 master, m, v, step) in both
    packages, after one AdamW step so no leaf is trivial."""
    jcfg = dataclasses.replace(jcb.get_config(arch).smoke(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(tcb.get_config(arch).smoke(),
                               dtype="bfloat16")
    opt = dict(lr=1e-2, warmup=1, total_steps=4)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = jadamw.init_state(jadamw.AdamWConfig(**opt), jparams)
    grads = jax.tree_util.tree_map(
        lambda p: (0.01 * jax.random.normal(jax.random.PRNGKey(1), p.shape)
                   ).astype(p.dtype), jparams)
    jstate, _ = jadamw.apply_updates(jadamw.AdamWConfig(**opt), jstate,
                                     grads)
    return jcfg, tcfg, jadamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt), \
        jstate


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-9b"])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, arch):
    jcfg, tcfg, _, topt, jstate = _states(arch)
    jckpt.save(str(tmp_path), 7, jstate)
    like = train_step.abstract_state(tcfg, topt)
    assert like.master is not None
    back = ckpt.restore(str(tmp_path), 7, like, "cpu")
    assert isinstance(back, adamw.TrainState) and int(back.step) == 1
    want = jax.tree_util.tree_leaves(jstate)
    got = leaves(back)
    assert len(got) == len(want)
    for (a, m), b in zip(zip(got, leaves(like)), want):
        assert a.shape == m.shape and a.dtype == m.dtype
        assert str(_np(a).dtype) == str(np.asarray(b).dtype)
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["granite-3-2b", "arctic-480b"])
def test_a_port_checkpoint_restores_in_jax(tmp_path, arch):
    jcfg, _, jopt, _, jstate = _states(arch)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = adamw.TrainState(*(
        None if f is None else jax.tree_util.tree_map(
            lambda a: convert.to_tensor(a, "cpu"), f) for f in host))
    ckpt.save(str(tmp_path), 9, tstate)
    shapes = jax.eval_shape(lambda: jadamw.init_state(
        jopt, jt.init_params(jcfg, jax.random.PRNGKey(0))))
    back = jckpt.restore(str(tmp_path), 9, shapes)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_supervised_restart_resumes_from_checkpoint():
    """Inject a failure; the run must restore and produce the same final
    state a failure-free run produces (deterministic data)."""
    def make_run(fail_at):
        saved = {}
        state = {"x": 0}

        def init_fn():
            if "ckpt" in saved:
                return dict(saved["ckpt"]), saved["step"]
            return dict(state), 0

        def step_fn(st, step):
            return {"x": st["x"] + (step + 1)}, {}

        def save_fn(st, step):
            saved["ckpt"] = dict(st)
            saved["step"] = step

        failed = {"done": False}

        def fail_hook(step):
            if fail_at is not None and step == fail_at and not failed["done"]:
                failed["done"] = True
                raise fault.TrainingFailure("boom")

        report = fault.run_supervised(
            init_fn=init_fn, step_fn=step_fn, save_fn=save_fn,
            restore_fn=init_fn, num_steps=10, ckpt_every=3,
            fail_hook=fail_hook)
        return report, saved["ckpt"]["x"]

    clean_report, clean_x = make_run(None)
    fail_report, fail_x = make_run(7)
    assert fail_report["restarts"] == 1
    assert fail_report["final_step"] == clean_report["final_step"] == 10
    assert fail_report["steps_run"] == clean_report["steps_run"] + 1
    assert fail_x == clean_x  # deterministic replay


def test_restart_budget_exhausted():
    def fail_hook(step):
        raise fault.TrainingFailure("always")

    with pytest.raises(fault.TrainingFailure):
        fault.run_supervised(
            init_fn=lambda: ({}, 0), step_fn=lambda s, i: (s, {}),
            save_fn=lambda s, i: None, restore_fn=lambda: ({}, 0),
            num_steps=5, ckpt_every=100,
            policy=fault.RestartPolicy(max_restarts=2),
            fail_hook=fail_hook)


def test_straggler_monitor_flags_slow_steps():
    seen = []
    mon = fault.StragglerMonitor(window=16, threshold=2.0,
                                 on_straggler=lambda *a: seen.append(a))
    for i in range(20):
        mon.observe(i, 0.1)
    assert mon.observe(20, 0.5)  # 5x median
    assert len(mon.events) == 1 and seen == [(20, 0.5, 0.1)]
    assert not mon.observe(21, 0.11)


def test_straggler_monitor_times_bounded_by_window():
    mon = fault.StragglerMonitor(window=16, threshold=2.0)
    for i in range(500):
        mon.observe(i, 0.1)
    assert len(mon.times) == 16
    assert mon.observe(500, 0.5)


def test_run_supervised_custom_retryable():
    class FlakyIO(OSError):
        pass

    failed = {"done": False}

    def fail_hook(step):
        if step == 2 and not failed["done"]:
            failed["done"] = True
            raise FlakyIO("transient")

    kw = dict(init_fn=lambda: ({}, 0), step_fn=lambda s, i: (s, {}),
              save_fn=lambda s, i: None, restore_fn=lambda: ({}, 0),
              num_steps=5, ckpt_every=100, fail_hook=fail_hook)
    with pytest.raises(FlakyIO):
        fault.run_supervised(**kw)
    failed["done"] = False
    report = fault.run_supervised(
        retryable=(fault.TrainingFailure, FlakyIO), **kw)
    assert report["restarts"] == 1 and report["final_step"] == 5
    with pytest.raises(TypeError, match="retryable"):
        fault.run_supervised(retryable=("not-a-type",), **kw)


def test_heartbeat(tmp_path):
    hb = fault.Heartbeat(str(tmp_path / "hb.json"))
    assert hb.age() == float("inf")
    hb.beat(3, 0.5)
    assert hb.age() < 5.0


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_train_driver_loss_decreases(tmp_path):
    # 50 steps on random embeds: the learnable signal is the label
    # marginals (the reference test's setting)
    report = train.run("musicgen-medium", smoke=True, steps=50, batch=4,
                       seq=32, ckpt_dir=str(tmp_path), ckpt_every=10,
                       log_every=0, device="cpu")
    losses = report["losses"]
    assert report["final_step"] == 50
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert ckpt.latest_step(str(tmp_path)) == 50
    assert os.path.exists(tmp_path / "heartbeat_musicgen-medium.json")
    assert len(report["step_times"]) == 50 and report["step_s"] > 0
    assert report["tokens_per_s"] == pytest.approx(4 * 32 /
                                                   report["step_s"])
    assert report["peak_memory_bytes"] is None


def test_train_driver_restart_matches_clean_run(tmp_path):
    clean = train.run("granite-3-2b", smoke=True, steps=16, batch=2,
                      seq=32, ckpt_dir=str(tmp_path / "clean"),
                      ckpt_every=4, log_every=0, device="cpu")
    failed = train.run("granite-3-2b", smoke=True, steps=16, batch=2,
                       seq=32, ckpt_dir=str(tmp_path / "fail"),
                       ckpt_every=4, fail_at=10, log_every=0, device="cpu")
    assert failed["restarts"] == 1
    # after restart, replayed losses must match the clean run's tail
    assert failed["losses"][-1] == pytest.approx(clean["losses"][-1],
                                                 rel=1e-4)
    assert failed["losses"][-6:] == clean["losses"][-6:]


def _smoke_tree(arch):
    return convert.numpy_params(tcb.get_config(arch).smoke(), 0)


def test_train_driver_trains_a_tree_of_tensors_in_place():
    """A tree of tensors as init_params trains as its numpy tree does, and
    the run updates its tensors in place."""
    tree = _smoke_tree("granite-3-2b")
    kw = dict(smoke=True, steps=3, batch=2, seq=32, log_every=0,
              device="cpu")
    want = train.run("granite-3-2b", init_params=tree, **kw)
    params = convert.params_from_numpy(tree, "cpu")
    start = params["embed"].detach().clone()
    got = train.run("granite-3-2b", init_params=params, **kw)
    assert got["losses"] == want["losses"]
    assert not torch.equal(params["embed"].detach(), start)


def test_train_driver_tree_of_tensors_starts_one_run(tmp_path):
    """A failure before the first checkpoint restarts from fresh weights,
    which a tree of tensors trained in place no longer is: it raises."""
    tree = _smoke_tree("granite-3-2b")
    with pytest.raises(RuntimeError, match="trained in place"):
        train.run("granite-3-2b", smoke=True, steps=4, batch=2, seq=32,
                  ckpt_dir=str(tmp_path), ckpt_every=4, fail_at=2,
                  log_every=0, device="cpu",
                  init_params=convert.params_from_numpy(tree, "cpu"))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["granite-3-2b", "arctic-480b",
                                  "recurrentgemma-9b", "rwkv6-7b"])
def test_loss_trajectory_matches_the_jax_driver(arch, microbatches):
    """5 steps of each driver from the JAX package's smoke weights on
    the same token stream (batch 4 of 32 tokens; with 2 microbatches,
    gradients accumulated in the param dtype)."""
    kw = dict(smoke=True, steps=5, batch=4, seq=32, log_every=0,
              microbatches=microbatches)
    want = jtrain.run(arch, **kw)["losses"]
    cfg = jcb.get_config(arch).smoke()
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_params(cfg, jax.random.PRNGKey(0)))
    got = train.run(arch, device="cpu", init_params=tree, **kw)["losses"]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)
