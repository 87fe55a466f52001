"""The port's training data, optimizer and gradient compression against
the JAX package's (`repro.data.pipeline`, `repro.optim.adamw`,
`repro.optim.compress`), on the same numpy inputs.

Tokens are equal bit for bit.  One AdamW step on a smoke parameter tree
from the same state and gradients matches the JAX package's within f32
`rtol=1e-6` (every leaf of params, master, m and v; the ops are the
same, in the same order; XLA and PyTorch may round a transcendental, the
bias correction's power or a mean's sum one ulp apart), for f32 and bf16
trees (the master copy), a bf16 state, the factored second moment and
the decay mask; the bf16 parameters are the f32 master rounded, and
equal the JAX package's where the masters round alike.  The optimizer
cases of `tests/test_runtime.py` run on the port.  The int8 payload of
the compressed cross-pod mean is numpy's round-half-even quantisation
exactly, its mean and error feedback the JAX package's (its collectives
run under `jax.vmap` with a named pod axis), and the mean holds the
bounds of `tests/test_compress_batching.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.configs import base as tcb
from repro_torch.data import pipeline
from repro_torch.models import convert
from repro_torch.optim import adamw, compress
from repro_torch.tree_util import leaves, tree_map, unflatten

jcb.load_all()
tcb.load_all()
RTOL = 1e-6


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (1000, 32, 4, 0, 7), (1000, 32, 4, 0, 8), (500, 16, 8, 0, 3),
    (49155, 64, 3, 5, 123456), (256, 1, 1, 2, 0)])
def test_tokens_equal_the_reference(vocab, seq, batch, seed, step):
    t = pipeline.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                            seed=seed)
    j = jpipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    got = pipeline.global_batch_at(t, step)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jpipe.global_batch_at(j, step))
    np.testing.assert_array_equal(
        pipeline.make_batch(t, step, "cpu").numpy(), got)


def test_data_deterministic_and_step_dependent():
    cfg = pipeline.DataConfig(vocab=1000, seq_len=32, global_batch=4)
    a = pipeline.global_batch_at(cfg, 7)
    np.testing.assert_array_equal(a, pipeline.global_batch_at(cfg, 7))
    assert not np.array_equal(a, pipeline.global_batch_at(cfg, 8))
    assert a.min() >= 0 and a.max() < 1000


def test_prefetcher_keeps_depth_batches_in_step_order():
    cfg = pipeline.DataConfig(vocab=500, seq_len=16, global_batch=8)
    pf = pipeline.Prefetcher(cfg, "cpu", start_step=3, depth=2)
    assert len(pf._queue) == 2
    for want in (3, 4, 5):
        step, batch = pf.get()
        assert step == want and len(pf._queue) == 2
        assert batch.dtype == torch.int32 and batch.device.type == "cpu"
        np.testing.assert_array_equal(batch.numpy(),
                                      pipeline.global_batch_at(cfg, step))


# ---------------------------------------------------------------------------
# AdamW: one step against the JAX package's
# ---------------------------------------------------------------------------

def _np_tree(arch, dtype):
    """A smoke tree as numpy, its working leaves in `dtype` (the f32
    leaves `convert` names stay f32), zero leaves perturbed."""
    cfg = tcb.get_config(arch).smoke()
    rng = np.random.default_rng(7)
    tree = convert.numpy_params(cfg, 0)

    def leaf(a, name):
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a if name in convert._F32_LEAVES or dtype == "float32" \
            else a.astype(ml_dtypes.bfloat16)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, name) for v in t]
        return leaf(t, name)

    return walk(tree)


def _grads_like(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda a: (scale * rng.standard_normal(a.shape)).astype(
        a.dtype), tree)


def _to_torch(tree):
    return tree_map(lambda a: convert.to_tensor(a, "cpu"), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


# (arch, dtype, config, gradient scale): at 2e-4 the gradients' global
# norm stays below clip_norm, so both packages scale them by exactly 1
OPT_CASES = {
    "f32": ("granite-3-2b", "float32", {}, 2e-4),
    "bf16 master": ("granite-3-2b", "bfloat16", {}, 2e-4),
    "bf16 state": ("arctic-480b", "bfloat16", dict(state_dtype="bfloat16"),
                   2e-4),
    "factored v": ("recurrentgemma-9b", "float32", dict(factored_v=True),
                   2e-4),
    "no master, constant": ("rwkv6-7b", "bfloat16",
                            dict(master_fp32=False, schedule="constant"),
                            2e-4),
    "clipped, in warmup": ("granite-3-2b", "bfloat16",
                           dict(clip_norm=0.5, warmup=5), 1.0),
}
# the global norm is a sum of ~1e5 f32 squares, summed in another order
# by each package (observed 1.6e-6 to 2.6e-6 apart); once clipping
# scales the gradients by clip / norm, m and v carry that difference
NORM_RTOL = 1e-5


def _close(got, want, rtol, what):
    """Within rtol of each element, or of the leaf's largest magnitude
    (an element near zero is a cancellation of terms of that size)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max(initial=0.0)), err_msg=what)


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_matches_the_reference(case):
    """Two steps (the second from the first's state) from the same
    params and gradients: params, master, m, v and the learning rate
    within f32 rtol 1e-6, the global norm (and, under clipping, m and v)
    within NORM_RTOL; the decay mask equal leaf for leaf."""
    arch, dtype, kw, gscale = OPT_CASES[case]
    ocfg = dict(dict(lr=3e-3, weight_decay=0.1, warmup=1, total_steps=10),
                **kw)
    clipped = gscale == 1.0
    tree = _np_tree(arch, dtype)
    jstate = jadamw.init_state(jadamw.AdamWConfig(**ocfg),
                               jax.tree_util.tree_map(jnp.asarray, tree))
    tstate = adamw.init_state(adamw.AdamWConfig(**ocfg), _to_torch(tree))
    assert (tstate.master is None) == (jstate.master is None)
    assert [bool(m) for m in leaves(adamw._decay_mask(tstate.params))] == \
        jax.tree_util.tree_leaves(jadamw._decay_mask(jstate.params))
    for i, scale in enumerate((gscale, 2 * gscale)):
        g = _grads_like(tree, 11 + i, scale)
        jstate, jm = jadamw.apply_updates(
            jadamw.AdamWConfig(**ocfg), jstate,
            jax.tree_util.tree_map(jnp.asarray, g))
        tstate, tm = adamw.apply_updates(adamw.AdamWConfig(**ocfg), tstate,
                                         _to_torch(g))
        assert int(tstate.step) == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert (float(jm["grad_norm"]) > ocfg.get("clip_norm", 1.0)) == \
            clipped
        for field in ("master", "m", "v"):
            got = leaves(getattr(tstate, field))
            want = jax.tree_util.tree_leaves(getattr(jstate, field))
            assert len(got) == len(want), field
            rtol = NORM_RTOL if clipped and field != "master" else RTOL
            for a, b in zip(got, want):
                assert str(a.dtype).split(".")[-1] == str(b.dtype), field
                _close(_np(a), b, rtol, field)
        ref = tstate.master if tstate.master is not None else None
        for j, (a, b) in enumerate(zip(
                leaves(tstate.params),
                jax.tree_util.tree_leaves(jstate.params))):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            got, want = _np(a).astype(np.float32), np.asarray(b, np.float32)
            if a.dtype == torch.float32:
                _close(got, want, RTOL, "params")
            elif ref is not None:
                m32 = leaves(ref)[j]
                np.testing.assert_array_equal(got, m32.to(a.dtype).float())
                jm32 = np.asarray(jax.tree_util.tree_leaves(
                    jstate.master)[j])
                alike = (m32.to(a.dtype).float().numpy() ==
                         jm32.astype(ml_dtypes.bfloat16).astype(np.float32))
                np.testing.assert_array_equal(got[alike], want[alike])
                assert alike.mean() > 0.999
            else:
                # no master: the f32 update rounds to bf16 in both
                _close(got, want, 2 ** -8, "params")


def test_adamw_reduces_quadratic_loss():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup=0,
                            schedule="constant")
    state = adamw.init_state(cfg, {"w": torch.tensor([3.0, -2.0])})
    for _ in range(120):
        w = state.params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        state, _ = adamw.apply_updates(cfg, state, {"w": g})
    assert float(state.params["w"].abs().max()) < 0.15


def test_adamw_factored_v_close_to_full():
    full = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup=0,
                             schedule="constant")
    fact = dataclasses.replace(full, factored_v=True)
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))

    def train(cfg):
        state = adamw.init_state(cfg, {"w": torch.zeros((8, 8))})
        for _ in range(150):
            w = state.params["w"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.mean((w - target) ** 2), [w])
            state, _ = adamw.apply_updates(cfg, state, {"w": g})
        return float(torch.mean((state.params["w"] - target) ** 2))

    assert train(fact) < 0.05 and train(full) < 0.05


def test_grad_clipping_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0,
                            warmup=0, schedule="constant")
    state = adamw.init_state(cfg, {"w": torch.zeros(4)})
    state, metrics = adamw.apply_updates(cfg, state,
                                         {"w": torch.full((4,), 1e6)})
    assert float(metrics["grad_norm"]) > 1e5
    assert float(state.params["w"].abs().max()) < 1.5


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(lr=2e-3, warmup=7, total_steps=40, schedule=schedule)
    got = [float(adamw._lr_at(adamw.AdamWConfig(**kw),
                              torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 45)]
    want = [float(jadamw._lr_at(jadamw.AdamWConfig(**kw), jnp.int32(s)))
            for s in range(0, 45)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _jax_compressed(g, ef):
    fn = jax.vmap(lambda a, e: jcompress.compressed_psum_mean(a, e, "pod"),
                  axis_name="pod")
    mean, new_ef = fn(jnp.asarray(g), jnp.asarray(ef))
    return np.asarray(mean), np.asarray(new_ef)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 16), (4, 3, 5, 7)])
def test_int8_payload_is_exact_and_the_mean_is_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    g.flat[::17] = np.float32(0.5) * np.abs(g).max()    # ties at .5 steps
    ef = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    gf, scale, q = compress.quantize(torch.from_numpy(g),
                                     torch.from_numpy(ef))
    want_scale = max(max(float(np.abs(x).max()) / np.float32(127.0), 1e-12)
                     for x in (g + ef))
    assert float(scale) == np.float32(want_scale)
    want_q = np.clip(np.rint((g + ef) / np.float32(want_scale)), -127,
                     127).astype(np.int8)
    np.testing.assert_array_equal(q.numpy(), want_q)
    mean, new_ef = compress.compressed_psum_mean(torch.from_numpy(g),
                                                 torch.from_numpy(ef))
    jmean, jef = _jax_compressed(g, ef)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=RTOL, atol=0)
    np.testing.assert_allclose(new_ef.numpy(), jef, rtol=RTOL,
                               atol=float(scale) * RTOL)


def test_cross_pod_compressed_mean():
    """The case of `tests/test_compress_batching.py`: a 2-pod tree, the
    quantised mean within 2 % of the exact one, the residual within one
    quantisation step, and error feedback driving the average error of 8
    more rounds below one step."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(
        np.float32)),
         "b": torch.from_numpy(rng.standard_normal((2, 16)).astype(
             np.float32))}
    mean, ef = compress.cross_pod_mean_tree(g, None)
    assert set(mean) == set(ef) == {"w", "b"}
    want_w = g["w"].mean(0, keepdim=True).expand_as(g["w"]).numpy()
    got_w = mean["w"].numpy()
    assert np.abs(got_w - want_w).max() / (np.abs(want_w).max() + 1e-9) \
        < 0.02
    scale = float(g["w"].abs().max()) / 127.0
    assert float(ef["w"].abs().max()) <= scale * 1.01
    acc = np.zeros_like(got_w)
    efs = ef
    for _ in range(8):
        mean2, efs = compress.cross_pod_mean_tree(g, efs)
        acc += mean2["w"].numpy() - want_w
    assert np.abs(acc / 8).max() < scale
    # the tree's leaves come back in the tree's structure
    assert unflatten(g, leaves(mean))["w"] is mean["w"]
