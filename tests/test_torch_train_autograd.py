"""The port's gradient rule for its kernels, and the repairs that training
needs, on the CPU.

`kernels.common.KernelVjp` runs a kernel's forward and takes its
gradient from the wrapper's plain body.  The kernels themselves run only
on a card, so each wrapper's binding (`_with_plain_vjp`) runs here with
its launch (`_kernel`) replaced by a counting plain body; the gradients
of every input, absent states included, must equal those of the plain
version the wrapper runs on CPU tensors (the scans' backward bodies are
the chunked forms, the same function in another summation order: f32,
1e-5).  `decode_attention` and `moe_gmm_skip` lie on no training path and
refuse to launch where autograd would record (`common.no_vjp`).  The
model's weights are trainable, the serving paths run without autograd,
and the port's packages expose every submodule the reference's do."""
import ast
import dataclasses
import importlib
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import torch_asserts  # noqa: F401  (one torch thread under xdist)
import repro_torch.core
from repro_torch.configs import base as tcb
from repro_torch.kernels import common
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as gmm
from repro_torch.kernels import rglru_scan as rgs
from repro_torch.kernels import rwkv6_scan as rws
from repro_torch.launch import serve
from repro_torch.models import transformer as tt
from repro_torch.serve import engine
from repro_torch.serve.batching import Request
from repro_torch.tree_util import leaves, unflatten

tcb.load_all()
ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5


def _randn(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale).to(dtype)


def _flash_case(rng, window):
    q = _randn(rng, 2, 37, 4, 16)
    kv = [_randn(rng, 2, 37, 2, 16) for _ in range(2)]
    return ((q, *kv), dict(causal=True, window=window, block=16),
            lambda q, k, v: fa.flash_attention_plain(
                q, k, v, causal=True, window=window, block=16))


def _gmm_case(rng, gated):
    x = _randn(rng, 3, 5, 8)
    wg, wi = _randn(rng, 3, 8, 12, scale=0.3), _randn(rng, 3, 8, 12,
                                                       scale=0.3)
    wo = _randn(rng, 3, 12, 8, scale=0.3)
    return ((x, wg, wi if gated else None, wo), dict(gated=gated),
            lambda x, wg, wi, wo: gmm.moe_gmm_plain(x, wg, wi, wo,
                                                    gated=gated))


def _rglru_case(rng, with_h0, dtype=torch.float32):
    u = _randn(rng, 2, 70, 6, dtype=dtype)
    gates = [_randn(rng, 6, scale=0.1) for _ in range(4)]
    lam = torch.linspace(2.0, 6.0, 6)
    h0 = _randn(rng, 2, 6) if with_h0 else None
    return (u, *gates, lam, h0), {}, rgs.rglru_scan_plain


def _rwkv_case(rng, with_s0, dtype=torch.float32):
    r, k, v = (_randn(rng, 2, 21, 2, 4, dtype=dtype) for _ in range(3))
    logw = -torch.exp(_randn(rng, 2, 21, 2, 4, scale=0.5))
    u = _randn(rng, 2, 4, scale=0.1)
    s0 = _randn(rng, 2, 2, 4, 4) if with_s0 else None
    return (r, k, v, logw, u, s0), {}, rws.rwkv6_scan_plain


CASES = {
    "flash causal": (fa, lambda rng: _flash_case(rng, 0)),
    "flash window": (fa, lambda rng: _flash_case(rng, 9)),
    "moe_gmm gated": (gmm, lambda rng: _gmm_case(rng, True)),
    "moe_gmm ungated": (gmm, lambda rng: _gmm_case(rng, False)),
    "rglru h0": (rgs, lambda rng: _rglru_case(rng, True)),
    "rglru no h0": (rgs, lambda rng: _rglru_case(rng, False)),
    "rwkv6 s0": (rws, lambda rng: _rwkv_case(rng, True)),
    "rwkv6 no s0": (rws, lambda rng: _rwkv_case(rng, False)),
}
WRAPPER = {fa: "flash_attention", gmm: "moe_gmm", rgs: "rglru_scan",
           rws: "rwkv6_scan"}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _grads(fn, inputs, cotangents):
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in inputs]
    outs = _as_tuple(fn(*leaves))
    loss = sum((o.float() * c).sum() for o, c in zip(outs, cotangents))
    want = [t for t in leaves if t is not None]
    return outs, torch.autograd.grad(loss, want)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_vjp_gives_the_plain_gradient(name, monkeypatch):
    """The shared Function with the launch replaced by the plain body:
    the forward is the launch's, the gradient of every input the plain
    version's, and each backward counts one recompute (no launch)."""
    module, make = CASES[name]
    rng = np.random.default_rng(len(name))
    inputs, kw, plain = make(rng)
    launches = []

    def fake_kernel(*args, **kwargs):
        launches.append(1)
        with torch.no_grad():
            return plain(*args)

    monkeypatch.setattr(module, "_kernel", fake_kernel)
    owner = getattr(module, WRAPPER[module])
    monkeypatch.setattr(owner, "backward_recomputes", 0)
    cot = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in _as_tuple(plain(*inputs))]
    got_out, got = _grads(lambda *a: module._with_plain_vjp(*a, **kw),
                          inputs, cot)
    want_out, want = _grads(plain, inputs, cot)
    assert launches == [1] and owner.backward_recomputes == 1
    assert type(got_out[0].grad_fn).__name__ == "KernelVjpBackward"
    for g, w in zip(got_out, want_out):
        torch.testing.assert_close(g.detach(), w.detach(), rtol=0, atol=0)
    assert len(got) == len(want) == sum(t is not None for t in inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["rglru h0", "rwkv6 s0"])
def test_scan_gradients_come_back_in_the_input_dtype(name, monkeypatch):
    """bf16 activations beside f32 states and gate parameters: each
    input's gradient has the input's dtype."""
    module, _ = CASES[name]
    rng = np.random.default_rng(3)
    if module is rgs:
        inputs, _, plain = _rglru_case(rng, True, torch.bfloat16)
    else:
        inputs, _, plain = _rwkv_case(rng, True, torch.bfloat16)
    monkeypatch.setattr(module, "_kernel", plain)
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    outs = module._with_plain_vjp(*leaves)
    sum(o.sum() for o in outs).backward()
    for t in leaves:
        assert t.grad is not None and t.grad.dtype == t.dtype


def test_no_grad_and_frozen_inputs_skip_the_function():
    """Without autograd (no_grad, or no input requiring grad) the launch
    runs alone: its output has no grad_fn and nothing is saved."""
    calls = []

    def launch(x):
        calls.append(torch.is_grad_enabled())
        return x * 2

    x = torch.ones(3)
    for ctx, t in ((torch.no_grad(), x.requires_grad_(True)),
                   (torch.enable_grad(), torch.ones(3))):
        with ctx:
            out = common.with_plain_vjp(fa.flash_attention, launch,
                                        lambda x: x * 2, t)
        assert out.grad_fn is None
    assert calls == [False, True]


def test_kernels_off_the_training_path_refuse_autograd():
    """decode_attention and moe_gmm_skip call `no_vjp` before they launch:
    it raises, naming the plain route, where autograd would record, and
    passes under no_grad or on inputs that require no grad."""
    q = torch.zeros((1, 4, 64), requires_grad=True)
    kv = torch.zeros((1, 8, 2, 64))
    with pytest.raises(RuntimeError, match="use_kernel='plain'"):
        common.no_vjp("decode_attention", q, kv, kv)
    with pytest.raises(RuntimeError, match="moe_gmm_skip"):
        common.no_vjp("moe_gmm_skip", kv, q, None, kv)
    with torch.no_grad():
        common.no_vjp("decode_attention", q, kv, kv)
    common.no_vjp("decode_attention", q.detach(), kv, kv)
    assert "common.no_vjp(\"decode_attention\"" in inspect.getsource(
        da.decode_attention)
    assert "common.no_vjp(\"moe_gmm_skip\"" in inspect.getsource(
        gmm.moe_gmm_skip)


def test_decoder_weights_are_trainable_and_serving_runs_without_grad(
        monkeypatch):
    """`DecoderLM` holds trainable parameters and `params()` hands them
    back themselves, so a loss reaches every one; the serving entry
    points (the module's prefill, the batcher's callbacks, the launcher)
    run the model with autograd off."""
    cfg = tcb.get_config("granite-3-2b").smoke()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = tt.DecoderLM(cfg, params)
    named = dict(model.named_parameters())
    assert named and all(p.requires_grad for p in named.values())
    tree = model.params()
    ids = {id(p) for p in named.values()}
    assert {id(p) for p in leaves(tree)} == ids
    batch = {"tokens": np.arange(12, dtype=np.int32).reshape(2, 6)}
    loss, _ = tt.loss_fn(cfg, tree, batch)
    grads = torch.autograd.grad(loss, leaves(tree))
    assert all(g is not None and g.abs().sum() > 0 for g in grads)
    logits, cache, _ = model.prefill(batch)
    assert logits.grad_fn is None
    assert not any(t.requires_grad for t in leaves(cache))
    seen = []
    for name in ("prefill", "decode_step"):
        real = getattr(tt, name)

        def spy(*a, real=real, name=name, **kw):
            seen.append((name, torch.is_grad_enabled()))
            return real(*a, **kw)

        monkeypatch.setattr(tt, name, spy)
    batcher = engine.model_batcher(cfg, tree, 2, 16, device="cpu")
    for i in range(2):
        batcher.submit(Request(i, np.array([1, 2, 3], np.int32), 2))
    batcher.run_until_drained()
    serve.serve("granite-3-2b", smoke=True, device="cpu", num_requests=2,
                batch=2, max_len=16, new_tokens=2)
    assert {n for n, _ in seen} == {"prefill", "decode_step"}
    assert not any(grad for _, grad in seen)


def test_remat_modes_and_the_dots_policy():
    """Every remat mode gives the same loss and gradients on the CPU;
    "dots" keeps exactly the weight products (`aten.mm`); an unknown
    mode raises."""
    base = tcb.get_config("granite-3-2b").smoke()
    params = tt.init_params(base, torch.Generator().manual_seed(1), "cpu")
    flat = leaves(params)
    batch = {"tokens": np.arange(16, dtype=np.int32).reshape(2, 8) % 7}
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        leaves_ = [p.detach().requires_grad_(True) for p in flat]
        loss, _ = tt.loss_fn(cfg, unflatten(params, leaves_), batch)
        out[remat] = (loss, torch.autograd.grad(loss, leaves_))
    for remat in ("full", "dots"):
        torch.testing.assert_close(out[remat][0], out["none"][0], rtol=0,
                                   atol=0)
        for g, w in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    assert tt._save_dots(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default):
        assert tt._save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat"):
        tt._remat(dataclasses.replace(base, remat="offload"))


def test_core_exposes_expert_slots():
    assert hasattr(repro_torch.core, "expert_slots")


def test_port_packages_expose_the_reference_submodules():
    """Each package of the reference with an `__init__` (but `kernels`,
    whose re-exports the README lists as not ported) binds the same
    submodule names after a fresh import as the port's package does."""
    code = (
        "import importlib, json, types\n"
        "out = {}\n"
        "for pkg in ('configs', 'core', 'sched', 'workloads'):\n"
        "    subs = []\n"
        "    for root in ('repro', 'repro_torch'):\n"
        "        m = importlib.import_module(root + '.' + pkg)\n"
        "        subs.append(sorted(n for n, v in vars(m).items()\n"
        "                           if isinstance(v, types.ModuleType)\n"
        "                           and v.__name__.startswith(root + '.')))\n"
        "    out[pkg] = subs\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    for pkg, (ref, port) in json.loads(r.stdout.splitlines()[-1]).items():
        assert ref, pkg
        assert set(ref) <= set(port), (pkg, sorted(set(ref) - set(port)))


@pytest.mark.parametrize("name", ["data.pipeline", "optim.adamw",
                                  "optim.compress", "train.step",
                                  "checkpoint.ckpt", "runtime.fault",
                                  "launch.train"])
def test_training_modules_keep_the_reference_names(name):
    """Every public function and class of the reference's training module
    exists in the port's."""
    ref = ast.parse((ROOT / "src" / "repro" / (
        name.replace(".", "/") + ".py")).read_text())
    names = {n.name for n in ref.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_")}
    port = importlib.import_module(f"repro_torch.{name}")
    assert names and all(hasattr(port, n) for n in names), \
        sorted(n for n in names if not hasattr(port, n))
