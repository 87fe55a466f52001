"""Continuous batching over the port's model (`repro_torch.serve.engine.
model_batcher`) against the JAX package's on granite-3-2b-smoke: the same
numpy weights and requests generate identical tokens, rows do not
contaminate each other, and `python -m repro_torch.launch.serve` serves
on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.serve.batching import Request as JRequest
from repro.serve.engine import model_batcher as jax_batcher
from repro_torch.configs import base as tcb
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import model_batcher

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

ARCH = "granite-3-2b"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jcb.get_config(ARCH).smoke(), tcb.get_config(ARCH).smoke()
    tree = convert.numpy_params(tcfg, 0)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            convert.params_from_numpy(tree, "cpu"))


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (int(t),)).astype(np.int32)
            for t in rng.integers(1, 9, n)]


def test_generated_tokens_equal_jax(models):
    """Ragged prompts, more requests than rows: the rows are re-leased and
    each request's tokens equal the JAX batcher's."""
    jcfg, jp, tcfg, tp = models
    horizon = 24
    prompts = _prompts(tcfg, 5)
    jb = jax_batcher(jcfg, jp, batch_size=2, max_len=horizon)
    tb = model_batcher(tcfg, tp, batch_size=2, max_len=horizon,
                       device="cpu")
    jreqs = [JRequest(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jb.submit(jr)
        tb.submit(tr)
    jrep, trep = jb.run_until_drained(), tb.run_until_drained()
    assert trep == jrep
    assert trep["finished"] == 5
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, tr.rid


def test_batched_rows_do_not_cross_contaminate(models):
    """Two different prompts in adjacent rows must generate exactly what
    they generate when run alone (test_model_batcher.py's case)."""
    _, _, cfg, params = models
    horizon = 20
    pa = np.array([3, 5, 7, 9], np.int32)
    pb = np.array([11, 2, 4, 8], np.int32)

    def run_alone(prompt):
        b = model_batcher(cfg, params, batch_size=2, max_len=horizon,
                          device="cpu")
        r = Request(0, prompt, max_new_tokens=4)
        b.submit(r)
        b.run_until_drained()
        return r.generated

    solo_a, solo_b = run_alone(pa), run_alone(pb)
    b = model_batcher(cfg, params, batch_size=2, max_len=horizon,
                      device="cpu")
    ra, rb = Request(0, pa, 4), Request(1, pb, 4)
    b.submit(ra)
    b.submit(rb)
    b.run_until_drained()
    assert ra.generated == solo_a
    assert rb.generated == solo_b


def test_requests_reproduce_the_jax_launchers_prompts():
    """With one prompt length the port's requests are the JAX launcher's
    (`rng.integers(0, vocab, (4,))` per request); a range draws lengths."""
    cfg = tcb.get_config(ARCH).smoke()
    rng = np.random.default_rng(0)
    want = [rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
            for _ in range(3)]
    got = tserve.requests(cfg, 3, 8, (4, 4))
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.prompt, w)
    lens = [len(r.prompt) for r in tserve.requests(cfg, 20, 8, (5, 9))]
    assert min(lens) >= 5 and max(lens) <= 9 and len(set(lens)) > 1


def test_launch_serve_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "5", "--batch", "2", "--max-len", "32",
                 "--new-tokens", "3", "--prompt-len", "2:6"])
    out = capsys.readouterr().out
    assert out.startswith("continuous batching: ")
    assert '"finished": 5' in out and '"device": "cpu"' in out


def test_serve_runs_moe_on_cpu_and_refuses_a_missing_card(monkeypatch):
    """Without a card the launcher refuses every arch, MoE ones included
    (which it serves on the CPU when asked, with the expert-slot half's
    report)."""
    report = tserve.serve("arctic-480b", smoke=True, device="cpu",
                          num_requests=3, batch=2, max_len=16,
                          new_tokens=2)
    assert report["finished"] == 3
    slots = report["expert_slots"]
    assert slots["steps"] == tserve.SLOT_STEPS
    assert 0 < slots["fills"] <= slots["accesses"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in (ARCH, "arctic-480b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.serve(arch, smoke=True)


@pytest.mark.parametrize("slots,hit_bias", [(4, 0.0), (2, 4.0)])
def test_launch_serve_moe_matches_jax_launcher(monkeypatch, capsys, slots,
                                               hit_bias):
    """The launcher's two halves on arctic-480b-smoke against the JAX
    launcher's (`repro.launch.serve.main`) with its weights carried
    across: the batching report and the expert-slot stats (whose tenants
    draw from the generator after the prompts) are equal."""
    import json
    import sys

    from repro.launch import serve as jserve
    from repro.models import transformer as jt

    arch, argv = "arctic-480b", ["--requests", "3", "--batch", "2",
                                 "--max-len", "16", "--new-tokens", "2",
                                 "--slots", str(slots),
                                 "--hit-bias", str(hit_bias)]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke",
                                      *argv])
    jserve.main()
    lines = dict(line.split(": ", 1)
                 for line in capsys.readouterr().out.splitlines())
    want_batch = json.loads(lines["continuous batching"])
    want_slots = json.loads(lines["expert slots"])

    jp = jt.init_params(jcb.get_config(arch).smoke(), jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    monkeypatch.setattr(tserve.transformer, "init_params",
                        lambda cfg, gen, dev: tp)
    got = tserve.serve(arch, smoke=True, device="cpu", num_requests=3,
                       batch=2, max_len=16, new_tokens=2, slots=slots,
                       hit_bias=hit_bias)
    assert {k: got[k] for k in want_batch} == want_batch
    assert {k: got["expert_slots"][k] for k in want_slots} == want_slots
    assert want_slots["fills"] > 0


REC_ARCHS = ["recurrentgemma-9b", "rwkv6-7b"]


def _perturbed(tree, seed=100):
    """numpy_params with every zero leaf (norms, gate parameters) drawn."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a if a.any() else
        (0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recurrent_generated_tokens_equal_jax(arch):
    """The recurrent archs' caches (window ring, RG-LRU and WKV states)
    through the batcher's row writes: ragged prompts (one of two windows
    of recurrentgemma's 32), more requests than rows, decoding past the
    window; each request's tokens equal the JAX batcher's."""
    jcfg, tcfg = jcb.get_config(arch).smoke(), tcb.get_config(arch).smoke()
    tree = _perturbed(convert.numpy_params(tcfg, 0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, (t,)).astype(np.int32)
               for t in (5, 30, 64, 17, 1)]
    jb = jax_batcher(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                     batch_size=2, max_len=96)
    tb = model_batcher(tcfg, convert.params_from_numpy(tree, "cpu"),
                       batch_size=2, max_len=96, device="cpu")
    jreqs = [JRequest(i, p, max_new_tokens=12) for i, p in enumerate(prompts)]
    treqs = [Request(i, p, max_new_tokens=12) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jb.submit(jr)
        tb.submit(tr)
    jrep, trep = jb.run_until_drained(), tb.run_until_drained()
    assert trep == jrep and trep["finished"] == 5
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, tr.rid


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_launch_serve_recurrent_matches_jax_launcher(monkeypatch, capsys,
                                                     arch):
    """The launcher on the recurrent smoke archs against the JAX
    launcher's (`repro.launch.serve.main`), its weights carried across,
    decoding past recurrentgemma's window: the batching reports are
    equal."""
    import json
    import sys

    from repro.launch import serve as jserve
    from repro.models import transformer as jt

    argv = ["--requests", "3", "--batch", "2", "--max-len", "48",
            "--new-tokens", "36"]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke",
                                      *argv])
    jserve.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = json.loads(line.split(": ", 1)[1])
    jp = jt.init_params(jcb.get_config(arch).smoke(), jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    monkeypatch.setattr(tserve.transformer, "init_params",
                        lambda cfg, gen, dev: tp)
    got = tserve.serve(arch, smoke=True, device="cpu", num_requests=3,
                       batch=2, max_len=48, new_tokens=36)
    assert {k: got[k] for k in want} == want
    assert want["finished"] == 3
