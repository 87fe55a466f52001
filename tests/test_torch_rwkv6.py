"""The port's RWKV6 pieces against the JAX package's, on the same numpy
inputs:

* the plain WKV recurrence (`repro_torch.kernels.rwkv6_scan`) against the
  Pallas kernel in interpret mode (`ops.rwkv6_scan`) and
  `ref.rwkv6_scan_ref` at test_kernels.py's shapes and tolerance (5e-4),
  and, from a non-zero state, against the JAX model's
  `recurrence_scan` and `recurrence_chunked` (outputs and final state);
* `time_mix` from a carried state and shift, at decode (T = 1), at a
  ragged T (JAX's per-token scan) and at T = 64 and 128 (JAX's chunked
  form), and `channel_mix`, in f32 within 1e-4; `time_mix_inputs` in
  bf16 with the JAX package's casts; the head norm's population
  variance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.kernels import ops, ref
from repro.models import rwkv6 as jrw
from repro_torch.configs import base as tcb
from repro_torch.kernels import rwkv6_scan as trs
from repro_torch.models import convert
from repro_torch.models import rwkv6 as trw

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

SCAN_TOL = 5e-4       # test_kernels.py's
TOL = 1e-4            # a block: f32 products in another summation order
ARCH = "rwkv6-7b"


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _wkv_inputs(rng, b, t, h, n):
    """test_kernels.py's inputs: r, k, v ~ N(0, 1), logw = -exp(N(0,
    0.25)), u ~ N(0, 0.01)."""
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(0.5 * rng.standard_normal((b, t, h, n))).astype(
        np.float32)
    u = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("b,t,h,n,chunk", [
    (1, 128, 2, 32, 32), (2, 128, 1, 64, 64), (1, 64, 3, 16, 16)])
def test_plain_scan_matches_pallas_and_ref(b, t, h, n, chunk):
    args = _wkv_inputs(np.random.default_rng(t + n), b, t, h, n)
    got, state = trs.rwkv6_scan(*map(torch.from_numpy, args))
    assert got.dtype == state.dtype == torch.float32
    assert state.shape == (b, h, n, n)
    jargs = tuple(map(jnp.asarray, args))
    _close(got, ops.rwkv6_scan(*jargs, chunk=chunk), SCAN_TOL)
    _close(got, ref.rwkv6_scan_ref(*jargs), SCAN_TOL)


@pytest.mark.parametrize("t", [1, 29, 64])
def test_plain_scan_from_s0_matches_the_models_recurrences(t):
    """From a non-zero state: outputs and final state against
    `recurrence_scan`, and at T = 64 also against `recurrence_chunked`
    (the form the JAX model runs there)."""
    rng = np.random.default_rng(t)
    b, h, n = 2, 4, 16
    args = _wkv_inputs(rng, b, t, h, n)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    got, state = trs.rwkv6_scan(*map(torch.from_numpy, args),
                                torch.from_numpy(s0))
    jargs = tuple(map(jnp.asarray, args)) + (jnp.asarray(s0),)
    fns = [jrw.recurrence_scan] + ([jrw.recurrence_chunked] if t == 64
                                   else [])
    for fn in fns:
        want, want_state = fn(*jargs)
        _close(got, want, SCAN_TOL)
        _close(state, want_state, SCAN_TOL)


def test_plain_scan_reads_bf16_rkv():
    """bf16 r/k/v are widened exactly: the scan equals the f32 scan of the
    same (rounded) values."""
    r, k, v, logw, u = _wkv_inputs(np.random.default_rng(3), 1, 9, 2, 16)
    rkv = [torch.from_numpy(a).bfloat16() for a in (r, k, v)]
    lw, uu = torch.from_numpy(logw), torch.from_numpy(u)
    got = trs.rwkv6_scan(*rkv, lw, uu)
    want = trs.rwkv6_scan(*(a.float() for a in rkv), lw, uu)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _block(cfg, seed=0):
    """One rwkv layer of `numpy_params`, its zero leaves perturbed."""
    rng = np.random.default_rng(seed + 100)
    tree = convert.numpy_params(cfg, seed)["segments"][0][0]
    return {k: (v[0] if v.any() else 0.1 * rng.standard_normal(
        v.shape[1:])).astype(np.float32) for k, v in tree.items()}


@pytest.mark.parametrize("t", [1, 13, 64, 128])
def test_time_mix_matches_jax(t):
    """From a carried state and shift: output, last input and state, the
    JAX model taking its per-token scan at T = 1 and 13 and its chunked
    form at T = 64 and 128."""
    cfg = tcb.get_config(ARCH).smoke()
    p = _block(cfg)
    rng = np.random.default_rng(t)
    b, d, n = 2, cfg.d_model, cfg.head_dim
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    prev = rng.standard_normal((b, d)).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, d // n, n, n))).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = jrw.time_mix(jp, jnp.asarray(x), jnp.asarray(prev),
                        jnp.asarray(s0), cfg, use_chunked=t > 1)
    got = trw.time_mix(tp, torch.from_numpy(x), torch.from_numpy(prev),
                       torch.from_numpy(s0), cfg)
    for g, w in zip(got, want, strict=True):
        _close(g, w, TOL)


@pytest.mark.parametrize("t", [1, 13])
def test_channel_mix_matches_jax(t):
    cfg = tcb.get_config(ARCH).smoke()
    p = _block(cfg, 1)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = jrw.channel_mix({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(prev))
    got = trw.channel_mix({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), torch.from_numpy(prev))
    for g, w in zip(got, want, strict=True):
        _close(g, w, TOL)


def test_time_mix_inputs_cast_as_jax_in_bf16():
    """bf16 weights and input: r, k, v, g in bf16 and logw in f32, as the
    JAX package casts them; within a bf16 rounding of JAX's (its f32 LoRA
    input, bf16 mixed streams)."""
    cfg = tcb.get_config(ARCH).smoke()
    p = _block(cfg, 2)
    keep = {"mu", "w0", "u", "ln_o", "ln_o_b", "mu_cm"}
    jp = {k: jnp.asarray(v) if k in keep else
          jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) if k in keep else
          torch.from_numpy(v).bfloat16() for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = jrw.time_mix_inputs(jp, jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(prev, jnp.bfloat16), cfg)
    got = trw.time_mix_inputs(tp, torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(prev).bfloat16(), cfg)
    for g, w, dt in zip(got, want, ("bfloat16",) * 3 + ("float32",
                                                        "bfloat16")):
        assert str(g.dtype).split(".")[-1] == str(w.dtype) == dt
        _close(g, w, 2e-2)


def test_head_groupnorm_uses_the_population_variance():
    rng = np.random.default_rng(6)
    o = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal((4, 16)).astype(np.float32)
    want = jrw._head_groupnorm(*map(jnp.asarray, (o, scale, bias)))
    got = trw._head_groupnorm(*map(torch.from_numpy, (o, scale, bias)))
    _close(got, want, 1e-5)
