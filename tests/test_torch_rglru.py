"""The port's RecurrentGemma pieces against the JAX package's, on the same
numpy inputs:

* the plain RG-LRU scan (`repro_torch.kernels.rglru_scan`) against the
  Pallas kernel in interpret mode (`ops.rglru_scan`) and
  `ref.rglru_scan_ref` at test_kernels.py's shapes and tolerance (2e-5),
  and, from a non-zero h0, against the JAX model's own scan
  (`repro.models.rglru.rglru_scan`: the chunked associative scan);
* the recurrent block (`rec_block`) at decode (T = 1), ragged and chunked
  T, with its state carried in, in f32 within 1e-4;
* the causal conv in bf16, bit for bit (its taps summed in JAX's order);
* local attention: the port's one windowed call against the JAX model's
  `_local_attention` (one call at T <= window, the two-chunk trick at T =
  2 window), and the circular window cache's decode across the wrap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.kernels import ops, ref
from repro.models import kvcache as jkv
from repro.models import rglru as jrg
from repro.models import transformer as jt
from repro_torch.configs import base as tcb
from repro_torch.kernels import rglru_scan as trs
from repro_torch.models import kvcache as tkv
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as tt

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

SCAN_TOL = 2e-5       # test_kernels.py's
TOL = 1e-4            # a block: f32 products in another summation order
ARCH = "recurrentgemma-9b"


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _gate_params(rng, w):
    """test_kernels.py's gate parameters: N(0, 0.1^2), lam on [2, 6]."""
    p = {k: (0.1 * rng.standard_normal(w)).astype(np.float32)
         for k in ("w_r", "b_r", "w_i", "b_i")}
    p["lam"] = np.linspace(2.0, 6.0, w, dtype=np.float32)
    return p


def _scan_args(p, names=("w_r", "b_r", "w_i", "b_i", "lam")):
    return ([jnp.asarray(p[k]) for k in names],
            [torch.from_numpy(p[k]) for k in names])


@pytest.mark.parametrize("b,t,w,chunk,block_w", [
    (2, 128, 128, 64, 128), (1, 256, 256, 128, 128),
    (2, 64, 512, 32, 256)])
def test_plain_scan_matches_pallas_and_ref(b, t, w, chunk, block_w):
    rng = np.random.default_rng(t + w)
    u = rng.standard_normal((b, t, w)).astype(np.float32)
    jargs, targs = _scan_args(_gate_params(rng, w))
    got, last = trs.rglru_scan(torch.from_numpy(u), *targs)
    assert got.dtype == last.dtype == torch.float32
    pallas = ops.rglru_scan(jnp.asarray(u), *jargs, chunk=chunk,
                            block_w=block_w)
    _close(got, pallas, SCAN_TOL)
    _close(got, ref.rglru_scan_ref(jnp.asarray(u), *jargs), SCAN_TOL)
    assert torch.equal(last, got[:, -1])


@pytest.mark.parametrize("t", [1, 37, 512, 1024])
def test_plain_scan_from_h0_matches_the_models_scan(t):
    """From a non-zero h0, the whole sequence and the last state, against
    `rglru.rglru_scan` (single associative scan below 512 steps or off
    its multiple, the chunked one at 1024) and `rglru_step` at T = 1."""
    rng = np.random.default_rng(t)
    b, w = 2, 64
    u = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    p = _gate_params(rng, w)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, targs = _scan_args(p)
    got, last = trs.rglru_scan(torch.from_numpy(u), *targs,
                               torch.from_numpy(h0))
    fn = jrg.rglru_step if t == 1 else jrg.rglru_scan
    want, want_last = fn(jp, jnp.asarray(u), jnp.asarray(h0))
    _close(got, want, SCAN_TOL)
    _close(last, want_last, SCAN_TOL)


def test_plain_scan_reads_bf16_u():
    """bf16 u is widened exactly: the scan equals the f32 scan of the same
    (rounded) values."""
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((2, 20, 32)).astype(
        np.float32)).bfloat16()
    _, targs = _scan_args(_gate_params(rng, 32))
    got, last = trs.rglru_scan(u, *targs)
    want, want_last = trs.rglru_scan(u.float(), *targs)
    assert torch.equal(got, want) and torch.equal(last, want_last)


def _rec_params(rng, cfg):
    d, w = cfg.d_model, cfg.lru_width
    p = {"wx": rng.standard_normal((d, w)) * d ** -0.5,
         "wgate": rng.standard_normal((d, w)) * d ** -0.5,
         "wout": rng.standard_normal((w, d)) * w ** -0.5,
         "conv": rng.standard_normal((cfg.conv_width, w)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p.update(_gate_params(rng, w))
    return p


@pytest.mark.parametrize("t", [1, 13, 64, 1024])
def test_rec_block_matches_jax(t):
    """The block from a carried state (h, conv) at decode (T = 1), ragged
    and 64-step T (JAX's single associative scan) and T = 1024 (JAX's
    chunked scan): output and new state."""
    cfg = tcb.get_config(ARCH).smoke()
    rng = np.random.default_rng(t + 1)
    p = _rec_params(rng, cfg)
    b, d, w = 2, cfg.d_model, cfg.lru_width
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    state = {"h": rng.standard_normal((b, w)).astype(np.float32),
             "conv": rng.standard_normal(
                 (b, cfg.conv_width - 1, w)).astype(np.float32)}
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    tor = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    want, want_state = jrg.rec_block(j(p), jnp.asarray(x), j(state), cfg)
    got, got_state = trg.rec_block(tor(p), torch.from_numpy(x), tor(state),
                                   cfg)
    _close(got, want, TOL)
    for k in ("h", "conv"):
        assert got_state[k].dtype == torch.float32
        _close(got_state[k], want_state[k], TOL)


def test_conv_sums_taps_in_jax_order_in_bf16():
    rng = np.random.default_rng(9)
    u = rng.standard_normal((2, 11, 48)).astype(np.float32)
    kern = (rng.standard_normal((4, 48)) * 0.1).astype(np.float32)
    state = rng.standard_normal((2, 3, 48)).astype(np.float32)
    want, want_state = jrg._conv1d_causal(
        jnp.asarray(u, jnp.bfloat16), jnp.asarray(kern, jnp.bfloat16),
        jnp.asarray(state))
    got, got_state = trg._conv1d_causal(
        torch.from_numpy(u).bfloat16(), torch.from_numpy(kern).bfloat16(),
        torch.from_numpy(state))
    assert got.dtype == torch.bfloat16 and got_state.dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


@pytest.mark.parametrize("t,window", [(5, 32), (32, 32), (64, 32),
                                      (96, 32)])
def test_local_attention_matches_jax_two_chunk(t, window):
    """One causal windowed call over the whole sequence against the JAX
    model's local attention: a single call at T <= window, the two-chunk
    trick at T = 2 and 3 windows (GQA, 4 heads over 2)."""
    rng = np.random.default_rng(t)
    q = rng.standard_normal((2, t, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    want = jt._local_attention(*map(jnp.asarray, (q, k, v)), window)
    got = tt._local_attention(*map(torch.from_numpy, (q, k, v)), window)
    _close(got, want, 2e-5)


def test_local_attention_keeps_jaxs_precondition():
    q = torch.zeros((1, 40, 2, 16))
    with pytest.raises(ValueError, match="multiple of the window"):
        tt._local_attention(q, q, q, 32)


@pytest.mark.parametrize("t0", [5, 32, 64])
def test_prefill_window_cache_matches_jax(t0):
    """The prefill's window cache: padded to the window, or the last
    window tokens at their circular slots."""
    cfg = tcb.get_config(ARCH).smoke()
    rng = np.random.default_rng(t0)
    k = rng.standard_normal((2, t0, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t0, 2, 16)).astype(np.float32)
    want = jt._prefill_cache(cfg, jnp.asarray(k), jnp.asarray(v),
                             cfg.window)
    got = tt._prefill_cache(cfg, torch.from_numpy(k), torch.from_numpy(v),
                            cfg.window)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_window_decode_attention_across_the_wrap():
    """The ring's decode attention, step after step from position 27 to
    70 of a 32-slot window (rows at different positions), against the JAX
    package's: output and ring, in place."""
    cfg = tcb.get_config(ARCH).smoke()
    rng = np.random.default_rng(11)
    b, h, kh, dh, w = 2, 4, 2, 16, cfg.window
    ring = rng.standard_normal((b, w, kh, dh)).astype(np.float32)
    jcache = {"k": jnp.asarray(ring), "v": jnp.asarray(ring[::-1].copy())}
    tcache = {n: torch.from_numpy(np.array(a))
              for n, a in jcache.items()}
    for step in range(44):
        pos = np.array([27 + step, 3 + 2 * step], np.int32)
        q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
        kn = rng.standard_normal((b, 1, kh, dh)).astype(np.float32)
        vn = rng.standard_normal((b, 1, kh, dh)).astype(np.float32)
        want, jcache = jkv.window_decode_attention(
            jnp.asarray(q), jcache, jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(pos), cfg)
        got, out_cache = tkv.window_decode_attention(
            torch.from_numpy(q), tcache, torch.from_numpy(kn),
            torch.from_numpy(vn), torch.from_numpy(pos), cfg)
        assert out_cache["k"] is tcache["k"]
        _close(got, want, 2e-5)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tcache[n].numpy(),
                                      np.asarray(jcache[n]))
