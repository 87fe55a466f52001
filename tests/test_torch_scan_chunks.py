"""The chunk algebra of the port's two scan kernels, on the CPU: the plain
models of the kernels' blocking (`rwkv6_scan_chunked_plain`: sub-chunks of
16 tokens in state-passing form, decay factors multiplied up inside a
sub-chunk; `rglru_scan_chunked_plain`: per-chunk aggregates, the carry
across chunks, the rescan of each chunk from its true start) held, on the
same numpy-seeded inputs in f32, against

* the JAX package's Pallas kernels in interpret mode (`repro.kernels.ops`,
  zero start), where T is short enough to run them here;
* the JAX models' own scans (`repro.models.rwkv6.recurrence_scan` and
  `recurrence_chunked`; `repro.models.rglru.rglru_scan` / `rglru_step`),
  from the given state;
* the port's sequential plain versions (`rwkv6_scan_plain`,
  `rglru_scan_plain`),

at ragged T (1, 7, 37, 100, 777; 1 and 7 below one sub-chunk), from a zero
and a given state, and at strong decay (logw down to -20 a step; lam 6
with r near 1), where factoring the decay across a whole chunk would give
inf or NaN.  Tolerances are test_kernels.py's: 5e-4 (WKV) and 2e-5
(RG-LRU).  The JAX chunked forms run with a chunk that divides T, at most
16 (their decays are exponentials of cumsum differences, which lose f32
precision at strong decay over longer chunks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.kernels import ops
from repro.models import rglru as jrg
from repro.models import rwkv6 as jrw
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as trw

jax.config.update("jax_default_matmul_precision", "float32")

WKV_TOL = 5e-4        # test_kernels.py's
RGLRU_TOL = 2e-5
PALLAS_MAX_T = 100    # interpret mode beyond this is slow on the CPU

# (T, given state, strong decay)
CASES = [(1, False, False), (1, True, False), (7, True, False),
         (37, False, False), (37, True, False), (100, True, False),
         (777, True, False), (7, True, True), (37, False, True),
         (100, True, True)]
IDS = [f"T{t}-{'s0' if s else 'zero'}-{'strong' if d else 'normal'}"
       for t, s, d in CASES]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _chunk(t: int) -> int:
    """The largest chunk of at most 16 that divides t."""
    return max(c for c in range(1, 17) if t % c == 0)


def _wkv_inputs(t, start, strong, seed, b=2, h=2, n=16):
    """test_kernels.py's distributions (r, k, v ~ N(0, 1), logw =
    -exp(N(0, 0.25)), u ~ N(0, 0.01)), or logw ~ U(-20, 0) at strong
    decay; S0 ~ N(0, 1) or zero."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)).astype(np.float32)
               for _ in range(3))
    if strong:
        logw = (-20.0 * rng.random((b, t, h, n))).astype(np.float32)
    else:
        logw = -np.exp(0.5 * rng.standard_normal((b, t, h, n))).astype(
            np.float32)
    u = (0.1 * rng.standard_normal((h, n))).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, n)) if start
          else np.zeros((b, h, n, n))).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("t,start,strong", CASES, ids=IDS)
def test_rwkv6_chunked_plain_matches_jax_and_sequential(t, start, strong):
    args = _wkv_inputs(t, start, strong, seed=t + 2 * start + 4 * strong)
    targs = [torch.from_numpy(a) for a in args]
    o, s_t = trw.rwkv6_scan_chunked_plain(*targs[:5],
                                          targs[5] if start else None)
    assert torch.isfinite(o).all() and torch.isfinite(s_t).all()
    assert o.shape == targs[0].shape and s_t.shape == targs[5].shape
    # the port's sequential plain version
    want_o, want_s = trw.rwkv6_scan_plain(*targs[:5], targs[5])
    _close(o, want_o, WKV_TOL)
    _close(s_t, want_s, WKV_TOL)
    # the JAX model's per-token scan and its chunked form
    jargs = [jnp.asarray(a) for a in args]
    for fn in (jrw.recurrence_scan,
               lambda *a: jrw.recurrence_chunked(*a, chunk=_chunk(t))):
        jo, js = fn(*jargs)
        _close(o, jo, WKV_TOL)
        _close(s_t, js, WKV_TOL)
    # the Pallas kernel (zero start, o only)
    if not start and t <= PALLAS_MAX_T:
        _close(o, ops.rwkv6_scan(*jargs[:5], chunk=_chunk(t)), WKV_TOL)


def test_rwkv6_chunked_plain_at_other_sub_chunks():
    """The algebra does not depend on the sub-chunk's length: 8 and 32
    give what 16 gives, within the tolerance."""
    args = _wkv_inputs(77, True, False, seed=5)
    targs = [torch.from_numpy(a) for a in args]
    want_o, want_s = trw.rwkv6_scan_plain(*targs)
    for lc in (8, 32):
        o, s_t = trw.rwkv6_scan_chunked_plain(*targs, sub_chunk=lc)
        _close(o, want_o, WKV_TOL)
        _close(s_t, want_s, WKV_TOL)


def _rglru_inputs(t, start, strong, seed, b=2, w=64):
    """test_kernels.py's gate parameters (N(0, 0.1^2), lam on [2, 6]), or
    at strong decay lam 6 and b_r + 8 (r near 1, a ~ exp(-48)); u ~ N(0,
    1); h0 ~ N(0, 1) or zero."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, t, w)).astype(np.float32)
    p = {k: (0.1 * rng.standard_normal(w)).astype(np.float32)
         for k in ("w_r", "b_r", "w_i", "b_i")}
    p["lam"] = np.linspace(2.0, 6.0, w, dtype=np.float32)
    if strong:
        p["b_r"] = p["b_r"] + np.float32(8.0)
        p["lam"] = np.full(w, 6.0, np.float32)
    h0 = (rng.standard_normal((b, w)) if start
          else np.zeros((b, w))).astype(np.float32)
    return u, p, h0


NAMES = ("w_r", "b_r", "w_i", "b_i", "lam")


@pytest.mark.parametrize("chunk", [16, trg.CHUNK])
@pytest.mark.parametrize("t,start,strong", CASES, ids=IDS)
def test_rglru_chunked_plain_matches_jax_and_sequential(t, start, strong,
                                                        chunk):
    u, p, h0 = _rglru_inputs(t, start, strong, seed=t + 2 * start +
                             4 * strong)
    params = [torch.from_numpy(p[k]) for k in NAMES]
    tu, th0 = torch.from_numpy(u), torch.from_numpy(h0)
    h, last = trg.rglru_scan_chunked_plain(tu, *params,
                                           th0 if start else None,
                                           chunk=chunk)
    assert torch.isfinite(h).all() and torch.isfinite(last).all()
    assert h.shape == tu.shape and last.shape == th0.shape
    want_h, want_last = trg.rglru_scan_plain(tu, *params, th0)
    _close(h, want_h, RGLRU_TOL)
    _close(last, want_last, RGLRU_TOL)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    fn = jrg.rglru_step if t == 1 else jrg.rglru_scan
    jh, jlast = fn(jp, jnp.asarray(u), jnp.asarray(h0))
    _close(h, jh, RGLRU_TOL)
    _close(last, jlast, RGLRU_TOL)
    if not start and t <= PALLAS_MAX_T:
        pallas = ops.rglru_scan(jnp.asarray(u), *(jp[k] for k in NAMES),
                                chunk=_chunk(t), block_w=u.shape[2])
        _close(h, pallas, RGLRU_TOL)
