"""The port's model layers (`repro_torch.models.layers`) against the JAX
package's (`repro.models.layers`) on the same numpy inputs, in f32:
rmsnorm, RoPE, M-RoPE, the three MLPs, `qkv` with bias, and the flash
attention block scan with every mask it takes.  Tolerance 2e-5 (f32
rounding of different summation orders and transcendental
implementations)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.models import layers as jl
from repro_torch.configs import base as tcb
from repro_torch.models import layers as tl

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

TOL = 2e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jcb.get_config(arch).smoke(), **kw),
            dataclasses.replace(tcb.get_config(arch).smoke(), **kw))


def test_rmsnorm():
    x, s = _arrays(0, (2, 5, 64), (64,))
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(s)))


def test_rmsnorm_keeps_bf16_with_f32_statistics():
    x, s = _arrays(1, (3, 64), (64,))
    got = tl.rmsnorm(torch.from_numpy(x).to(torch.bfloat16),
                     torch.from_numpy(s))
    want = jl.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s))
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


def test_rope_freqs_are_the_references():
    np.testing.assert_array_equal(tl.rope_freqs(64, 1e4),
                                  jl.rope_freqs(64, 1e4))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    (x,) = _arrays(2, (2, 7, 4, 16))
    pos = np.arange(100, 107, dtype=np.int32)[None].repeat(2, 0)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-4)


def test_apply_mrope():
    (x,) = _arrays(3, (2, 6, 4, 16))
    rng = np.random.default_rng(3)
    pos3 = rng.integers(0, 50, (2, 6, 3)).astype(np.int32)
    _close(tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e4,
                          (2, 3, 3)),
           jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4, (2, 3, 3)),
           1e-4)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu_glu", "gelu"])
def test_apply_mlp(mlp):
    jcfg, tcfg = _cfgs("granite-3-2b", mlp=mlp)
    x, wi, wg, wo = _arrays(4, (2, 5, 64), (64, 128), (64, 128), (128, 64))
    p = {"wi": wi, "wo": wo}
    if mlp != "gelu":
        p["wg"] = wg
    _close(tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg),
           jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jcfg), 1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-7b"])
def test_qkv_with_bias(arch):
    """qwen1.5 (RoPE) and qwen2-vl (M-RoPE) both carry q/k/v biases."""
    jcfg, tcfg = _cfgs(arch)
    d, h, kh, dh = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, \
        tcfg.head_dim
    names = ("wq", "wk", "wv", "bq", "bk", "bv")
    shapes = [(d, h * dh), (d, kh * dh), (d, kh * dh), (h * dh,),
              (kh * dh,), (kh * dh,)]
    p = dict(zip(names, _arrays(5, *shapes)))
    (x,) = _arrays(6, (2, 9, d))
    if tcfg.pos == "mrope":
        pos = np.random.default_rng(6).integers(0, 30, (2, 9, 3))
    else:
        pos = np.arange(9)[None].repeat(2, 0)
    pos = pos.astype(np.int32)
    got = tl.qkv({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    want = jl.qkv({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), jcfg, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("tq,tk,h,kh,dh,causal,window,block", [
    (16, 16, 4, 2, 8, True, 0, 8),
    (8, 24, 4, 4, 16, False, 0, 8),
    (32, 32, 2, 1, 8, True, 12, 8),
    (13, 29, 4, 2, 16, True, 0, 8),     # q_offset 16, ragged last block
    (20, 20, 4, 2, 16, True, 0, 512),   # one block longer than the keys
])
def test_flash_attention_block_scan(tq, tk, h, kh, dh, causal, window,
                                    block):
    q, k, v = _arrays(7, (2, tq, h, dh), (2, tk, kh, dh), (2, tk, kh, dh))
    kw = dict(causal=causal, window=window, block=block, q_offset=tk - tq)
    _close(tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw),
           jl.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))
    ref_kw = dict(causal=causal, window=window, q_offset=tk - tq)
    _close(tl.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **ref_kw),
           jl.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **ref_kw))


def test_flash_attention_kv_len_and_kv_start():
    """The masks of cache-tail decode and of the two-chunk window trick."""
    q, k, v = _arrays(8, (3, 16, 4, 16), (3, 32, 2, 16), (3, 32, 2, 16))
    kv_len = np.array([32, 20, 17], np.int32)
    kv_start = np.array([0, 16, 4], np.int32)
    kw = dict(causal=True, window=16, block=8, q_offset=16)
    _close(tl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              kv_len=torch.from_numpy(kv_len),
                              kv_start=torch.from_numpy(kv_start), **kw),
           jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_len=jnp.asarray(kv_len),
                              kv_start=jnp.asarray(kv_start), **kw))


def test_flash_attention_bf16_scales_in_the_input_dtype():
    """The block scan rounds q * dh^-0.5 in q's dtype before going to f32,
    as the JAX package's does (the kernels scale in f32)."""
    q, k, v = _arrays(9, (1, 24, 4, 128), (1, 24, 2, 128), (1, 24, 2, 128))
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tl.flash_attention(tb(q), tb(k), tb(v), block=8)
    want = jl.flash_attention(bf(q), bf(k), bf(v), block=8)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)
