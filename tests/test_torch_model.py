"""The port's decoder (`repro_torch.models.transformer`) against the JAX
package's (`repro.models.transformer`) for every arch of the zoo at smoke
size, in f32: the same numpy weights (`convert.numpy_params`, with the
norm scales, biases and zero gate parameters perturbed so they count)
and inputs into both; prefill logits, the prefill cache (K/V, window
ring, recurrent states) and 8 teacher-forced decode steps (logits and
cache) agree to 1e-4 (f32 rounding of different summation orders over 2
or 3 layers), and every MoE layer's `expert_load` equals JAX's exactly.
recurrentgemma's prompts include one of two windows (the JAX model's
two-chunk path) and decode steps past the window.  Plus the port's own
golden check: prefill then decode reproduces the full-sequence logits,
as test_models.py holds the JAX package to (the MoE smoke configs'
capacity factor of 8 drops no token, so the two capacities agree)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
from repro.configs import base as jcb
from repro.models import transformer as jt
from repro_torch.configs import base as tcb
from repro_torch.models import convert
from repro_torch.models import transformer as tt

jax.config.update("jax_default_matmul_precision", "float32")
jcb.load_all()
tcb.load_all()

ATTN_ARCHS = ["granite-3-2b", "qwen1.5-4b", "qwen1.5-110b", "minitron-4b",
              "musicgen-medium", "qwen2-vl-7b"]
MOE_ARCHS = ["arctic-480b", "llama4-maverick-400b-a17b"]
REC_ARCHS = ["recurrentgemma-9b", "rwkv6-7b"]
TOL = 1e-4
B, T0, STEPS = 2, 9, 8


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tree(cfg, seed=0):
    """numpy_params with every zero leaf (norm scales, biases) perturbed."""
    rng = np.random.default_rng(seed + 100)

    def bump(a):
        return a if a.any() else \
            (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(bump, convert.numpy_params(cfg, seed))


def _both(arch):
    jcfg, tcfg = jcb.get_config(arch).smoke(), tcb.get_config(arch).smoke()
    tree = _tree(tcfg)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            tcfg, convert.params_from_numpy(tree, "cpu"))


def _batch(cfg, b, t, seed=1, text_positions=False):
    """Random inputs; M-RoPE positions get a random offset per stream,
    unless `text_positions` (t = h = w, what a decode step feeds)."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    else:
        batch["embeds"] = rng.standard_normal((b, t, cfg.d_model)).astype(
            np.float32)
    if cfg.pos == "mrope":
        pos = np.arange(t)[None, :, None] + rng.integers(0, 3, (b, 1, 3)) * \
            (not text_positions)
        batch["positions"] = pos.astype(np.int32)
    return batch


def _step(cfg, batch, i):
    """Decode-step inputs for position i of `batch`."""
    b = (batch.get("tokens", batch.get("embeds"))).shape[0]
    db = {"positions": np.full((b,), i, np.int32)}
    key = "tokens" if cfg.embed_inputs else "embeds"
    db[key] = batch[key][:, i:i + 1]
    return db


def _full(cfg):
    """Per segment, per block: does its cache grow with the context (K/V
    of global attention)?  Window rings and recurrent states do not."""
    return [[t in ("attn", "moe") for t in types]
            for types, _ in tt.segments(cfg)]


def _pad_jax(cfg, cache, length):
    return [[{n: jnp.pad(c[n], ((0, 0), (0, 0), (0, length - c[n].shape[2]),
                                (0, 0), (0, 0))) for n in c} if grow else c
             for c, grow in zip(seg, fseg)]
            for seg, fseg in zip(cache, _full(cfg))]


def _pad_torch(cfg, cache, length):
    return [[{n: torch.nn.functional.pad(
        c[n], (0, 0, 0, 0, 0, length - c[n].shape[2])) for n in c}
        if grow else c for c, grow in zip(seg, fseg)]
        for seg, fseg in zip(cache, _full(cfg))]


def _cache_close(tcache, jcache):
    for tseg, jseg in zip(tcache, jcache, strict=True):
        for tc, jc in zip(tseg, jseg, strict=True):
            assert set(tc) == set(jc)
            for n in tc:
                assert str(tc[n].dtype).split(".")[-1] == str(jc[n].dtype)
                _close(tc[n], jc[n])


def _aux_equal(taux, jaux):
    """Per segment and block: {} or {"expert_load": (n, E) int32}, equal."""
    for tseg, jseg in zip(taux, jaux, strict=True):
        for ta, ja in zip(tseg, jseg, strict=True):
            assert set(ta) == set(ja)
            for k in ta:
                assert ta[k].dtype == torch.int32
                np.testing.assert_array_equal(ta[k].numpy(),
                                              np.asarray(ja[k]))


@pytest.mark.parametrize("arch", ATTN_ARCHS + MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, jp, tcfg, tp = _both(arch)
    batch = _batch(tcfg, B, T0 + STEPS)
    pre = {k: v[:, :T0] for k, v in batch.items()}
    jl, jcache, jaux = jt.prefill(jcfg, jp, jax.tree_util.tree_map(
        jnp.asarray, pre))
    tl, tcache, taux = tt.prefill(tcfg, tp, pre)
    assert tl.shape == (B, 1, tcfg.vocab)
    _close(tl, jl)
    _cache_close(tcache, jcache)
    _aux_equal(taux, jaux)

    jcache = _pad_jax(jcfg, jcache, T0 + STEPS)
    tcache = _pad_torch(tcfg, tcache, T0 + STEPS)
    for i in range(T0, T0 + STEPS):
        db = _step(tcfg, batch, i)
        jl, jcache, jaux = jt.decode_step(
            jcfg, jp, jax.tree_util.tree_map(jnp.asarray, db), jcache)
        tl, tcache, taux = tt.decode_step(tcfg, tp, db, tcache)
        _close(tl, jl)
        _aux_equal(taux, jaux)
    _cache_close(tcache, jcache)


def test_moe_decode_takes_the_router_bias():
    """A decode step's `router_bias` reaches every MoE layer's router, as
    in the JAX package: loads and logits equal JAX's with the bias."""
    jcfg, jp, tcfg, tp = _both("arctic-480b")
    batch = _batch(tcfg, B, T0 + 1)
    _, jcache, _ = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(
        batch["tokens"][:, :T0])})
    _, tcache, _ = tt.prefill(tcfg, tp, {"tokens": batch["tokens"][:, :T0]})
    jcache = _pad_jax(jcfg, jcache, T0 + 1)
    tcache = _pad_torch(tcfg, tcache, T0 + 1)
    bias = np.full((tcfg.num_experts,), -6.0, np.float32)
    bias[[2, 5]] = 6.0
    db = dict(_step(tcfg, batch, T0), router_bias=bias)
    jl, _, jaux = jt.decode_step(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, db), jcache)
    tl, _, taux = tt.decode_step(tcfg, tp, db, tcache)
    _close(tl, jl)
    _aux_equal(taux, jaux)
    load = taux[0][0]["expert_load"]
    assert load[:, [2, 5]].sum() == load.sum() == 2 * B * tcfg.top_k


def test_jax_cache_carries_across():
    """Decoding from the JAX package's prefill cache, carried over with
    `cache_from_numpy`, gives the JAX package's decode logits."""
    jcfg, jp, tcfg, tp = _both("granite-3-2b")
    batch = _batch(tcfg, B, T0 + 1)
    _, jcache, _ = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(
        batch["tokens"][:, :T0])})
    jcache = _pad_jax(jcfg, jcache, T0 + 1)
    tcache = convert.cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    db = _step(tcfg, batch, T0)
    jl, jcache, _ = jt.decode_step(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, db), jcache)
    tl, tcache, _ = tt.decode_step(tcfg, tp, db, tcache)
    _close(tl, jl)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", ATTN_ARCHS + MOE_ARCHS + REC_ARCHS)
def test_prefill_decode_golden_consistency(arch):
    """Teacher-forced decode reproduces the full-sequence logits (the
    check test_models.py holds the JAX package to, at its 2e-3)."""
    cfg = tcb.get_config(arch).smoke()
    params = tt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    b, t = 2, 16
    batch = _batch(cfg, b, t, text_positions=True)
    x, _, _, ctx = tt.forward(cfg, params, batch)
    full = tt._logits(cfg, params, x, ctx)
    t0 = t // 2
    logits0, cache, _ = tt.prefill(
        cfg, params, {k: v[:, :t0] for k, v in batch.items()})
    _close(logits0[:, 0], full[:, t0 - 1], 2e-3)
    cache = _pad_torch(cfg, cache, t)
    for i in range(t0, t):
        logits, cache, _ = tt.decode_step(cfg, params, _step(cfg, batch, i),
                                          cache)
        _close(logits[:, 0], full[:, i], 2e-3)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen1.5-4b",
                                  "musicgen-medium", "arctic-480b",
                                  "llama4-maverick-400b-a17b"] + REC_ARCHS)
def test_init_params_tree_matches_jax(arch):
    """Same nesting, leaf shapes and dtypes as the JAX package's
    init_params, both from init_params and from numpy_params (a moe
    block's router, the RG-LRU gate parameters and RWKV6's mixes, decay
    bias, bonus and head norm stay float32 in a bf16 model)."""
    jcfg = dataclasses.replace(jcb.get_config(arch).smoke(),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(tcb.get_config(arch).smoke(),
                               dtype="bfloat16")
    want = jt.init_params(jcfg, jax.random.PRNGKey(0))
    got = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    loaded = convert.params_from_numpy(convert.numpy_params(tcfg, 0), "cpu",
                                       tcfg.torch_dtype)
    jshape = _shapes(jax.tree_util.tree_map(np.asarray, want))
    for tree in (got, loaded):
        tshape = tt.tree_map(lambda a: tuple(a.shape), tree)
        assert jax.tree_util.tree_structure(tshape) == \
            jax.tree_util.tree_structure(jshape)
        assert tshape == jshape
        jdt = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda a: str(a.dtype), want))
        tdt = jax.tree_util.tree_leaves(
            tt.tree_map(lambda a: str(a.dtype).split(".")[-1], tree))
        assert tdt == jdt


def test_jax_bf16_params_carry_across_exactly():
    cfg = jcb.get_config("granite-3-2b").smoke()
    jp = jt.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                        jax.random.PRNGKey(3))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    for j, t in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(
                        tt.tree_map(lambda a: a, tp))):
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                           else torch.float32)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


def test_decoder_module_holds_the_tree():
    cfg = tcb.get_config("granite-3-2b").smoke()
    params = tt.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    model = tt.DecoderLM(cfg, params)
    names = dict(model.named_parameters())
    assert "tree.segments.0.0.attn.wq" in names
    assert len(names) == len(jax.tree_util.tree_leaves(
        tt.tree_map(lambda a: 0, params)))
    batch = _batch(cfg, 2, 6)
    x, _, _, ctx = tt.forward(cfg, params, batch)
    assert torch.equal(model(batch), tt._logits(cfg, params, x, ctx))
    got, _, _ = model.prefill(batch)
    want, _, _ = tt.prefill(cfg, params, batch)
    assert torch.equal(got, want)


def test_later_blocks_and_sharding_raise():
    """Every registered arch's smoke config initialises (parameters and
    a decode cache: every block type is ported) and an unknown block type
    raises ValueError; a sharding context and a forced kernel on CPU
    tensors still raise."""
    for arch in tcb.list_configs():
        cfg = tcb.get_config(arch).smoke()
        params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        cache = tt.init_cache(cfg, 2, 8, "cpu")
        assert len(params["segments"]) == len(cache) == \
            len(tt.segments(cfg))
    with pytest.raises(ValueError, match="conv"):
        tt._init_block("conv", torch.Generator(), cfg, "cpu")
    with pytest.raises(ValueError, match="conv"):
        tt.init_cache(dataclasses.replace(
            tcb.get_config("recurrentgemma-9b").smoke(),
            pattern=("rec", "conv")), 1, 8, "cpu")
    cfg = tcb.get_config("granite-3-2b").smoke()
    params = tt.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(TypeError, match="ShardingPlan"):
        tt.prefill(cfg, params, _batch(cfg, 1, 4), shd=object())
    # shd=None is the single-device path, unchanged
    got = tt.prefill(cfg, params, _batch(cfg, 1, 4), shd=None)[0]
    assert torch.equal(got, tt.prefill(cfg, params, _batch(cfg, 1, 4))[0])
    with pytest.raises(ValueError, match="CUDA"):
        tt.prefill(cfg, params, _batch(cfg, 1, 4), use_kernel="kernel")


@pytest.mark.parametrize("arch,t0", [
    ("recurrentgemma-9b", 9), ("recurrentgemma-9b", 28),
    ("recurrentgemma-9b", 64), ("rwkv6-7b", 9), ("rwkv6-7b", 64)])
def test_recurrent_prefill_and_decode_match_jax(arch, t0):
    """Prefill logits, cache and states, then 8 decode steps (logits,
    ring and states) against JAX.  recurrentgemma (window 32): a short
    prompt, one whose decode crosses the window (28..35), and a 64-token
    prompt (two windows: JAX's two-chunk path, the port's one windowed
    call), decoding at 64..71 around the ring; rwkv6: JAX's per-token
    scan (9) and its chunked form (64) at prefill."""
    jcfg, jp, tcfg, tp = _both(arch)
    batch = _batch(tcfg, B, t0 + STEPS)
    pre = {k: v[:, :t0] for k, v in batch.items()}
    jl, jcache, _ = jt.prefill(jcfg, jp, jax.tree_util.tree_map(
        jnp.asarray, pre))
    tl, tcache, _ = tt.prefill(tcfg, tp, pre)
    _close(tl, jl)
    _cache_close(tcache, jcache)
    for i in range(t0, t0 + STEPS):
        db = _step(tcfg, batch, i)
        jl, jcache, _ = jt.decode_step(
            jcfg, jp, jax.tree_util.tree_map(jnp.asarray, db), jcache)
        tl, tcache, _ = tt.decode_step(tcfg, tp, db, tcache)
        _close(tl, jl)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_jax_recurrent_cache_carries_across(arch):
    """Decoding from the JAX package's prefill cache (window ring and
    recurrent states), carried over with `cache_from_numpy`, gives the
    JAX package's decode logits; with a working dtype the states stay
    float32."""
    jcfg, jp, tcfg, tp = _both(arch)
    batch = _batch(tcfg, B, T0 + 1)
    _, jcache, _ = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(
        batch["tokens"][:, :T0])})
    numpy_cache = jax.tree_util.tree_map(np.asarray, jcache)
    tcache = convert.cache_from_numpy(numpy_cache, "cpu")
    db = _step(tcfg, batch, T0)
    jl, jcache, _ = jt.decode_step(
        jcfg, jp, jax.tree_util.tree_map(jnp.asarray, db), jcache)
    tl, tcache, _ = tt.decode_step(tcfg, tp, db, tcache)
    _close(tl, jl)
    _cache_close(tcache, jcache)
    half = convert.cache_from_numpy(numpy_cache, "cpu", torch.bfloat16)
    for seg in half:
        for c in seg:
            for n, a in c.items():
                assert a.dtype == (torch.bfloat16 if n in ("k", "v")
                                   else torch.float32), n
