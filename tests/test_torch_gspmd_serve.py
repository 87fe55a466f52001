"""Serving under the reference's GSPMD layouts, one process a rank: one job
of 4 gloo ranks (`torch_gspmd_checks.run_ranks`) serves the smoke configs
of granite-3-2b (head-TP, FSDP), qwen1.5-4b (sequence-parallel) and
arctic-480b (sequence-parallel with experts and the dense residual,
FSDP) through `repro_torch.serve.step` on a (data 2, model 2) mesh,
while one JAX subprocess on 4 forced host devices runs the reference's
`repro.serve.step` under its plans (`jax_gspmd_reference.py`).  Every
rank's blocks are held

* within 1e-5 relative L2 (f32): `jit_prefill_step`'s logits and cache,
  `jit_decode_step`'s logits over 3 steps and the final cache; the
  expert loads equal;
* to the reference's specs (`repro.sharding.partition.ShardingPlan` on
  the mesh's shape): each weight leaf a rank holds has the shape of its
  block by `param_specs`, each tagged activation that of its block by
  `act_spec` fitted to its global shape, recorded by wrapping `act`;
* flash on head shards (granite: H/2 local heads) and on sequence
  shards (qwen, arctic: the second sequence block at `q_offset` T/2);

and `model_batcher` under a plan serves every request's tokens as the
one-rank batcher does.  `Mesh.reduce_scatter` sums over its axes.  The
plain flash takes the reference's `q_offset`."""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_asserts  # noqa: F401  (one torch thread under xdist)
import torch_gspmd_checks as chk
from repro.configs import base as jcb
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.sharding.partition import ShardingPlan as JPlan
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import mesh as tmesh

jax.config.update("jax_default_matmul_precision", "float32")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
TOL = 1e-5
FLASH_TOL = 2e-5
ARCHS = [a for a, _ in chk.ARCHS]
FSDP = dict(chk.ARCHS)


class FakeMesh:
    """The mesh's shape for the reference's plans (specs only)."""

    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)
        self.devices = np.empty((0,))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' outputs in rank order, the reference's arrays)."""
    dst = str(tmp_path_factory.mktemp("gspmd") / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_gspmd_reference.py"), dst],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = tmesh.spawn(chk.run_ranks, chk.RANKS, timeout=300.0)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, out + err
    return ranks, dict(np.load(dst))


def _jplan(arch, mode):
    jcb.load_all()
    return JPlan(FakeMesh(chk.MESH), jcb.get_config(arch).smoke(),
                 mode=mode, fsdp=FSDP[arch])


def _block(spec, shape, coords) -> tuple:
    """The slices of a rank's block of `shape` under `spec`, from the
    rank's mesh coordinates (row-major over a tuple of axes)."""
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        if e is None:
            out.append(slice(None))
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n = math.prod(chk.MESH[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * chk.MESH[a] + coords[a]
        out.append(slice(idx * dim // n, (idx + 1) * dim // n))
    return tuple(out)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold(ranks, get, want: np.ndarray, spec, what: str) -> None:
    """Every rank's block (`get(rank)`) within TOL of its block of `want`,
    and the blocks put together within TOL of `want`."""
    whole = np.full(want.shape, np.nan)
    for r in ranks:
        sl = _block(spec, want.shape, r["coords"])
        got = get(r).numpy()
        assert got.shape == want[sl].shape, (what, r["coords"])
        assert _rel(got, want[sl]) <= TOL, (what, r["coords"])
        whole[sl] = got
    assert not np.isnan(whole).any(), what
    assert _rel(whole, want) <= TOL, what


def _logits_spec(arch, mode):
    jcb.load_all()
    plan = _jplan(arch, mode)
    shape = (chk.B, 1, jcb.get_config(arch).smoke().vocab)
    return plan._fit_cache(plan.act_spec("logits", 3), shape)


def _cache_specs(arch, length: int) -> dict:
    """{"si_j_name": spec} of the decode layout of a cache `length` long."""
    cfg = jcb.get_config(arch).smoke()
    shapes = jax.eval_shape(lambda: jt.init_cache(cfg, chk.B, length))
    specs = _jplan(arch, "decode").cache_specs(shapes)
    return {f"{si}_{j}_{name}": tuple(spec)
            for si, seg in enumerate(specs) for j, blk in enumerate(seg)
            for name, spec in blk.items()}


def _check_cache(ranks, ref, arch, which: str, length: int) -> None:
    for key, spec in _cache_specs(arch, length).items():
        si, j, name = key.split("_")

        def get(r):
            return r[arch][f"{which}_cache"][int(si)][int(j)][name]

        _hold(ranks, get, ref[f"{arch}_{which}_{key}"], spec,
              f"{arch} {which} cache {key}")


def _check_loads(ranks, ref, arch, call: int) -> None:
    for r in ranks:
        loads = r[arch]["calls"][call][1]
        want = sorted(k for k in ref if k.startswith(f"{arch}_{call}_load"))
        assert len(loads) == len(want)
        for got, key in zip(loads, want):
            np.testing.assert_array_equal(got.numpy(), ref[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax_serve_step(run, arch):
    ranks, ref = run
    _hold(ranks, lambda r: r[arch]["calls"][0][0], ref[f"{arch}_0_logits"],
          _logits_spec(arch, "prefill"), f"{arch} prefill logits")
    _check_cache(ranks, ref, arch, "prefill", chk.T0)
    _check_loads(ranks, ref, arch, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_serve_step(run, arch):
    ranks, ref = run
    for c in range(1, 1 + chk.STEPS):
        _hold(ranks, lambda r: r[arch]["calls"][c][0],
              ref[f"{arch}_{c}_logits"], _logits_spec(arch, "decode"),
              f"{arch} decode {c} logits")
        _check_loads(ranks, ref, arch, c)
    _check_cache(ranks, ref, arch, "decode", chk.LEN)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_blocks_of_the_weights(run, arch):
    """Every leaf's shape on every rank is its block's by the reference's
    `param_specs` on the full tree (blocks of one spec share a shape),
    and some leaves are cut."""
    ranks, _ = run
    cfg = jcb.get_config(arch).smoke()
    shapes = jax.eval_shape(lambda: jt.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    specs = _jplan(arch, "prefill").param_specs(shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    origin = dict.fromkeys(chk.MESH, 0)
    want = {}
    for path, spec in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        g = tuple(_leaf(shapes, name).shape)
        want[name] = tuple(len(range(*s.indices(d)))
                           for s, d in zip(_block(spec, g, origin), g))
    split = [n for n, s in want.items()
             if s != tuple(_leaf(shapes, n).shape)]
    assert split, "no leaf is cut"
    for r in ranks:
        assert dict(r[arch]["weights"]) == want


def _leaf(tree, name: str):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _global(arch, kind: str, t: int) -> tuple:
    cfg = jcb.get_config(arch).smoke()
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"hidden": (chk.B, t, cfg.d_model),
            "attn_in": (chk.B, t, cfg.d_model),
            "mlp_in": (chk.B, t, cfg.d_model),
            "q_heads": (chk.B, t, h, dh), "kv_heads": (chk.B, t, kh, dh),
            "attn_out": (chk.B, t, h * dh),
            "logits": (chk.B, 1, cfg.vocab)}[kind]


@pytest.mark.parametrize("arch", ARCHS)
def test_tagged_activations_have_their_blocks_shapes(run, arch):
    """At every `act` tag of prefill and decode, each rank's tensor has
    the shape of its block by the reference's `act_spec` fitted to the
    tag's global shape; every kind the reference tags is seen, and the
    residual stream is cut over both axes in prefill."""
    ranks, _ = run
    for mode, t in (("prefill", chk.T0), ("decode", 1)):
        plan = _jplan(arch, mode)
        for r in ranks:
            seen = r[arch]["acts"][mode]
            assert {k for k, _ in seen} >= {"hidden", "attn_in", "mlp_in",
                                            "q_heads", "attn_out", "logits"}
            for kind, shape in seen:
                g = _global(arch, kind, t)
                spec = plan._fit_cache(plan.act_spec(kind, len(g)), g)
                sl = _block(spec, g, r["coords"])
                want = tuple(len(range(*s.indices(d)))
                             for s, d in zip(sl, g))
                assert shape == want, (mode, kind, spec)
        hidden = [s for k, s in ranks[0][arch]["acts"][mode]
                  if k == "hidden"]
        cut = (chk.B // 2, chk.T0 // 2) if mode == "prefill" else (
            chk.B // 2, 1)
        assert all(s[:2] == cut for s in hidden), (mode, hidden)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_runs_on_head_or_sequence_shards(run, arch):
    """granite (head-TP): each rank's flash calls take H/2 query heads at
    offset 0; qwen and arctic (sequence-parallel): all H heads, the
    second model rank's queries at q_offset T0/2."""
    ranks, _ = run
    cfg = jcb.get_config(arch).smoke()
    for r in ranks:
        calls = r[arch]["flash"]
        assert len(calls) == cfg.num_layers
        if arch == "granite-3-2b":
            want = (cfg.num_heads // 2, 0)
        else:
            want = (cfg.num_heads, r["coords"]["model"] * chk.T0 // 2)
        assert set(calls) == {want}


@pytest.mark.parametrize("arch", chk.SERVE_ARCHS)
def test_model_batcher_under_a_plan_serves_as_one_rank(run, arch):
    ranks, _ = run
    tokens, report = chk.serve_tokens(arch)
    assert report["finished"] == chk.SERVE["requests"]
    for r in ranks:
        got_tokens, got_report = r["serve"][arch]
        assert got_tokens == tokens
        assert got_report == report


def test_reduce_scatter_sums_over_its_axes(run):
    ranks, _ = run
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for r in ranks:
        d, m = r["coords"]["data"], r["coords"]["model"]
        # the model group of data row d: ranks 2d and 2d + 1
        want = x[:, 3 * m:3 * m + 3] * (4 * d + 3)
        np.testing.assert_array_equal(r["reduce_scatter"]["model"].numpy(),
                                      want)
        np.testing.assert_array_equal(r["reduce_scatter"]["both"].numpy(),
                                      x[r["rank"]:r["rank"] + 1] * 10)


@pytest.mark.parametrize("tq,tk,h,kh,q_offset,window", [
    (64, 64, 4, 2, 0, 0),            # a whole prompt
    (32, 64, 4, 2, 32, 0),           # the second sequence block of two
    (32, 64, 4, 4, 32, 24),          # ... with a window
    (16, 64, 8, 2, 48, 0),           # the last block of four, GQA 4
])
def test_flash_plain_takes_the_references_q_offset(tq, tk, h, kh, q_offset,
                                                   window):
    """The plain flash on a block of queries at their global positions
    against the whole K/V equals the reference's
    `layers.flash_attention(q_offset=...)` within 2e-5 (f32), in blocks
    smaller than the keys."""
    rng = np.random.default_rng(q_offset + window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, tq, h, 16), (2, tk, kh, 16), (2, tk, kh, 16)))
    want = jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, block=16, q_offset=q_offset)
    got = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, block=16, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    # the kernel's count of the pairs it attends
    pos = q_offset + np.arange(tq)[:, None]
    kpos = np.arange(tk)[None, :]
    seen = (kpos <= pos) & ((kpos > pos - window) if window else True)
    assert tfa.visible_pairs(tq, tk, True, window, q_offset) == seen.sum()
