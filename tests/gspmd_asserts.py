"""The test side of the GSPMD serving tests (`test_torch_gspmd_serve.py`,
`test_torch_gspmd_recurrent.py`): `run_job` runs one job of 4 gloo ranks
(`torch_gspmd_checks.run_ranks`) beside one JAX subprocess on 4 forced
host devices (`jax_gspmd_reference.py`) over the same cases, and the
`hold_*` functions hold every rank's blocks to the reference's outputs
and to its specs (`repro.sharding.partition.ShardingPlan` on the mesh's
shape)."""
import math
import os
import subprocess
import sys

import jax
import numpy as np

import torch_gspmd_checks as chk
from repro.configs import base as jcb
from repro.models import transformer as jt
from repro.sharding.partition import ShardingPlan as JPlan
from repro_torch.launch import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
TOL = 1e-5
# every kind the reference tags in an attention arch's prefill and decode
ATTN_KINDS = frozenset({"hidden", "attn_in", "mlp_in", "q_heads",
                        "attn_out", "logits"})


class FakeMesh:
    """The mesh's shape for the reference's plans (specs only)."""

    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)
        self.devices = np.empty((0,))


def run_job(tmp_path_factory, cases, serve_archs) -> tuple[list, dict]:
    """(the ranks' outputs in rank order, the reference's arrays) of
    `cases`, and `model_batcher` under a plan for `serve_archs`."""
    dst = str(tmp_path_factory.mktemp("gspmd") / "reference.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_gspmd_reference.py"), dst,
         chk.to_json(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = tmesh.spawn(chk.run_ranks, chk.RANKS,
                            (tuple(cases), tuple(serve_archs)),
                            timeout=300.0)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, out + err
    return ranks, dict(np.load(dst))


def jconfig(case: chk.Case):
    jcb.load_all()
    return chk.config(jcb, case)


def jplan(case: chk.Case, mode: str):
    return JPlan(FakeMesh(chk.MESH), jconfig(case), mode=mode,
                 fsdp=case.fsdp)


def block(spec, shape, coords, mesh=None) -> tuple:
    """The slices of a rank's block of `shape` under `spec`, from the
    rank's mesh coordinates (row-major over a tuple of axes) on `mesh`
    ({axis: size}; the tests' (data 2, model 2) by default)."""
    mesh = chk.MESH if mesh is None else mesh
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        if e is None:
            out.append(slice(None))
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n = math.prod(mesh[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * mesh[a] + coords[a]
        out.append(slice(idx * dim // n, (idx + 1) * dim // n))
    return tuple(out)


def block_shape(spec, shape, coords) -> tuple:
    return tuple(len(range(*s.indices(d)))
                 for s, d in zip(block(spec, shape, coords), shape))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def hold(ranks, get, want: np.ndarray, spec, what: str) -> None:
    """Every rank's block (`get(rank)`) within TOL of its block of `want`,
    and the blocks put together within TOL of `want`."""
    whole = np.full(want.shape, np.nan)
    for r in ranks:
        sl = block(spec, want.shape, r["coords"])
        got = get(r).numpy()
        assert got.shape == want[sl].shape, (what, r["coords"])
        assert rel(got, want[sl]) <= TOL, (what, r["coords"])
        whole[sl] = got
    assert not np.isnan(whole).any(), what
    assert rel(whole, want) <= TOL, what


def _logits_spec(case, mode):
    plan = jplan(case, mode)
    shape = (chk.B, 1, jconfig(case).vocab)
    return plan._fit_cache(plan.act_spec("logits", 3), shape)


def _cache_specs(case, length: int) -> dict:
    """{"si_j_name": spec} of the decode layout of a cache `length` long."""
    cfg = jconfig(case)
    shapes = jax.eval_shape(lambda: jt.init_cache(cfg, chk.B, length))
    specs = jplan(case, "decode").cache_specs(shapes)
    return {f"{si}_{j}_{name}": tuple(spec)
            for si, seg in enumerate(specs) for j, blk in enumerate(seg)
            for name, spec in blk.items()}


def _check_cache(ranks, ref, case, which: str, length: int) -> None:
    specs = _cache_specs(case, length)
    assert specs
    for key, spec in specs.items():
        si, j, name = key.split("_", 2)

        def get(r):
            return r[case.name][f"{which}_cache"][int(si)][int(j)][name]

        hold(ranks, get, ref[f"{case.name}_{which}_{key}"], spec,
             f"{case.name} {which} cache {key}")


def _check_loads(ranks, ref, case, call: int) -> None:
    for r in ranks:
        loads = r[case.name]["calls"][call][1]
        want = sorted(k for k in ref
                      if k.startswith(f"{case.name}_{call}_load"))
        assert len(loads) == len(want)
        for got, key in zip(loads, want):
            np.testing.assert_array_equal(got.numpy(), ref[key])


def hold_prefill(run, case) -> None:
    """`jit_prefill_step`'s logits, cache and expert loads."""
    ranks, ref = run
    hold(ranks, lambda r: r[case.name]["calls"][0][0],
         ref[f"{case.name}_0_logits"], _logits_spec(case, "prefill"),
         f"{case.name} prefill logits")
    _check_cache(ranks, ref, case, "prefill", case.t0)
    _check_loads(ranks, ref, case, 0)


def hold_decode(run, case) -> None:
    """STEPS `jit_decode_step` calls' logits and loads, the final cache."""
    ranks, ref = run
    for c in range(1, 1 + chk.STEPS):
        hold(ranks, lambda r: r[case.name]["calls"][c][0],
             ref[f"{case.name}_{c}_logits"], _logits_spec(case, "decode"),
             f"{case.name} decode {c} logits")
        _check_loads(ranks, ref, case, c)
    _check_cache(ranks, ref, case, "decode", chk.length(case.t0))


def leaf_at(tree, name: str):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def hold_weights(run, case) -> None:
    """Every leaf's shape on every rank is its block's by the reference's
    `param_specs` on the full tree (blocks of one spec share a shape),
    and some leaves are cut."""
    ranks, _ = run
    cfg = jconfig(case)
    shapes = jax.eval_shape(lambda: jt.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    specs = jplan(case, "prefill").param_specs(shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        specs,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    origin = dict.fromkeys(chk.MESH, 0)
    want = {}
    for path, spec in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        want[name] = block_shape(spec, tuple(leaf_at(shapes, name).shape),
                                 origin)
    split = [n for n, s in want.items()
             if s != tuple(leaf_at(shapes, n).shape)]
    assert split, "no leaf is cut"
    for r in ranks:
        assert dict(r[case.name]["weights"]) == want


def _global(cfg, kind: str, t: int) -> tuple:
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"hidden": (chk.B, t, cfg.d_model),
            "attn_in": (chk.B, t, cfg.d_model),
            "mlp_in": (chk.B, t, cfg.d_model),
            "q_heads": (chk.B, t, h, dh), "kv_heads": (chk.B, t, kh, dh),
            "attn_out": (chk.B, t, h * dh),
            "logits": (chk.B, 1, cfg.vocab)}[kind]


def hold_acts(run, case, kinds=ATTN_KINDS) -> None:
    """At every `act` tag of prefill and decode, each rank's tensor has
    the shape of its block by the reference's `act_spec` fitted to the
    tag's global shape; every kind of `kinds` (those the reference tags
    for the arch) is seen, and the residual stream is cut over both axes
    in prefill."""
    ranks, _ = run
    cfg = jconfig(case)
    for mode, t in (("prefill", case.t0), ("decode", 1)):
        plan = jplan(case, mode)
        for r in ranks:
            seen = r[case.name]["acts"][mode]
            assert {k for k, _ in seen} >= kinds, (mode, seen)
            for kind, shape in seen:
                g = _global(cfg, kind, t)
                spec = plan._fit_cache(plan.act_spec(kind, len(g)), g)
                assert shape == block_shape(spec, g, r["coords"]), (
                    mode, kind, spec)
        hidden = [s for k, s in ranks[0][case.name]["acts"][mode]
                  if k == "hidden"]
        cut = (chk.B // 2, case.t0 // 2) if mode == "prefill" else (
            chk.B // 2, 1)
        assert hidden and all(s[:2] == cut for s in hidden), (mode, hidden)


def hold_serve(run, arch) -> None:
    """`model_batcher` under a plan serves every request's tokens and
    report as the one-rank batcher does."""
    ranks, _ = run
    tokens, report = chk.serve_tokens(arch)
    assert report["finished"] == chk.SERVE["requests"]
    for r in ranks:
        got_tokens, got_report = r["serve"][arch]
        assert got_tokens == tokens
        assert got_report == report
