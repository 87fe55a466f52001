"""The inputs and the rank body of the GSPMD serving tests
(`test_torch_gspmd_serve.py`, `test_torch_gspmd_recurrent.py`): one job
of `RANKS` gloo ranks (`repro_torch.launch.mesh.spawn(run_ranks,
(cases, serve_archs))`) serves each case's smoke config through
`repro_torch.serve.step` under the port's plans on a (data 2, model 2)
mesh, each rank returning its blocks and what it held: the shape of each
weight leaf, of each tagged activation (`ShardingPlan.act`, recorded by
wrapping it), each flash call's local heads, `q_offset` and window, and
each scan's local channels or heads.  The tests hold them to the JAX
package's `serve.step` (`jax_gspmd_reference.py`, given the same cases)
and to the reference's specs."""
import dataclasses
import json
import re
from typing import NamedTuple

import numpy as np
import torch

RANKS = 4
MESH = {"data": 2, "model": 2}
B, T0, STEPS = 4, 8, 3


class Case(NamedTuple):
    """One served configuration: `arch`'s smoke config with the fields of
    `over` replaced, under plans with FSDP `fsdp`, its prompts `t0`
    tokens long; `name` keys its outputs."""
    name: str
    arch: str
    fsdp: bool
    over: tuple = ()
    t0: int = T0


# head-TP with FSDP; sequence-parallel; sequence-parallel with experts and
# the dense residual under FSDP; sequence-parallel with GQA; attention
# and top-1 MoE blocks under FSDP; head-TP with qkv biases under FSDP;
# and the two archs that take embeddings (musicgen's, and qwen2-vl's with
# (B, T, 3) mrope positions)
ARCHS = (Case("granite-3-2b", "granite-3-2b", True),
         Case("qwen1.5-4b", "qwen1.5-4b", False),
         Case("arctic-480b", "arctic-480b", True),
         Case("minitron-4b", "minitron-4b", False),
         Case("llama4-maverick-400b-a17b", "llama4-maverick-400b-a17b",
              True),
         Case("qwen1.5-110b", "qwen1.5-110b", True),
         Case("musicgen-medium", "musicgen-medium", False),
         Case("qwen2-vl-7b", "qwen2-vl-7b", False))
# model_batcher: requests of prompts 3-10 long, both layouts' rows split
SERVE = dict(batch=2, max_len=32, requests=5, new_tokens=4,
             prompt_len=(3, 11))
SERVE_ARCHS = ("granite-3-2b", "qwen1.5-4b")
# the leaves `numpy_params` sets to constants (gates, mixes, norms of the
# recurrent blocks), drawn instead for the recurrent archs so that a
# wrong block of them shows
_DRAWN = r"(w_r|b_r|w_i|b_i|mu|mu_cm|w0|ln_o|ln_o_b)$"


def length(t0: int) -> int:
    """The decode cache's length for prompts of `t0` tokens."""
    return 2 * t0


def config(cb, case: Case):
    """The case's config from registry `cb` (either package's)."""
    return dataclasses.replace(cb.get_config(case.arch).smoke(),
                               **dict(case.over))


def to_json(cases) -> str:
    return json.dumps([list(c) for c in cases])


def from_json(text: str) -> tuple:
    return tuple(Case(n, a, f, tuple(map(tuple, o)), t)
                 for n, a, f, o, t in json.loads(text))


def weights(cfg, drawn: str | None = None) -> dict:
    """The numpy weights both packages serve: `numpy_params(cfg, 0)`, with
    the recurrent blocks' constant leaves drawn (seed 2) about their
    constants; with `drawn` (a pattern of leaf names) those leaves are
    drawn so in every arch."""
    from repro_torch.models import convert
    from repro_torch.sharding.partition import map_with_path
    params = convert.numpy_params(cfg, 0)
    if drawn is None:
        if not (cfg.ssm or cfg.pattern):
            return params
        drawn = _DRAWN
    rng = np.random.default_rng(2)

    def draw(name, leaf):
        if not re.search(drawn, name):
            return leaf
        return (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(
            leaf.dtype)

    return map_with_path(draw, params)


def inputs(case: Case, seed: int = 1) -> tuple[dict, list]:
    """(the prefill batch, the STEPS decode batches) as numpy arrays: the
    inputs the case's `cfg.input_specs` names, tokens (or embeddings) of
    one sequence of t0 + STEPS positions, mrope positions (t, t // 2,
    t % 4) at prefill."""
    from repro_torch.configs import base as cb
    cb.load_all()
    cfg, t0 = config(cb, case), case.t0
    rng = np.random.default_rng(seed)
    n = t0 + STEPS
    key = "tokens" if cfg.embed_inputs else "embeds"
    if cfg.embed_inputs:
        seq = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    else:
        seq = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    specs = cfg.input_specs(cb.ShapeSpec("gspmd", t0, B, "prefill"))
    pre = {key: seq[:, :t0]}
    if "labels" in specs:
        pre["labels"] = rng.integers(0, cfg.vocab, (B, t0)).astype(np.int32)
    if "positions" in specs:
        t = np.arange(t0)
        pre["positions"] = np.broadcast_to(
            np.stack([t, t // 2, t % 4], -1), (B, t0, 3)).astype(np.int32)
    assert {k: v.shape for k, v in pre.items()} == {
        k: tuple(v[0]) for k, v in specs.items()}, specs
    dec = [{key: seq[:, i:i + 1], "positions": np.full((B,), i, np.int32)}
           for i in range(t0, n)]
    return pre, dec


def _recording(plan, log: list):
    """Wrap `plan.act`: every call appends (kind, its output's shape)."""
    act = plan.act

    def recorded(x, kind, *args, **kwargs):
        out = act(x, kind, *args, **kwargs)
        log.append((kind, tuple(out.shape)))
        return out

    plan.act = recorded


def _spies(calls: dict):
    """Wrap the model's flash entry and the two scans: each call appends
    to `calls["flash"]` (local heads, q_offset, window), to
    `calls["rglru_scan"]` its channels, to `calls["rwkv6_scan"]` its
    heads.  Returns a function that puts them back."""
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models import layers
    real = [(layers, "flash_attention"), (rg, "rglru_scan"),
            (rw, "rwkv6_scan")]
    real = [(m, n, getattr(m, n)) for m, n in real]
    flash, rglru, rwkv = (f for _, _, f in real)

    def flash_spy(q, k, v, **kw):
        calls["flash"].append((int(q.shape[2]), int(kw.get("q_offset", 0)),
                               int(kw.get("window", 0))))
        return flash(q, k, v, **kw)

    def rglru_spy(u, *a, **kw):
        calls["rglru_scan"].append(int(u.shape[-1]))
        return rglru(u, *a, **kw)

    def rwkv_spy(r, *a, **kw):
        calls["rwkv6_scan"].append(int(r.shape[2]))
        return rwkv(r, *a, **kw)

    for (m, n, _), spy in zip(real, (flash_spy, rglru_spy, rwkv_spy)):
        setattr(m, n, spy)
    return lambda: [setattr(m, n, f) for m, n, f in real]


def _arch(mesh, case: Case) -> dict:
    from repro_torch.configs import base as cb
    from repro_torch.models import convert
    from repro_torch.models import transformer as tt
    from repro_torch.serve import step
    from repro_torch.sharding import ShardingPlan
    from repro_torch.sharding.partition import map_with_path, spec_leaves
    from repro_torch.tree_util import tree_map
    cfg = config(cb, case)
    pre_plan = ShardingPlan(mesh, cfg, mode="prefill", fsdp=case.fsdp)
    dec_plan = ShardingPlan(mesh, cfg, mode="decode", fsdp=case.fsdp)
    full = convert.params_from_numpy(weights(cfg), "cpu")
    # each rank keeps copies of its blocks alone
    params = tree_map(torch.clone, pre_plan.shard_params(full))
    del full
    held = [(name, tuple(leaf.shape)) for name, leaf in spec_leaves(params)]
    acts = {"prefill": [], "decode": []}
    _recording(pre_plan, acts["prefill"])
    _recording(dec_plan, acts["decode"])
    pre_in, dec_in = inputs(case)
    calls = {"flash": [], "rglru_scan": [], "rwkv6_scan": []}
    restore = _spies(calls)
    try:
        prefill, _ = step.jit_prefill_step(
            cfg, pre_plan, {k: (v.shape, v.dtype) for k, v in pre_in.items()})
        logits, pre, loads = prefill(params, pre_in)
        decode, _, _ = step.jit_decode_step(
            cfg, dec_plan, {k: (v.shape, v.dtype)
                            for k, v in dec_in[0].items()},
            B, length(case.t0))
        # the decode cache: the prompt's cache put back together (each
        # leaf as its prefill spec splits it) and set into a whole cache
        # by leaf (a state or a window cache whole, a full cache's first
        # t0 positions), then cut to this rank's blocks
        shapes = step.abstract_cache(cfg, B, case.t0)
        whole = map_with_path(lambda name, leaf: dec_plan.relayout(
            leaf, dec_plan.cache_spec(name, _at(shapes, name).shape), ()),
            pre)
        cache = tt.init_cache(cfg, B, length(case.t0), "cpu")
        map_with_path(lambda name, leaf: _set(leaf, _at(whole, name)), cache)
        cache = tree_map(torch.clone, dec_plan.shard_cache(cache))
        out = [(logits, loads)]
        for batch in dec_in:
            lg, cache, ld = decode(params, cache, batch)
            out.append((lg, ld))
    finally:
        restore()
    blocks = tt.init_cache(cfg, B, length(case.t0), "meta", shd=dec_plan)
    return {"weights": held, "acts": acts, "flash": calls["flash"],
            "init_cache": [(name, tuple(leaf.shape))
                           for name, leaf in spec_leaves(blocks)],
            "scans": {k: calls[k] for k in ("rglru_scan", "rwkv6_scan")},
            "calls": out, "prefill_cache": pre, "decode_cache": cache}


def _at(tree, name: str):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _set(leaf, prompt) -> None:
    """A cache leaf set from the prompt's: whole where the shapes agree,
    else (a full cache) its first positions."""
    if leaf.shape == prompt.shape:
        leaf.copy_(prompt)
    else:
        leaf[:, :, :prompt.shape[2]] = prompt


def serve_tokens(arch: str, plan=None) -> tuple[list, dict]:
    """`arch`'s smoke config served through `model_batcher` on the CPU
    (under `plan`, with this rank's blocks of the weights): every
    request's tokens and the batcher's report."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import serve
    from repro_torch.models import convert
    from repro_torch.serve.engine import model_batcher
    cfg = cb.get_config(arch).smoke()
    params = convert.params_from_numpy(weights(cfg), "cpu")
    if plan is not None:
        params = plan.shard_params(params)
    reqs = serve.requests(cfg, SERVE["requests"], SERVE["new_tokens"],
                          SERVE["prompt_len"], 0)
    batcher = model_batcher(cfg, params, SERVE["batch"], SERVE["max_len"],
                            shd=plan, device="cpu")
    for r in reqs:
        batcher.submit(r)
    report = batcher.run_until_drained()
    return [list(r.generated) for r in reqs], report


def _reduce_scatter(mesh) -> dict:
    """`Mesh.reduce_scatter` of (rank + 1) x arange over `model` and over
    both axes."""
    from repro_torch.launch.mesh import world
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) * (world()[1]
                                                             + 1)
    return {"model": mesh.reduce_scatter(x, "model", 1),
            "both": mesh.reduce_scatter(x, ("data", "model"), 0)}


def run_ranks(cases=ARCHS, serve_archs=SERVE_ARCHS) -> dict:
    """Every case on this rank; returns its blocks and records."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardingPlan
    torch.set_num_threads(1)
    cb.load_all()
    mesh = Mesh(MESH)
    out = {"coords": dict(mesh.coords), "rank": mesh.rank,
           "reduce_scatter": _reduce_scatter(mesh)}
    for case in cases:
        out[case.name] = _arch(mesh, case)
    out["serve"] = {arch: serve_tokens(arch, ShardingPlan(
        mesh, cb.get_config(arch).smoke(), mode="decode"))
        for arch in serve_archs}
    return out
