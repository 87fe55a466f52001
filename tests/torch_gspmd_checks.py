"""The inputs and the rank body of `test_torch_gspmd_serve.py`: one job of
`RANKS` gloo ranks (`repro_torch.launch.mesh.spawn(run_ranks, ...)`)
serves every arch's smoke config through `repro_torch.serve.step` under
the port's plans on a (data 2, model 2) mesh, each rank returning its
blocks and what it held: the shape of each weight leaf, of each tagged
activation (`ShardingPlan.act`, recorded by wrapping it) and of each
flash call with its `q_offset`.  The test holds them to the JAX
package's `serve.step` (`jax_gspmd_reference.py`) and to the
reference's specs."""
import numpy as np
import torch

RANKS = 4
MESH = {"data": 2, "model": 2}
# (arch, fsdp): head-TP with FSDP, sequence-parallel, and sequence-parallel
# with experts and the dense residual under FSDP
ARCHS = (("granite-3-2b", True), ("qwen1.5-4b", False),
         ("arctic-480b", True))
B, T0, STEPS, LEN = 4, 8, 3, 16
# model_batcher: requests of prompts 3-10 long, both layouts' rows split
SERVE = dict(batch=2, max_len=32, requests=5, new_tokens=4,
             prompt_len=(3, 11))
SERVE_ARCHS = ("granite-3-2b", "qwen1.5-4b")


def tokens(vocab: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, T0 + STEPS)).astype(np.int32)


def decode_batch(toks: np.ndarray, i: int) -> dict:
    return {"tokens": toks[:, i:i + 1],
            "positions": np.full((B,), i, np.int32)}


def _recording(plan, log: list):
    """Wrap `plan.act`: every call appends (kind, its output's shape)."""
    act = plan.act

    def recorded(x, kind, *args, **kwargs):
        out = act(x, kind, *args, **kwargs)
        log.append((kind, tuple(out.shape)))
        return out

    plan.act = recorded


def _flash_spy(calls: list):
    """Wrap the model's flash entry: every call appends (local heads,
    q_offset).  Returns a function that puts it back."""
    from repro_torch.models import layers
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        calls.append((int(q.shape[2]), int(kw.get("q_offset", 0))))
        return real(q, k, v, **kw)

    layers.flash_attention = spy
    return lambda: setattr(layers, "flash_attention", real)


def _arch(mesh, arch: str, fsdp: bool) -> dict:
    from repro_torch.configs import base as cb
    from repro_torch.models import convert
    from repro_torch.models import transformer as tt
    from repro_torch.serve import step
    from repro_torch.sharding import ShardingPlan
    from repro_torch.sharding.partition import spec_leaves
    from repro_torch.tree_util import tree_map
    cfg = cb.get_config(arch).smoke()
    pre_plan = ShardingPlan(mesh, cfg, mode="prefill", fsdp=fsdp)
    dec_plan = ShardingPlan(mesh, cfg, mode="decode", fsdp=fsdp)
    full = convert.params_from_numpy(convert.numpy_params(cfg, 0), "cpu")
    # each rank keeps copies of its blocks alone
    params = tree_map(torch.clone, pre_plan.shard_params(full))
    del full
    weights = [(name, tuple(leaf.shape))
               for name, leaf in spec_leaves(params)]
    acts = {"prefill": [], "decode": []}
    _recording(pre_plan, acts["prefill"])
    _recording(dec_plan, acts["decode"])
    toks = tokens(cfg.vocab)
    flash = []
    restore = _flash_spy(flash)
    try:
        prefill, _ = step.jit_prefill_step(
            cfg, pre_plan, {"tokens": ((B, T0), torch.int32)})
        logits, pre, loads = prefill(params, {"tokens": toks[:, :T0]})
        decode, _, _ = step.jit_decode_step(
            cfg, dec_plan, {"tokens": ((B, 1), torch.int32),
                            "positions": ((B,), torch.int32)}, B, LEN)
        # the decode cache: each rank's block of the prompt's positions
        # (its prefill block under the decode layout) in its block of LEN
        cache = tt.init_cache(cfg, B, LEN, "cpu", shd=dec_plan)
        for seg, pseg in zip(cache, pre):
            for blk, pblk in zip(seg, pseg):
                for name, leaf in blk.items():
                    whole = dec_plan.mesh.all_gather(pblk[name], "model",
                                                     dim=2)
                    lo = dec_plan.mesh.axis_index("model") * leaf.shape[2]
                    hi = min(lo + leaf.shape[2], T0)
                    if hi > lo:
                        leaf[:, :, :hi - lo] = whole[:, :, lo:hi]
        calls = [(logits, loads)]
        for i in range(T0, T0 + STEPS):
            lg, cache, ld = decode(params, cache, decode_batch(toks, i))
            calls.append((lg, ld))
    finally:
        restore()
    return {"weights": weights, "acts": acts, "flash": flash,
            "calls": calls, "prefill_cache": pre, "decode_cache": cache}


def serve_tokens(arch: str, plan=None) -> tuple[list, dict]:
    """`arch`'s smoke config served through `model_batcher` on the CPU
    (under `plan`, with this rank's blocks of the weights): every
    request's tokens and the batcher's report."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import serve
    from repro_torch.models import convert
    from repro_torch.serve.engine import model_batcher
    cfg = cb.get_config(arch).smoke()
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), "cpu")
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


def run_ranks() -> dict:
    """Every arch on this rank; returns its blocks and records."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardingPlan
    torch.set_num_threads(1)
    cb.load_all()
    mesh = Mesh(MESH)
    out = {"coords": dict(mesh.coords), "rank": mesh.rank,
           "reduce_scatter": _reduce_scatter(mesh)}
    for arch, fsdp in ARCHS:
        out[arch] = _arch(mesh, arch, fsdp)
    out["serve"] = {arch: serve_tokens(arch, ShardingPlan(
        mesh, cb.get_config(arch).smoke(), mode="decode"))
        for arch in SERVE_ARCHS}
    return out
