"""The inputs and the rank body of `test_torch_mesh.py`: every multi-rank
check of the port runs in one job of `RANKS` gloo ranks
(`repro_torch.launch.mesh.spawn(run_ranks, ...)`), each rank returning
its blocks; the test puts the blocks together and holds them to the JAX
package's sharded functions (`jax_mesh_reference.py`, one subprocess on
`RANKS` forced host devices) and to the port's one-rank paths."""
import dataclasses

import numpy as np
import torch

RANKS = 4
B_DEC, S_DEC, POS_DEC = 4, 16, (3, 7, 8, 13)   # blocks of 8: both, edges
B_MOE, T_MOE, MOE_CHUNK = 4, 32, 32            # 64 tokens a data shard
MODEL_ARCHS = ("arctic-480b", "granite-3-2b")
B_MODEL, T0_MODEL, STEPS_MODEL, LEN_MODEL = 2, 8, 3, 16
EF_ROUNDS = 8
FLEET_KW = dict(slot_counts=[4], total_steps=400)
GROUPS = [("minver", "cubic"), ("crc32", "edn"), ("qrduino", "nbody")]
PLACEMENT = dict(num_slots=4, miss_latency=50, quantum_cycles=500,
                 trace_len=1_000, steps_per_program=1_000)


def moe_cfg(base):
    """arctic's smoke config with a capacity that drops tokens."""
    return dataclasses.replace(base.get_config("arctic-480b").smoke(),
                               capacity_factor=1.0)


def make_inputs(seed: int = 0) -> dict:
    """Every check's numpy inputs (f32 / int32), from one seed."""
    from repro_torch.core import isa
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    h, kh, dh, d, e, ff = 4, 2, 16, 64, 8, 128
    return {
        "fleet": rng.integers(0, isa.NUM_INSTRUCTIONS, (3, 2, 400)).astype(
            np.int32),
        "dec_q": f(B_DEC, 1, h, dh), "dec_k": f(B_DEC, S_DEC, kh, dh),
        "dec_v": f(B_DEC, S_DEC, kh, dh), "dec_kn": f(B_DEC, 1, kh, dh),
        "dec_vn": f(B_DEC, 1, kh, dh),
        "dec_pos": np.asarray(POS_DEC, np.int32),
        "moe_x": f(B_MOE, T_MOE, d),
        "moe_router": f(d, e) * d ** -0.5, "moe_wi": f(e, d, ff) * d ** -0.5,
        "moe_wg": f(e, d, ff) * d ** -0.5, "moe_wo": f(e, ff, d) * ff ** -0.5,
        "cp_w": f(2, 64, 64), "cp_b": f(2, 16),
    }


def model_tokens(cfg, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B_MODEL, T0_MODEL + STEPS_MODEL)
                        ).astype(np.int32)


def _fleet(x, mesh_size):
    """Rank side of the fleet checks: the sharded sweep, each rank's
    block of every window pass, the contention model's predictions."""
    from repro_torch.core import isa, simulator, stackdist_interleaved
    from repro_torch.sched import ContentionModel, PlacementConfig
    blocks = []
    inner = stackdist_interleaved.sweep_preempted

    def spy(fleets, *a, **kw):
        blocks.append(int(fleets.shape[0]))
        return inner(fleets, *a, **kw)

    stackdist_interleaved.sweep_preempted = spy
    try:
        sched = simulator.SchedulerConfig(quantum_cycles=500)
        res = simulator.sweep_fleet(
            x["fleet"], [50], isa.SCENARIO_2, sched, path="interleaved",
            interleave_window=64, device="cpu", **FLEET_KW)
        pred = ContentionModel(PlacementConfig(**PLACEMENT),
                               device="cpu").predict(GROUPS)
    finally:
        stackdist_interleaved.sweep_preempted = inner
    return {"fleet": tuple(res), "mesh_size": mesh_size,
            "blocks": blocks, "predict": [np.asarray(p) for p in pred]}


def _decode(x, mesh, cfg):
    from repro_torch.models import kvcache
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    rows = slice(mesh.axis_index("data") * 2, mesh.axis_index("data") * 2 + 2)
    s_loc = S_DEC // mesh.axis_size("model")
    seq = slice(mesh.axis_index("model") * s_loc,
                (mesh.axis_index("model") + 1) * s_loc)
    cache = {"k": t["dec_k"][rows, seq].clone(),
             "v": t["dec_v"][rows, seq].clone()}
    o, cache = kvcache.decode_attention(
        t["dec_q"][rows], cache, t["dec_kn"][rows], t["dec_vn"][rows],
        t["dec_pos"][rows], cfg, mesh)
    return {"o": o, "k": cache["k"], "v": cache["v"]}


def _moe(x, mesh, cfg):
    from repro_torch.models import moe
    from repro_torch.sharding import ShardingPlan
    plan = ShardingPlan(mesh, cfg, mode="prefill")
    p = {"router": torch.from_numpy(x["moe_router"]),
         **{k: torch.from_numpy(x[f"moe_{k}"]) for k in ("wi", "wg", "wo")}}
    p = {k: v if k == "router" else plan.local_shard(v, ("model", None,
                                                         None))
         for k, v in p.items()}
    xs = torch.from_numpy(x["moe_x"])[plan.block(B_MOE, "data")]
    out = {}
    for name, chunk in (("unchunked", moe.MOE_TOKEN_CHUNK),
                        ("chunked", MOE_CHUNK)):
        saved, moe.MOE_TOKEN_CHUNK = moe.MOE_TOKEN_CHUNK, chunk
        try:
            y, aux = moe.moe_apply(p, xs, cfg, mesh)
        finally:
            moe.MOE_TOKEN_CHUNK = saved
        out[name] = (y, aux["expert_load"])
    return out


def _compress(x, mesh):
    from repro_torch.optim import compress
    i = mesh.axis_index("pod")
    g = {"w": torch.from_numpy(x["cp_w"][i:i + 1]),
         "b": torch.from_numpy(x["cp_b"][i:i + 1])}
    rounds, ef = [], None
    for _ in range(1 + EF_ROUNDS):
        mean, ef = compress.cross_pod_mean_tree(g, ef, mesh)
        rounds.append((mean, ef))
    return {"pod": i, "rounds": rounds}


def fails(rank_to_fail: int) -> int:
    """A rank body that raises on one rank and returns the rank on the
    others."""
    from repro_torch.launch import mesh
    _, rank = mesh.world()
    if rank == rank_to_fail:
        raise RuntimeError(f"rank {rank} failed on purpose")
    return rank


def whole_logits(plan, logits, batch: int, vocab: int):
    """The (batch, 1, vocab) logits put together from this rank's block
    (as given without a plan)."""
    if plan is None:
        return logits
    return plan.relayout(logits, plan.spec("logits", (batch, 1, vocab)), ())


def whole_prefill_cache(plan, cache, batch: int, length: int):
    """A prefill cache of `batch` rows and `length` positions put together
    from this rank's blocks in the decode layout (as given without a
    plan)."""
    if plan is None:
        return cache

    def one(name, leaf):
        spec = plan.cache_spec(name, (leaf.shape[0], batch, length,
                                      *leaf.shape[3:]))
        return plan.relayout(leaf, spec, ())

    from repro_torch.sharding.partition import map_with_path
    return map_with_path(one, cache)


def model_run(arch, plan=None, decode_plan=None):
    """Prefill of the first T0 tokens and STEPS teacher-forced decode
    steps of `arch`'s smoke config on the CPU: (logits of each call, the
    expert loads of each call).  Under plans each rank holds its blocks,
    and the logits are put back together."""
    from repro_torch.configs import base as cb
    from repro_torch.models import convert
    from repro_torch.models import transformer as tt
    from repro_torch.tree_util import tree_map
    cb.load_all()
    cfg = cb.get_config(arch).smoke()
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), "cpu")
    if plan is not None:
        params = plan.shard_params(params)
    tokens = model_tokens(cfg)
    logits, pre, aux = tt.prefill(
        cfg, params, {"tokens": tokens[:, :T0_MODEL]}, shd=plan)
    out_l = [whole_logits(plan, logits, B_MODEL, cfg.vocab)]
    out_a = [_loads(aux)]
    pre = whole_prefill_cache(plan, pre, B_MODEL, T0_MODEL)
    full = tt.init_cache(cfg, B_MODEL, LEN_MODEL, "cpu")
    for seg, pseg in zip(full, pre):
        for blk, pblk in zip(seg, pseg):
            for name, leaf in blk.items():
                leaf[:, :, :T0_MODEL] = pblk[name]
    cache = full if decode_plan is None else tree_map(
        torch.clone, decode_plan.shard_cache(full))
    for i in range(T0_MODEL, T0_MODEL + STEPS_MODEL):
        batch = {"tokens": tokens[:, i:i + 1],
                 "positions": np.full((B_MODEL,), i, np.int32)}
        logits, cache, aux = tt.decode_step(cfg, params, batch, cache,
                                            shd=decode_plan)
        out_l.append(whole_logits(decode_plan, logits, B_MODEL,
                                  cfg.vocab))
        out_a.append(_loads(aux))
    return out_l, out_a


def _loads(aux) -> list:
    return [a["expert_load"] for seg in aux for a in seg
            if "expert_load" in a]


def _models(mesh):
    from repro_torch.configs import base as cb
    from repro_torch.sharding import ShardingPlan
    cb.load_all()
    out = {}
    for arch in MODEL_ARCHS:
        cfg = cb.get_config(arch).smoke()
        out[arch] = model_run(arch, ShardingPlan(mesh, cfg, mode="prefill"),
                              ShardingPlan(mesh, cfg, mode="decode"))
    return out


def serve_run(plan=None) -> dict:
    """arctic's smoke config through `model_batcher` and then the
    `SlotServeEngine` on the CPU (under `plan`): every request's tokens,
    the engine's stats."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import serve
    from repro_torch.models import convert
    from repro_torch.serve.engine import (EngineConfig, SlotServeEngine,
                                          model_batcher)
    cb.load_all()
    cfg = cb.get_config("arctic-480b").smoke()
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), "cpu")
    if plan is not None:
        params = plan.shard_params(params)
    reqs = serve.requests(cfg, 5, 4, (3, 11), 0)
    batcher = model_batcher(cfg, params, 2, 32, shd=plan, device="cpu")
    for r in reqs:
        batcher.submit(r)
    report = batcher.run_until_drained()
    rng = np.random.default_rng(0)
    eng = SlotServeEngine(cfg, params, EngineConfig(quantum_tokens=2),
                          serve.slot_tenants(cfg, rng), max_len=32,
                          shd=plan, device="cpu")
    return {"tokens": [r.generated for r in reqs], "report": report,
            "slots": eng.run(6)}


def run_ranks(x: dict) -> dict:
    """Every check on this rank; returns its blocks."""
    from repro_torch.configs import base as cb
    from repro_torch.core import simulator
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import ShardingPlan
    torch.set_num_threads(1)
    cb.load_all()
    out = _fleet(x, simulator.fleet_mesh_size())
    dm = Mesh({"data": 2, "model": 2})
    out["coords"] = dict(dm.coords)
    out["decode"] = _decode(x, dm, cb.get_config("arctic-480b").smoke())
    out["moe"] = _moe(x, dm, moe_cfg(cb))
    out["compress"] = _compress(x, Mesh({"pod": 2, "data": 2}))
    out["models"] = _models(dm)
    arctic = cb.get_config("arctic-480b").smoke()
    out["serve"] = serve_run(ShardingPlan(Mesh({"data": 1, "model": RANKS}),
                                          arctic, mode="decode"))
    return out
