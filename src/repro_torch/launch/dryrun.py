"""One-card dry run: the FLOPs, bytes and memory budget of every (arch x
shape) cell, counted without allocating.  PyTorch port of
`repro.launch.dryrun`.

The JAX package lowers and compiles every cell on a 16x16 (and 2x16x16)
host mesh and walks the compiled HLO.  Here each cell's step is built at
the cell's *global* shape on the meta device and run once under
`analysis.cost.CostCounter`:

    train    `train.step.make_train_step` on `train.step.abstract_state`
             (params, m, v and the f32 master as meta tensors), the loss,
             its backward through the kernels' card route (each kernel's
             forward charged by its formula, its backward the plain body
             re-run and differentiated, as `KernelVjp` does on the card)
             and the AdamW update;
    prefill  `models.transformer.prefill` on meta params (the JAX
             package's `serve.step.abstract_params`);
    decode   one token against the full cache (`abstract_cache`: a cache
             of seq_len positions, the token at position seq_len - 1).

A meta tensor has no values, so where a kernel's work depends on one the
count takes the fixed-shape route: decode attention is charged over the
whole cache (which a decode cell fills) and `moe_gmm_skip` over every
expert, as the capacity `moe_gmm` is (`analysis.cost`: the same on real
tensors).  Nothing here reads a value on the host.

`hbm_budget` is the reference's analytical per-device budget; on one
card (`chips=1`) it takes tp=1, one card holding the model whole, and
`fits_hbm` holds it to the H100's 80 GiB.  XLA's `memory_analysis` and
`cost_analysis` have no counterpart here.  The dry run counts one card;
`build_cell(mesh=launch.mesh.CountingMesh(...))` counts one rank's step
of a cell under its plan on a mesh's shape, collectives included, which
`launch.perf` uses.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--out experiments/dryrun_torch]

writes one JSON per cell (`<arch>_<shape>_1.json`): FLOPs by dtype class
and in all, bytes, ops, each kernel's share, the roofline terms at the
H100's rates, the budget, whether it fits, and the seconds the trace
took.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.analysis import cost
from repro_torch.configs import base as cb
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import step as train_step

__all__ = ["opt_config_for", "microbatches_for", "repeats", "build_cell",
           "trace_cell", "hbm_budget", "analyse", "run_cell",
           "main", "H100_HBM"]

H100_HBM = cost.H100_HBM_BYTES


def opt_config_for(cfg) -> adamw.AdamWConfig:
    """>=100B: bf16 m, no fp32 master; >=300B additionally factor the
    second moment (Adafactor-style) — without it arctic-480b's optimizer
    alone exceeds the single-pod HBM budget (DESIGN.md §5)."""
    big = cfg.param_count() > 100e9
    return adamw.AdamWConfig(
        state_dtype="bfloat16" if big else "float32",
        master_fp32=not big,
        factored_v=cfg.param_count() > 300e9)


def microbatches_for(cfg) -> int:
    return 2 if cfg.param_count() > 100e9 else 1


def _config(arch):
    return cb.get_config(arch) if isinstance(arch, str) else arch


def _shape(shape) -> cb.ShapeSpec:
    return cb.SHAPES[shape] if isinstance(shape, str) else shape


def _batch(cfg, spec: cb.ShapeSpec, dev: torch.device) -> dict:
    """The cell's inputs (`cfg.input_specs`): zeros, and at decode every
    row's token at position seq_len - 1 (the cache full before it)."""
    out = {}
    for name, (shape, dtype) in cfg.input_specs(spec).items():
        out[name] = torch.zeros(shape, dtype=dtype, device=dev)
    if spec.kind == "decode":
        out["positions"] = torch.full((spec.global_batch,),
                                      spec.seq_len - 1, dtype=torch.int32,
                                      device=dev)
    return out


def repeats(cfg) -> tuple[int, int, int]:
    """(unit, tail, n): `cfg.num_layers` = unit n + tail, where n repeats
    of `unit` layers form the model's one repeated segment
    (`transformer.segments`) and `tail` layers follow it (a hybrid's
    partial pattern)."""
    unit = (len(cfg.pattern) if cfg.pattern else
            cfg.moe_every if cfg.is_moe and not cfg.attention_free else 1)
    n, tail = divmod(cfg.num_layers, unit)
    return unit, tail if cfg.pattern else 0, n


def build_cell(arch, shape, device="meta", seed: int = 0,
               layers: int | None = None, mesh=None, strategy=None,
               microbatches: int | None = None):
    """(step, meta) of one cell at its global shape on `device`: `step()`
    runs the cell's train step, prefill or decode step once.  On meta the
    state is `train.step.abstract_state` / meta params and caches; on
    another device the params are drawn from `seed` (for tests at small
    shapes).  `arch` is a name or a `ModelConfig`, `shape` a name or a
    `ShapeSpec`; `layers` cuts the model to that many layers, keeping the
    whole model's optimizer config, microbatches (unless `microbatches`
    is given) and FSDP choice.

    With `mesh` (on meta, a `launch.mesh.CountingMesh`) the step is its
    rank's under the cell's plan (`strategy` the train plan's
    `strategy_override`): the rank's blocks of the state, params and
    cache, the whole batch cut inside."""
    full, spec = _config(arch), _shape(shape)
    if mesh is not None:
        return _build_sharded(full, spec, layers, mesh, strategy,
                              microbatches)
    cfg = full if layers is None else dataclasses.replace(
        full, num_layers=layers)
    dev = torch.device(device)

    def params():
        gen = torch.Generator(device=dev if dev.type != "meta" else "cpu")
        return transformer.init_params(cfg, gen.manual_seed(seed), dev)

    batch = _batch(cfg, spec, dev)
    if spec.kind == "train":
        opt = opt_config_for(full)
        state = (train_step.abstract_state(cfg, opt) if dev.type == "meta"
                 else adamw.init_state(opt, params()))
        fn = train_step.make_train_step(
            cfg, opt, microbatches or microbatches_for(full))

        def step():
            return fn(state, batch)
    elif spec.kind == "prefill":
        p = params()

        @torch.no_grad()
        def step():
            return transformer.prefill(cfg, p, batch)
    else:
        p = params()
        cache = transformer.init_cache(cfg, spec.global_batch, spec.seq_len,
                                       dev)

        @torch.no_grad()
        def step():
            return transformer.decode_step(cfg, p, batch, cache)
    return step, _meta(full, spec)


def _build_sharded(full, spec, layers, mesh, strategy, microbatches):
    """`build_cell` on meta under a plan over `mesh`."""
    from repro_torch.serve import step as serve_step
    from repro_torch.sharding.partition import FSDP_THRESHOLD, ShardingPlan
    cfg = full if layers is None else dataclasses.replace(
        full, num_layers=layers)
    fsdp = full.param_count() > FSDP_THRESHOLD
    plan = ShardingPlan(mesh, cfg, mode=spec.kind, fsdp=fsdp,
                        strategy_override=strategy)
    batch = _batch(cfg, spec, torch.device("meta"))
    if spec.kind == "train":
        opt = opt_config_for(full)
        fn, shapes, specs = train_step.jit_train_step(
            cfg, opt, plan, batch, microbatches or microbatches_for(full))
        state = plan.shard_state(shapes, specs)

        def step():
            return fn(state, batch)
        return step, _meta(full, spec)
    params = plan.shard_params(serve_step.abstract_params(cfg))
    if spec.kind == "prefill":
        fn = serve_step.make_prefill(cfg, plan)

        def step():
            return fn(params, batch)
    else:
        fn = serve_step.make_decode(cfg, plan)
        cache = transformer.init_cache(cfg, spec.global_batch, spec.seq_len,
                                       "meta", shd=plan)

        def step():
            return fn(params, cache, batch)
    return step, _meta(full, spec)


def _meta(cfg, spec: cb.ShapeSpec) -> dict:
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                  else 1)
    return {"arch": cfg.name, "shape": spec.name, "kind": spec.kind,
            "tokens": tokens}


def _count(arch, shape, device, seed: int, layers=None, **sharded) -> dict:
    step, _ = build_cell(arch, shape, device, seed, layers, **sharded)
    with cost.CostCounter(device=torch.device(device).type) as counter:
        step()
    return counter.result()


def trace_cell(arch, shape, device="meta", seed: int = 0,
               extrapolate: bool = True, **sharded) -> dict:
    """One cell's count under a `CostCounter` on `device`:
    the cell's meta dict (`build_cell`) with "count" (the counter's
    `result()`), "trace_s" (seconds) and "layers_traced".  `sharded`
    (`mesh`, `strategy`, `microbatches`) go to `build_cell`: with a
    `CountingMesh` the count is its rank's, collectives included.

    The layers of the repeated segment are identical, so the count is
    linear in their number (the reference's HLO walker multiplies a scan
    body by its trip count likewise): with `extrapolate`, the step is
    counted at 1 and at 2 repeats of the segment, and the count of n is
    the first plus n - 1 times their difference, exactly (ints).  The
    tests hold it equal to the count of the whole depth."""
    t0 = time.perf_counter()
    cfg = _config(arch)
    unit, tail, n = repeats(cfg)
    if not extrapolate or n <= 2:
        count = _count(cfg, shape, device, seed, **sharded)
        traced = [cfg.num_layers]
    else:
        one = _count(cfg, shape, device, seed, unit + tail, **sharded)
        two = _count(cfg, shape, device, seed, 2 * unit + tail, **sharded)
        count = cost.combine(one, cost.combine(two, one, -1), n - 1)
        traced = [unit + tail, 2 * unit + tail]
    return dict(_meta(cfg, _shape(shape)), count=count, layers_traced=traced,
                trace_s=time.perf_counter() - t0)


def hbm_budget(arch, shape, chips: int, tp: int = 16) -> dict:
    """Analytical per-device HBM budget (bytes): the reference's formula
    (`repro.launch.dryrun.hbm_budget`, its tensor-parallel width `tp`
    16).  With fewer chips than `tp` the model is split over all of them:
    on one card (`chips=1`) tp=1 and the card holds it whole (the
    reference divides by chips // 16, which is 0 there)."""
    cfg, spec = _config(arch), _shape(shape)
    tp = min(tp, chips)
    n_params = cfg.param_count()
    p_bytes = 2 * n_params / chips           # bf16 params, fully sharded
    out = {"params": p_bytes}
    if spec.kind == "train":
        opt = opt_config_for(cfg)
        sd = 2 if opt.state_dtype == "bfloat16" else 4
        v_bytes = (0.02 if opt.factored_v else sd) * n_params / chips
        out["opt_mv"] = sd * n_params / chips + v_bytes
        out["master"] = (4 * n_params / chips) if opt.master_fp32 else 0.0
        out["grads"] = 2 * n_params / chips   # transient, sharded like params
        b_loc = spec.global_batch / (chips // tp) / microbatches_for(cfg)
        # per-layer remat checkpoints: seq-sharded residual stream
        out["act_checkpoints"] = (
            cfg.num_layers * b_loc * spec.seq_len / tp * cfg.d_model * 2)
        # working set of one rematerialised layer (hidden + ffn blocks, f32)
        out["layer_workspace"] = b_loc * spec.seq_len * cfg.d_model * 4 * 3
    elif spec.kind == "prefill":
        b_loc = spec.global_batch / (chips // tp)
        out["kv_cache_out"] = (cfg.num_layers * b_loc * spec.seq_len / tp *
                               2 * max(cfg.num_kv_heads, 1) * cfg.head_dim * 2)
        out["layer_workspace"] = b_loc * spec.seq_len * cfg.d_model * 4 * 3
    else:
        b_loc = max(spec.global_batch / (chips // tp), 1)
        seq_loc = spec.seq_len / tp
        if cfg.attention_free:
            h = cfg.d_model // cfg.head_dim
            out["state"] = (cfg.num_layers * b_loc *
                            (h * cfg.head_dim ** 2 + 2 * cfg.d_model) * 4)
        elif cfg.pattern:
            n_attn = sum(1 for i in range(cfg.num_layers)
                         if cfg.pattern[i % len(cfg.pattern)] == "attn")
            out["state"] = ((cfg.num_layers - n_attn) * b_loc *
                            cfg.lru_width * cfg.conv_width * 4 +
                            n_attn * b_loc * cfg.window * 2 *
                            cfg.num_kv_heads * cfg.head_dim * 2)
        else:
            out["kv_cache"] = (cfg.num_layers * b_loc * seq_loc * 2 *
                               cfg.num_kv_heads * cfg.head_dim * 2)
        out["logits"] = b_loc * cfg.vocab * 4
    out["total"] = float(sum(out.values()))
    return out


def analyse(traced: dict, chips: int = 1) -> dict:
    """The cell's record from `trace_cell`'s result: the reference's keys
    where they have a meaning on one card (FLOPs and bytes per device,
    the collective bytes: none on one card, the roofline terms, the
    budget and whether it fits),
    with the FLOPs by dtype class, the ops and each kernel's count."""
    c = traced["count"]
    out = {k: traced[k] for k in ("arch", "shape", "kind", "tokens")}
    out.update({
        "chips": chips,
        "flops_per_device": c["flops_total"],
        "flops_by_class": c["flops"],
        "bytes_per_device": c["bytes"],
        "collective_bytes_per_device": c["collective_bytes"],
        "ops": c["ops"],
        "kernels": c["kernels"],
        "roofline": cost.roofline_terms(c["flops"], c["bytes"],
                                        c["collective_bytes"]),
    })
    budget = hbm_budget(traced["arch"], traced["shape"], chips)
    out["memory"] = {"hbm_budget": budget,
                     "fits_hbm": bool(budget["total"] < H100_HBM)}
    return out


def run_cell(arch: str, shape: str, out_dir: str) -> dict:
    """Trace, analyse and write one cell's JSON; returns the record."""
    t0 = time.perf_counter()
    traced = trace_cell(arch, shape)
    result = analyse(traced)
    result["mesh"] = "1"
    result["trace_s"] = round(time.perf_counter() - t0, 3)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}_{shape}_1.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    cb.load_all()
    cells = cb.cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    failures = []
    for arch, shape in cells:
        tag = f"{arch} x {shape} x 1"
        try:
            r = run_cell(arch, shape, args.out)
            rf = r["roofline"]
            print(f"OK   {tag}: dominant={rf['dominant']} "
                  f"compute={rf['compute_s']:.3e}s "
                  f"mem={rf['memory_s']:.3e}s "
                  f"flops={r['flops_per_device']:.4e} "
                  f"bytes={r['bytes_per_device']:.4e} "
                  f"budget={r['memory']['hbm_budget']['total']:.4e} "
                  f"fits={r['memory']['fits_hbm']} "
                  f"(trace {r['trace_s']}s)", flush=True)
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e!r}", flush=True)
            traceback.print_exc()
    print(f"\n{len(cells) - len(failures)} passed, {len(failures)} failed")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
