"""The training driver: the port's train step (`repro_torch.launch.train
.build`, i.e. `train.step.make_train_step`) on a state from
`optim.adamw.init_state` (`"kind": "train"` mixes).

Set-up builds the one step and state that the window drives and runs its
first `SETUP_STEPS` steps through the same call and feed (rows drawn from
(seed, step), all different).  From them it keeps what the reference is
held to: each step's loss, each leaf's norm of the first step's gradient
as the optimizer took it (its first moment after step 1 over 1 - b1) and
each leaf's norm of its change after step 3 (the f32 master less the
drawn weights).  The window then runs whole steps, each synchronised,
until the first step boundary after `seconds`.

With `trace`, the card's peak memory is read over the window and two
further steps are profiled on the card (`devtrace`).
"""
from __future__ import annotations

import time

import torch

from cardbench import devtrace, generate
from cardbench.tree import flatten

SETUP_STEPS = 4     # steps 1-3 are checked, step 4 is the last warm-up
CHECKED = 3
PROFILED_STEPS = 2


def build(model: dict, optimizer: dict, mix: dict):
    """(opt_cfg, the train step) of the port."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    cfg = ModelConfig(**model)
    opt_cfg = adamw.AdamWConfig(**optimizer)
    step, _, _, _ = launch_train.build(cfg, opt_cfg, mix["batch"],
                                       mix["seq"])
    return opt_cfg, step


def _norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(t.detach().double()))
            for p, t in flatten(tree)}


def readings(state, opt_cfg, cell, seed, dev, step_fn) -> tuple:
    """Run the first `SETUP_STEPS` steps on `state`; returns (state,
    {"loss": steps 1-3's, "grad_norm": {leaf: norm}, "change_norm":
    {leaf: norm}})."""
    out = {"loss": []}
    for i in range(1, SETUP_STEPS + 1):
        batch = {"tokens": generate.train_batch(cell.traffic, cell.model,
                                                seed, i, dev)}
        state, metrics = step_fn(state, batch)
        if i <= CHECKED:
            out["loss"].append(float(metrics["loss"]))
        if i == 1:
            out["grad_norm"] = {p: n / (1.0 - opt_cfg.b1) for p, n in
                                _norms(state.m).items()}
        if i == CHECKED:
            drawn = cell.reference.draw(cell.model, seed, dev)
            ref = state.master if state.master is not None else state.params
            out["change_norm"] = {
                p: float(torch.linalg.vector_norm(
                    (t.detach().float() - w.float()).double()))
                for (p, t), (_, w) in zip(flatten(ref), flatten(drawn))}
            del drawn
    return state, out


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, hooks=None) -> dict:
    """One run of a training cell; returns the driver's record (see
    `run.py`).  `hooks` (tests) may replace the train step."""
    from repro_torch.optim import adamw

    mix, model = cell.traffic, cell.model
    dev = torch.device(device)
    opt_cfg, step_fn = build(model, cell.config["optimizer"], mix)
    if hooks and "step" in hooks:
        step_fn = hooks["step"](step_fn)
    state = adamw.init_state(opt_cfg, cell.reference.draw(model, seed, dev))
    state, checked = readings(state, opt_cfg, cell, seed, dev, step_fn)
    if trace and dev.type == "cuda":
        devtrace.warm()
    setup_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    i = SETUP_STEPS + 1
    steps = 0
    t0 = time.perf_counter()
    t_close = t0
    while t_close < t0 + seconds:
        batch = {"tokens": generate.train_batch(mix, model, seed, i, dev)}
        state, _ = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_close = time.perf_counter()
        i += 1
        steps += 1
    rec = {"window_s": t_close - t0, "setup_s": setup_s, "steps": steps,
           "tokens": steps * mix["batch"] * mix["seq"], "checked": checked,
           "attempted": steps, "failed": 0}
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else 0
    rec["window_peak_bytes"] = window_peak
    rec["memory_peak_bytes"] = max(setup_peak, window_peak)
    if trace:
        prof = {}
        if dev.type == "cuda":
            with devtrace.session(prof):
                for _ in range(PROFILED_STEPS):
                    batch = {"tokens": generate.train_batch(
                        mix, model, seed, i, dev)}
                    state, _ = step_fn(state, batch)
                    i += 1
        prof["steps"] = PROFILED_STEPS
        rec["profile"] = prof
    del state
    return rec


def end_to_end(rec) -> dict:
    return {"train_tokens_per_s": rec["tokens"] / rec["window_s"]}


def correctness(rec, cell, seed: int, device) -> dict:
    """The reference's three steps from the same weights (drawn again
    from the seed) and rows, against the program's readings."""
    from cardbench import check
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    drawn = cell.reference.draw(cell.model, seed, dev)
    ref = check.train_reference(cell, drawn, seed, dev)
    return check.train_numbers(rec["checked"], ref)
