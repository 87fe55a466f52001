"""The serving driver: `repro_torch.serve.engine.model_batcher` under a
closed loop of clients (`"kind": "serve"` mixes).

Set-up draws the weights, builds the batcher, warms up the mix's
shortest and longest prompt and a decode step, and runs the loop's ramp:
`clients` clients, client i first sending at decode step i x
`stagger_steps`, each sending its next request (from `generate.requests`)
as soon as its last one has finished.  The window opens once the last
client has joined; its requests are those sent in it, its gaps those
between two tokens that both came in it.  A request's times come from the
host clock after each `batcher.step()` returns (the decode callback has
copied the tokens to the host by then): sent, prefill start (the
benchmark's wrapper around the prefill callback), each token.  The window
closes at the first step boundary after `seconds`; requests sent in it
that have no first token yet are stepped on until they have one.

With `trace`, the callbacks are synchronised and timed (spans), the
prefill's expert loads are kept, and a few seconds of the same loop
after the window are profiled on the card (`devtrace`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from cardbench import devtrace, generate, stats
from cardbench.work import flops


class Record:
    __slots__ = ("rid", "prompt", "new", "sent", "admitted", "tokens",
                 "times", "client")

    def __init__(self, rid, prompt, new, sent, client):
        self.rid, self.prompt, self.new = rid, prompt, new
        self.sent, self.client = sent, client
        self.admitted = None
        self.tokens, self.times = [], []


class Loop:
    """The closed loop of clients around one batcher."""

    def __init__(self, batcher, mix, model, seed, sync):
        from repro_torch.serve.batching import Request
        self.Request = Request
        self.b = batcher
        self.mix = mix
        self.stream = generate.requests(mix, model, seed)
        self.sync = sync
        self.records: dict[int, Record] = {}
        self.busy = [False] * mix["clients"]
        self.live = {}           # rid -> the batcher's Request, unfinished
        self.next_rid = 0
        self.steps = 0
        self.open = True
        self.spans = {"prefill": [], "decode": []}
        self.loads = []          # each prefill's expert loads (layers, E)
        self.routes = []         # each decode step's (rids, [ids (B, k)])
        self.routing = None      # the decode step's ids while it runs
        self._wrap()

    def _wrap(self):
        pre, dec = self.b._prefill_row, self.b._decode
        loop = self

        def prefill_row(row, tokens):
            req = loop.b.rows[row].request
            rec = loop.records.get(req.rid)
            t0 = time.perf_counter()
            if rec is not None:
                rec.admitted = t0
            pre(row, tokens)
            if loop.sync:
                torch.cuda.synchronize()
                loop.spans["prefill"].append(
                    (len(tokens), time.perf_counter() - t0))

        def decode(tokens, positions):
            rids = [-1 if r.request is None else r.request.rid
                    for r in loop.b.rows]
            loop.routing = []
            t0 = time.perf_counter()
            out = dec(tokens, positions)      # copied to the host: synced
            if loop.sync:
                loop.spans["decode"].append(time.perf_counter() - t0)
            loop.routes.append((rids, loop.routing))
            loop.routing = None
            return out

        self.b._prefill_row, self.b._decode = prefill_row, decode

    def _send(self, now):
        for c in range(len(self.busy)):
            if self.busy[c] or self.steps < c * self.mix["stagger_steps"]:
                continue
            prompt, new = next(self.stream)
            rid = self.next_rid
            self.next_rid += 1
            self.records[rid] = Record(rid, prompt, new, now, c)
            req = self.Request(rid=rid, prompt=prompt, max_new_tokens=new)
            self.live[rid] = req
            self.b.submit(req)
            self.busy[c] = True

    def step(self) -> float:
        """One `batcher.step()`, sending first while the loop is open;
        returns the host time after it."""
        if self.open:
            self._send(time.perf_counter())
        self.b.step()
        now = time.perf_counter()
        self.steps += 1
        for rid, req in list(self.live.items()):
            rec = self.records[rid]
            fresh = req.generated[len(rec.tokens):]
            rec.tokens.extend(int(t) for t in fresh)
            rec.times.extend([now] * len(fresh))
            if req.done:
                del self.live[rid]
                self.busy[rec.client] = False
        return now


def _keep_routes(loop):
    """Keep the expert ids that each decode step's router chose, on the
    device (the check follows them, `check.serve_gaps`)."""
    from repro_torch.models import moe
    inner = moe.route

    def route(*a, **k):
        ids, gates = inner(*a, **k)
        if loop.routing is not None:     # a copy: ids views a (B, E) sort
            loop.routing.append(ids.clone())
        return ids, gates

    moe.route = route
    return lambda: setattr(moe, "route", inner)


def warm_up(batcher, mix, model, seed) -> None:
    """A prefill of the mix's shortest and longest prompt and their decode
    steps, through the batcher itself; its logs are cleared after."""
    from repro_torch.serve.batching import Request
    rng = np.random.default_rng(generate.seed64(seed, 7))
    for i, t in enumerate((mix["prompt_len"]["lo"], mix["prompt_len"]["hi"])):
        prompt = rng.integers(0, model["vocab"], size=int(t)).astype(
            np.int32)
        batcher.submit(Request(rid=-1 - i, prompt=prompt, max_new_tokens=2))
    while batcher.queue or any(r.request for r in batcher.rows):
        batcher.step()
    batcher.finished.clear()
    batcher.occupancy_log.clear()
    batcher.steps = 0


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, hooks=None) -> dict:
    """One run of a serving cell; returns the driver's record (see
    `run.py`).  `hooks` (tests) may replace the batcher's callbacks."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve import engine

    mix, model = cell.traffic, cell.model
    dev = torch.device(device)
    cfg = ModelConfig(**model)
    params = cell.reference.draw(model, seed, dev)
    batcher = engine.model_batcher(cfg, params, mix["batch"],
                                   mix["max_len"], device=dev)
    if hooks and "batcher" in hooks:
        hooks["batcher"](batcher)
    warm_up(batcher, mix, model, seed)
    if trace and dev.type == "cuda":
        devtrace.warm()
    loop = Loop(batcher, mix, model, seed, sync=trace and dev.type == "cuda")
    unroute = _keep_routes(loop)
    if trace:
        _keep_loads(loop)
    while loop.steps <= (mix["clients"] - 1) * mix["stagger_steps"]:
        loop.step()             # the ramp: every client has joined after it
    loop.spans = {"prefill": [], "decode": []}
    loop.loads.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    end = t0 + seconds
    t_close = t0
    while t_close < end:
        t_close = loop.step()
    loop.open = False
    window = t_close - t0
    sent = [r for r in loop.records.values() if t0 <= r.sent < t_close]
    wait_until = time.perf_counter() + 60.0
    while any(not r.tokens for r in sent) and \
            time.perf_counter() < wait_until:
        loop.step()
    rec = {"window_s": window, "setup_s": setup_s, "loop": loop,
           "sent": sent, "t0": t0, "t_close": t_close,
           "attempted": len(sent),
           "failed": sum(1 for r in sent if not r.tokens)}
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if dev.type == "cuda" else 0)
    if trace:
        rec["profile"] = _profile(loop) if dev.type == "cuda" else {}
        loop.restore()
    unroute()
    rec["finished"] = [r for r in sent if len(r.tokens) >= r.new]
    rec["params"] = params
    del batcher, loop.b
    return rec


def _keep_loads(loop):
    """Keep each prefill's expert loads (`aux`), as device tensors: the
    prefill callback discards them."""
    from repro_torch.models import transformer
    inner = transformer.prefill

    def prefill(cfg, params, batch, *a, **k):
        logits, cache, aux = inner(cfg, params, batch, *a, **k)
        loads = [blk["expert_load"] for seg in aux for blk in seg
                 if isinstance(blk, dict) and "expert_load" in blk]
        if loads:
            loop.loads.append(torch.cat(loads))
        return logits, cache, aux

    transformer.prefill = prefill
    loop.restore = lambda: setattr(transformer, "prefill", inner)


PROFILE_S = 3.0


def _profile(loop) -> dict:
    """`PROFILE_S` seconds more of the loop, sending again, profiled."""
    loop.open = True
    loop.sync = False
    out = {}
    n_loads = len(loop.loads)
    tokens = sum(len(r.tokens) for r in loop.records.values())
    with devtrace.session(out):
        t_end = time.perf_counter() + PROFILE_S
        while time.perf_counter() < t_end:
            loop.step()
    out["tokens"] = sum(len(r.tokens) for r in loop.records.values()) - \
        tokens
    out["prefill_loads"] = loop.loads[n_loads:]
    loop.open = False
    return out


def window_tokens(rec) -> int:
    """The tokens the clients received in the window."""
    t0, t_close = rec["t0"], rec["t_close"]
    return sum(1 for r in rec["loop"].records.values() for t in r.times
               if t0 <= t <= t_close)


def end_to_end(rec) -> dict:
    """The cell's end-to-end numbers from the window's record."""
    t_close = rec["t_close"]
    tokens = window_tokens(rec)
    ttft = [1e3 * (r.times[0] - r.sent) for r in rec["sent"] if r.times]
    itl = [1e3 * (b - a) for r in rec["loop"].records.values()
           for a, b in zip(r.times, r.times[1:]) if rec["t0"] <= a and
           b <= t_close]
    return {"output_tokens_per_s": tokens / rec["window_s"],
            "ttft_p95_ms": stats.percentile(ttft, 95),
            "itl_p95_ms": stats.percentile(itl, 95)}


def window_flops(rec, model) -> float:
    """Model FLOPs of the prompts prefilled and tokens generated in the
    window."""
    loop, t0, t_close = rec["loop"], rec["t0"], rec["t_close"]
    total = 0.0
    for r in loop.records.values():
        if r.admitted is not None and t0 <= r.admitted <= t_close:
            total += flops.prefill(model, len(r.prompt))
        for j, t in enumerate(r.times):
            if t0 <= t <= t_close:
                total += flops.decode_token(model, len(r.prompt) + j)
    return total


def sample(rec, mix, seed) -> list:
    """The finished requests to check, drawn from the seed: the longest
    first (prompt and answer), then others until `sample_tokens` served
    tokens.  Each is (prompt, served tokens, the expert ids (n, layers, k)
    that its n decode steps took, or None without experts)."""
    done = sorted(rec["finished"], key=lambda r: r.rid)
    if not done:
        return []
    rng = np.random.default_rng(generate.seed64(seed, 11))
    longest = max(done, key=lambda r: (len(r.prompt) + r.new, -r.rid))
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out, n = [longest], longest.new
    for r in rest:
        if n >= mix["sample_tokens"]:
            break
        out.append(r)
        n += r.new
    routes = _routes_of({r.rid for r in out}, rec["loop"].routes)
    return [(r.prompt, np.asarray(r.tokens[:r.new], np.int64),
             routes.get(r.rid)) for r in out]


def _routes_of(rids, steps) -> dict:
    """{rid: (steps, layers, k) expert ids of its decode steps, in order}
    of the requests `rids`, from the loop's decode steps."""
    if not steps or not steps[0][1]:
        return {}
    ids = torch.stack([torch.stack(i) for _, i in steps]).cpu()
    rows = {}
    for s, (step_rids, _) in enumerate(steps):
        for row, rid in enumerate(step_rids):
            if rid in rids:
                rows.setdefault(rid, []).append(ids[s, :, row])
    return {rid: torch.stack(v) for rid, v in rows.items()}


def correctness(rec, cell, seed: int, device) -> dict:
    """The sample's served tokens against the reference's logits."""
    from cardbench import check
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    picked = sample(rec, cell.traffic, seed)
    if not picked:
        return {"logit_gap": None}
    return check.serve_gaps(cell, rec.pop("params"), picked)
