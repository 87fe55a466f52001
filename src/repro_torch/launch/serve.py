"""Serving entry point: continuous batching + slot-resident experts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \
        --smoke --device cpu --requests 12 --batch 4 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --smoke --device cpu   # or rwkv6-7b

PyTorch port of `repro.launch.serve`: random weights from a seeded
`torch.Generator`, requests of random prompts rolled through
`serve.engine.model_batcher`, one line of report.  On the card, prefill
runs the flash kernel and every decode step the decode kernel; MoE archs
run `moe_gmm` at prefill and `moe_gmm_skip` at each decode step;
recurrentgemma runs `rglru_scan` in its recurrent blocks and the
attention kernels over its 2,048-token window (a prompt longer than the
window must be a multiple of it, as in the JAX model), rwkv6
`rwkv6_scan` in every block, at prefill and at each decode step.
`--prompt-len LO[:HI]` draws each prompt's length from LO..HI (the JAX
launcher's prompts are 4 tokens, the default); with one length the
prompts are the JAX launcher's draws.  MoE archs then run the
launcher's expert-slot half: three tenants with banded router biases
decode 48 steps through `SlotServeEngine` (quantum 16 tokens,
`--slots` resident experts, `--hit-bias`), reported under
"expert_slots".  The tenants' tokens come from the generator that drew
the prompts, after them, as in the JAX launcher.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import (EngineConfig, SlotServeEngine, Tenant,
                                      model_batcher)

SLOT_TENANTS, SLOT_STEPS, SLOT_QUANTUM = 3, 48, 16


def requests(cfg, n: int, new_tokens: int, prompt_len: tuple[int, int],
             seed: int | np.random.Generator = 0) -> list[Request]:
    """`n` requests of random prompts, lengths drawn from
    prompt_len[0]..prompt_len[1] by a numpy generator (or one seeded
    with `seed`)."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    out = []
    for i in range(n):
        t = lo if lo == hi else int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
        out.append(Request(i, prompt, max_new_tokens=new_tokens))
    return out


def slot_tenants(cfg, rng: np.random.Generator) -> list[Tenant]:
    """The JAX launcher's three tenants: (2, 8) tokens each drawn from
    `rng` and a router bias of +6 on a band of a third of the experts,
    -6 elsewhere."""
    e = cfg.num_experts
    tenants = []
    for i in range(SLOT_TENANTS):
        bias = np.full((e,), -6.0, np.float32)
        lo = (i * e // SLOT_TENANTS) % e
        bias[lo:lo + e // SLOT_TENANTS + 1] = 6.0
        tenants.append(Tenant(
            name=f"tenant{i}",
            tokens=rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
            router_bias=bias))
    return tenants


@torch.no_grad()
def serve(arch: str, *, smoke: bool = False, device="cuda",
          num_requests: int = 12, batch: int = 4, max_len: int = 64,
          new_tokens: int = 8, prompt_len: tuple[int, int] = (4, 4),
          slots: int = 4, hit_bias: float = 0.0) -> dict:
    """Serve `num_requests` requests of `arch` (weights and prompts from
    seed 0) and return the batcher's report, with the seconds from the
    first admission to the last token (synchronised) and the generated
    tokens per second.  For an MoE arch, the expert-slot half follows
    (`slots` resident experts, slot-hit routing bias `hit_bias`), its
    report under "expert_slots" with its own synchronised seconds."""
    cb.load_all()
    cfg = cb.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    dev = resolve_device(device)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batcher = model_batcher(cfg, params, batch, max_len, device=dev)
    rng = np.random.default_rng(0)
    reqs = requests(cfg, num_requests, new_tokens, prompt_len, rng)
    for r in reqs:
        batcher.submit(r)
    t0 = time.perf_counter()
    report = batcher.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in reqs)
    report.update(seconds=secs, generated_tokens=tokens,
                  tokens_per_s=tokens / secs if secs > 0 else 0.0,
                  prompt_tokens=int(sum(len(r.prompt) for r in reqs)),
                  device=str(dev))
    if cfg.is_moe:
        eng = SlotServeEngine(
            cfg, params,
            EngineConfig(quantum_tokens=SLOT_QUANTUM, slots_per_shard=slots,
                         hit_bias=hit_bias),
            slot_tenants(cfg, rng), max_len=max_len, device=dev)
        t0 = time.perf_counter()
        slot_report = eng.run(SLOT_STEPS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        report["expert_slots"] = dict(slot_report,
                                      seconds=time.perf_counter() - t0)
    return report


def _prompt_len(text: str) -> tuple[int, int]:
    lo, _, hi = text.partition(":")
    return int(lo), int(hi or lo)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=_prompt_len, default=(4, 4),
                    metavar="LO[:HI]")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--hit-bias", type=float, default=0.0)
    args = ap.parse_args(argv)
    report = serve(args.arch, smoke=args.smoke, device=args.device,
                   num_requests=args.requests, batch=args.batch,
                   max_len=args.max_len, new_tokens=args.new_tokens,
                   prompt_len=args.prompt_len, slots=args.slots,
                   hit_bias=args.hit_bias)
    slots = report.pop("expert_slots", None)
    print("continuous batching:", json.dumps(report))
    if slots is not None:
        print("expert slots:", json.dumps(slots))


if __name__ == "__main__":
    main()
