"""Serving entry point: continuous batching over a fixed-width decode batch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --smoke --device cpu --requests 12 --batch 4 --max-len 64

PyTorch port of `repro.launch.serve`: random weights from a seeded
`torch.Generator`, requests of random prompts rolled through
`serve.engine.model_batcher`, one line of report.  On the card, prefill
runs the flash kernel and every decode step the decode kernel.
`--prompt-len LO[:HI]` draws each prompt's length from LO..HI (the JAX
launcher's prompts are 4 tokens, the default); with one length the
prompts are the JAX launcher's draws.  MoE archs raise: their
slot-resident expert accounting comes with the MoE serving slice.
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
from repro_torch.serve.engine import model_batcher


def requests(cfg, n: int, new_tokens: int, prompt_len: tuple[int, int],
             seed: int = 0) -> list[Request]:
    """`n` requests of random prompts, lengths drawn from
    prompt_len[0]..prompt_len[1] by a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    out = []
    for i in range(n):
        t = lo if lo == hi else int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, cfg.vocab, (t,)).astype(np.int32)
        out.append(Request(i, prompt, max_new_tokens=new_tokens))
    return out


def serve(arch: str, *, smoke: bool = False, device="cuda",
          num_requests: int = 12, batch: int = 4, max_len: int = 64,
          new_tokens: int = 8,
          prompt_len: tuple[int, int] = (4, 4)) -> dict:
    """Serve `num_requests` requests of `arch` (weights and prompts from
    seed 0) and return the batcher's report, with the seconds from the
    first admission to the last token (synchronised) and the generated
    tokens per second."""
    cb.load_all()
    cfg = cb.get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if cfg.is_moe:
        raise NotImplementedError(
            f"{arch} is an MoE arch: its serving path (moe blocks, expert "
            f"slots, SlotServeEngine) comes with the MoE serving slice")
    dev = resolve_device(device)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batcher = model_batcher(cfg, params, batch, max_len, device=dev)
    reqs = requests(cfg, num_requests, new_tokens, prompt_len)
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
    args = ap.parse_args(argv)
    report = serve(args.arch, smoke=args.smoke, device=args.device,
                   num_requests=args.requests, batch=args.batch,
                   max_len=args.max_len, new_tokens=args.new_tokens,
                   prompt_len=args.prompt_len)
    print("continuous batching:", json.dumps(report))


if __name__ == "__main__":
    main()
