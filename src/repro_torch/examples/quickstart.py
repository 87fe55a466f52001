"""Quickstart: train a tiny granite-family LM and decode from it.
PyTorch port of `examples/quickstart.py`.

    python -m repro_torch.examples.quickstart                  # card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

It runs granite's smoke config: on the CPU exactly, on the card with head
dim 64 (the smoke-config rule of `repro_torch.examples`), and prints it
first.
"""
import argparse
import tempfile

import torch

from repro_torch import examples
from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    cb.load_all()
    dev = resolve_device(args.device)
    cfg = examples.smoke_config("granite-3-2b", dev)
    print(examples.config_line(cfg, dev))
    # 1. train a reduced granite config for a few steps (full driver:
    #    deterministic data, checkpointing, fault supervision)
    with tempfile.TemporaryDirectory() as tmp:
        report = train_mod.run(cfg.name, smoke=False, steps=20,
                               batch=4, seq=64, ckpt_dir=tmp, ckpt_every=10,
                               log_every=5, device=dev)
    print(f"trained to step {report['final_step']}; "
          f"loss {report['losses'][0]:.3f} -> {report['losses'][-1]:.3f}")

    # 2. greedy-decode a few tokens with the prefill/decode serving path
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = torch.tensor([[5, 17, 9, 2]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache, _ = transformer.prefill(cfg, params,
                                               {"tokens": prompt})
        # pad the prefill cache to the decode horizon
        t0, horizon = prompt.shape[1], 16
        cache = [[{k: torch.nn.functional.pad(
            c[k], (0, 0, 0, 0, 0, horizon - t0)) for k in c} for c in seg]
            for seg in cache]
        toks = []
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for step in range(t0, horizon):
            toks.append(int(tok[0, 0]))
            logits, cache, _ = transformer.decode_step(
                cfg, params, {"tokens": tok,
                              "positions": torch.full((1,), step,
                                                      dtype=torch.int32,
                                                      device=dev)}, cache)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
    print("decoded token ids:", toks)


if __name__ == "__main__":
    main()
