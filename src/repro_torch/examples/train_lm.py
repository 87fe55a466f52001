"""End-to-end driver: train a ~100M-param LM for a few hundred steps with
the full stack (train step, deterministic pipeline, checkpoint/restart,
straggler monitoring).  PyTorch port of `examples/train_lm.py`.

    python -m repro_torch.examples.train_lm --steps 300            # card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny \\
        --device cpu                                                # CPU

`--tiny` trains granite's smoke config: on the CPU exactly, on the card
with head dim 64 (the smoke-config rule of `repro_torch.examples`); the
first line is the config it trains.  Checkpoints go to `--ckpt-dir`, or
to a temporary directory removed at the end.
"""
import argparse
import dataclasses
import tempfile

from repro_torch import examples
from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    cb.load_all()
    dev = resolve_device(args.device)
    base = cb.get_config("granite-3-2b")
    if args.tiny:
        cfg = examples.smoke_config("granite-3-2b", dev)
    else:  # ~100M params: 8 x 512 with a 16k vocab
        cfg = dataclasses.replace(
            base, name="granite-100m", num_layers=8, d_model=512,
            num_heads=8, num_kv_heads=4, d_ff=2048, vocab=16384,
            head_dim=64, dtype="float32", remat="none", loss_chunk=0,
            skip_shapes={})
        cb.register(cfg)
    print(examples.config_line(cfg, dev))
    with tempfile.TemporaryDirectory() as tmp:
        report = train_mod.run(
            cfg.name, smoke=False, steps=args.steps, batch=4, seq=128,
            ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50, log_every=10,
            device=dev)
    print(f"final loss {report['losses'][-1]:.4f} after "
          f"{report['final_step']} steps "
          f"({report['restarts']} restarts, "
          f"{len(report['straggler_events'])} straggler events, "
          f"{report['tokens_per_s']:.0f} tokens/s)")


if __name__ == "__main__":
    main()
