"""Fault-storm serving demo: the online serve survives core losses, slot
SEUs, bitstream flushes and reconfig stalls with warm-state-aware
recovery (repro_torch.sched.faults + repro_torch.sched.online).  PyTorch
port of `examples/serve_faulty.py`.

A seeded random storm (`FaultPlan.storm`) hits a 3-core fleet mid-serve.
The replacer detects each fault at its epoch, evacuates tenants off lost
cores through the contention model (a mandatory move — priced for
destination choice only), retries attempts blocked by a stalled
reconfiguration port with capped exponential backoff, and prices
degraded cores at their reduced slot width.  The demo prints the
structured FaultLog the report carries, then shows a crash-restart: the
serve is killed after a mid-run checkpoint and resumed from the snapshot
in a fresh replacer, finishing bit-for-bit identical.

    python -m repro_torch.examples.serve_faulty                  # card
    PYTHONPATH=src python -m repro_torch.examples.serve_faulty --device cpu

The engine holds llama4-maverick's smoke config (the smoke-config rule
of `repro_torch.examples`: head dim 64 on the card), weights drawn from
seed 0 on `--device` or the `params` given to `main`.
"""
import argparse

import numpy as np
import torch

from repro_torch import examples
from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.sched import (ContentionModel, FaultPlan, OnlineConfig,
                               OnlineReplacer, PlacementConfig, TenantEvent)
from repro_torch.serve.engine import EngineConfig, SlotServeEngine, Tenant

ARCH = "llama4-maverick-400b-a17b"

PCFG = PlacementConfig(num_slots=4, miss_latency=50, quantum_cycles=2_000,
                       trace_len=3_000, steps_per_program=3_000)
OCFG = OnlineConfig(num_cores=3, epoch_steps=4_000, probe_steps=1_200,
                    placement=PCFG)
NUM_EPOCHS = 10

EVENTS = [
    TenantEvent(0, "arrive", "tenant0", "minver"),
    TenantEvent(0, "arrive", "tenant1", "cubic"),
    TenantEvent(1, "arrive", "tenant2", "crc32"),
    TenantEvent(1, "arrive", "tenant3", "tarfind"),
    TenantEvent(3, "depart", "tenant2"),
]

STORM = FaultPlan.storm(seed=11, num_epochs=NUM_EPOCHS, num_cores=3,
                        p_core_loss=0.18, p_seu=0.2, p_flush=0.15,
                        p_stall=0.15)


def main(argv=None, print_fn=print, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    cb.load_all()
    dev = resolve_device(args.device)
    cfg = examples.smoke_config(ARCH, dev)
    print_fn(examples.config_line(cfg, dev))
    if params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tenants = [Tenant(name=f"tenant{i}",
                      tokens=rng.integers(0, cfg.vocab, (2, 8)).astype(
                          np.int32))
               for i in range(4)]
    eng = SlotServeEngine(
        cfg, params, EngineConfig(quantum_tokens=16, slots_per_shard=4),
        tenants, max_len=70, device=dev)
    model = ContentionModel(PCFG, device=dev)

    print_fn(f"-- fault storm: {len(STORM.events)} event(s) --")
    for ev in STORM.events:
        print_fn(f"  epoch {ev.epoch}: {ev.kind} on core {ev.core}")

    print_fn("-- serve under the storm (warm recovery) --")
    rep = eng.serve_online(EVENTS, online_cfg=OCFG, model=model,
                           num_epochs=NUM_EPOCHS, faults=STORM,
                           recovery="warm")
    print_fn(f"policy={rep.policy} recovery={rep.recovery} "
             f"epochs={rep.epochs} migrations={rep.migrations} "
             f"evacuations={rep.evacuations}")
    print_fn(f"worst slowdown={rep.worst_slowdown:.4f} "
             f"worst lifetime slowdown={rep.worst_lifetime_slowdown:.4f}")
    print_fn("-- fault log --")
    for f in rep.fault_log:
        detail = {k: v for k, v in f.items()
                  if k not in ("epoch", "kind")}
        print_fn(f"  epoch {f['epoch']}: {f['kind']} {detail}")

    # crash-restart: serve again with a mid-run checkpoint, restore it
    # into a fresh replacer and finish — the reports must coincide
    print_fn("-- crash-restart from a mid-run checkpoint --")
    snaps = {}
    full = OnlineReplacer(OCFG, model=model, policy="warm", faults=STORM,
                          recovery="warm", device=dev)
    full_rep = full.run(EVENTS, NUM_EPOCHS, checkpoint_every=4,
                        save_fn=lambda s, e: snaps.setdefault(e, s))
    epoch, snap = sorted(snaps.items())[0]
    fresh = OnlineReplacer(OCFG, model=ContentionModel(PCFG, device=dev),
                           policy="warm", faults=STORM, recovery="warm",
                           device=dev)
    fresh.restore(snap)
    resumed = fresh.run(EVENTS, NUM_EPOCHS)
    match = (resumed.per_tenant == full_rep.per_tenant
             and resumed.fault_log == full_rep.fault_log
             and resumed.final_cores == full_rep.final_cores)
    print_fn(f"restored at epoch {epoch}; bit-for-bit match: {match}")
    assert match


if __name__ == "__main__":
    main()
