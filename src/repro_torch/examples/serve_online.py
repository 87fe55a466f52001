"""Online multi-tenant serving demo: tenants arrive and leave mid-serve,
and the engine re-places them across cores with warm-state-aware migration
pricing (repro_torch.sched.online) instead of freezing the arrival-order
placement.  PyTorch port of `examples/serve_online.py`.

Each epoch the replacer re-solves placement through the contention model
and prices every implied move as predicted-contention-delta minus a
*measured* warm-state migration penalty — the mover's resumable
`FleetState` is replayed on its warm core and on a cold core, and the
cycle difference is what the move must pay back.

Every resumed segment — the per-epoch advances and both migration probes
— rides the interleaved engine's resumable entry (the window kernel on
the card) rather than the cycle-by-cycle scan; the demo instruments the
dispatcher to print which engine served each epoch.

    python -m repro_torch.examples.serve_online                  # card
    PYTHONPATH=src python -m repro_torch.examples.serve_online --device cpu

The engine serves llama4-maverick's smoke config (the smoke-config rule
of `repro_torch.examples`: head dim 64 on the card), weights drawn from
seed 0 on `--device` or the `params` given to `main`.
"""
import argparse
import contextlib

import numpy as np
import torch

from repro_torch import examples
from repro_torch.configs import base as cb
from repro_torch.core import simulator
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.sched import (ContentionModel, OnlineConfig,
                               PlacementConfig, TenantEvent)
from repro_torch.serve.engine import EngineConfig, SlotServeEngine, Tenant

ARCH = "llama4-maverick-400b-a17b"


@contextlib.contextmanager
def engine_log():
    """Tag every fleet-simulator dispatch while the block runs: the
    resumable interleaved entry vs the cycle-by-cycle scan."""
    calls = []
    real_resume = simulator._resume_fleet_interleaved
    real_scan = simulator._simulate_fleet_impl

    def spy_resume(*a, **k):
        calls.append("interleaved-resume")
        return real_resume(*a, **k)

    def spy_scan(*a, **k):
        calls.append("scan")
        return real_scan(*a, **k)

    simulator._resume_fleet_interleaved = spy_resume
    simulator._simulate_fleet_impl = spy_scan
    try:
        yield calls
    finally:
        simulator._resume_fleet_interleaved = real_resume
        simulator._simulate_fleet_impl = real_scan


PCFG = PlacementConfig(num_slots=4, miss_latency=50, quantum_cycles=2_000,
                       trace_len=3_000, steps_per_program=3_000)
OCFG = OnlineConfig(num_cores=2, epoch_steps=4_000, probe_steps=1_200,
                    placement=PCFG)

# churn: the two slot-hungry FM-class tenants are forced onto different
# cores by arrival order; light tenants churn around them
EVENTS = [
    TenantEvent(0, "arrive", "tenant0", "minver"),
    TenantEvent(0, "arrive", "tenant1", "cubic"),
    TenantEvent(1, "arrive", "tenant2", "crc32"),
    TenantEvent(1, "arrive", "tenant3", "tarfind"),
    TenantEvent(3, "depart", "tenant2"),
]


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

    # multi-epoch resumed serve of one core, state carried epoch to epoch:
    # each segment seeds the interleaved engine from the previous epoch's
    # FleetState (never the scan)
    print_fn("-- multi-epoch resumed serve (one core, state carried) --")
    benches = ("minver", "crc32")
    tr = np.stack([np.asarray(model.trace(b)) for b in benches])
    scens = [model.scenario_of(b) for b in benches]
    st = simulator.init_fleet_state(len(benches), PCFG.num_slots,
                                    OCFG.bs_cache_entries, device=dev)
    for epoch in range(3):
        with engine_log() as calls:
            res, st = simulator.simulate_many(
                tr, OCFG.reconfig(), scens, PCFG.scheduler(),
                total_steps=OCFG.epoch_steps, state=st, return_state=True,
                device=dev)
        print_fn(f"  epoch {epoch}: engine={'+'.join(calls)} "
                 f"cycles={res.cycles.cpu().numpy().tolist()} "
                 f"switches={int(res.switches)}")

    print_fn("-- online re-placement (warm-state-aware) --")
    with engine_log() as calls:
        rep = eng.serve_online(EVENTS, online_cfg=OCFG, model=model,
                               num_epochs=6, apply_core=0)
    print_fn(f"policy={rep.policy} epochs={rep.epochs} "
             f"migrations={rep.migrations} "
             f"worst slowdown={rep.worst_slowdown:.4f}")
    n_fast = sum(c == "interleaved-resume" for c in calls)
    n_scan = sum(c == "scan" for c in calls)
    print_fn(f"resumed dispatches during serve: {n_fast} "
             f"interleaved-resume, {n_scan} scan")
    for m in rep.moves:
        warm = ",".join(f"{w:.2f}" for w in m["warm_fraction"])
        print_fn(f"  epoch {m['epoch']}: move {m['tenants']} "
                 f"{m['src']}->{m['dst']} "
                 f"benefit={m['benefit_cycles']:.0f} "
                 f"penalty={m['penalty_cycles']:.0f} warm_frac=[{warm}] "
                 f"applied={m['applied']}")
    for ci, core in enumerate(rep.final_cores):
        print_fn(f"  core {ci}: {core}")
    print_fn(f"engine now serves core 0: {[t.name for t in eng.tenants]}; "
             f"{len(eng.deferred)} tenant(s) parked")
    if eng.tenants:
        out = eng.run(20)
        print_fn(f"core-0 round: hit_rate={out['hit_rate']:.3f} "
                 f"fills={out['fills']}")


if __name__ == "__main__":
    main()
