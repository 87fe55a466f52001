"""Multi-tenant slot-resident MoE serving demo — the paper's architecture
(disambiguator + slots + round-robin quantum) applied to expert serving,
now with contention-aware admission: instead of serving tenants in arrival
order, the engine asks `repro_torch.sched` which tenants should co-reside
and which should be deferred to another replica/round.  PyTorch port of
`examples/serve_multitenant.py`.

    python -m repro_torch.examples.serve_multitenant              # card
    PYTHONPATH=src python -m repro_torch.examples.serve_multitenant \\
        --device cpu

It serves llama4-maverick's smoke config (the smoke-config rule of
`repro_torch.examples`: head dim 64 on the card) with weights drawn from
seed 0 on `--device`, or the `params` given to `main`.
"""
import argparse

import numpy as np
import torch

from repro_torch import examples
from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.sched import ContentionModel, PlacementConfig
from repro_torch.serve.engine import EngineConfig, SlotServeEngine, Tenant

ARCH = "llama4-maverick-400b-a17b"

# each serving tenant's instruction-mix profile: the benchmark whose slot
# behaviour best matches its routing churn (FM-class = slot-hungry,
# M-class = light)
TENANT_PROFILES = {"tenant0": "minver", "tenant1": "nbody",
                   "tenant2": "crc32"}


def admission_demo(cfg, params, tenants, dev, print_fn=print):
    print_fn("-- contention-aware admission (repro_torch.sched) --")
    eng = SlotServeEngine(
        cfg, params, EngineConfig(quantum_tokens=16, slots_per_shard=4),
        [Tenant(t.name, t.tokens, t.router_bias) for t in tenants],
        max_len=70, device=dev)
    model = ContentionModel(PlacementConfig(
        num_slots=4, quantum_cycles=2_000,
        trace_len=4_000, steps_per_program=4_000), device=dev)
    plan = eng.plan_coresidency(TENANT_PROFILES, slo=1.2, num_cores=2,
                                model=model)
    print_fn(f"slo=1.2 cores=2: admitted={plan.admitted} "
             f"deferred={plan.deferred} "
             f"predicted worst slowdown={plan.predicted_worst:.3f}")
    for ci, core in enumerate(plan.placement.cores if plan.placement
                              else ()):
        print_fn(f"  core {ci}: {core} "
                 f"({[TENANT_PROFILES[n] for n in core]})")
    kept = eng.apply_admission(plan, core=0)
    print_fn(f"serving core 0 with {[t.name for t in kept]}; "
             f"{len(eng.deferred)} tenant(s) parked")
    rep = eng.run(30)
    print_fn(f"core-0 round: hit_rate={rep['hit_rate']:.3f} "
             f"fills={rep['fills']}")


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
    tenants = []
    for i in range(3):  # three "processes" with distinct expert mixes
        bias = np.full((cfg.num_experts,), -6.0, np.float32)
        bias[i * 3:(i * 3) + 4] = 6.0
        tenants.append(Tenant(
            name=f"tenant{i}",
            tokens=rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
            router_bias=bias))

    for slots in (2, 4):
        for bias in (0.0, 4.0):
            eng = SlotServeEngine(
                cfg, params,
                EngineConfig(quantum_tokens=16, slots_per_shard=slots,
                             hit_bias=bias),
                [Tenant(t.name, t.tokens, t.router_bias) for t in tenants],
                max_len=70, device=dev)
            rep = eng.run(60)
            print_fn(f"slots={slots} hit_bias={bias}: "
                     f"hit_rate={rep['hit_rate']:.3f} fills={rep['fills']} "
                     f"modelled fill time={rep['fill_seconds'] * 1e3:.2f} "
                     f"ms")

    admission_demo(cfg, params, tenants, dev, print_fn)


if __name__ == "__main__":
    main()
