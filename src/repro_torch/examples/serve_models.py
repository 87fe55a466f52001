"""Model-fleet serving demo: the in-repo model zoo, lowered to traces and
served end-to-end (repro_torch.workloads + repro_torch.sched +
repro_torch.sched.online).  PyTorch port of `examples/serve_models.py`.

The pipeline in one script:

  1. lower two configs through `repro_torch.workloads` — count the smoke
     prefill/decode steps' ops (the port's counter runs the smoke models
     on the CPU, as the JAX package compiles them for the CPU) into an
     OpCount mix over the RV32IMF isa groups, and print the tables side
     by side (prefill lowers F-hot, decode lowers base-heavy);
  2. place a mixed prefill/decode model fleet with `place_tenants` —
     tenant names are "<arch>:<phase>" workload names, resolved by the
     same `ContentionModel` the Embench studies use;
  3. run a short online serve over arrival/departure events for those
     same model tenants, with a seeded `FaultPlan.storm` hitting the
     fleet mid-serve — chaos recovery machinery, unchanged, on a
     model-zoo fleet.

    python -m repro_torch.examples.serve_models                  # card
    PYTHONPATH=src python -m repro_torch.examples.serve_models --device cpu

The placement and the serve simulate on `--device` (the window kernel on
the card).
"""
import argparse

from repro_torch import workloads
from repro_torch.core import isa
from repro_torch.device import resolve_device
from repro_torch.sched import (ContentionModel, FaultPlan, OnlineConfig,
                               OnlineReplacer, PlacementConfig, TenantEvent,
                               place_tenants)

PCFG = PlacementConfig(num_slots=4, miss_latency=50, quantum_cycles=2_000,
                       trace_len=3_000, steps_per_program=3_000)
OCFG = OnlineConfig(num_cores=2, epoch_steps=4_000, probe_steps=1_200,
                    placement=PCFG)
NUM_EPOCHS = 8

FLEET = {
    "svc0": "qwen1.5-4b:prefill",
    "svc1": "recurrentgemma-9b:prefill",
    "svc2": "qwen1.5-4b:decode",
    "svc3": "musicgen-medium:decode",
}

EVENTS = [
    TenantEvent(0, "arrive", "svc0", FLEET["svc0"]),
    TenantEvent(0, "arrive", "svc2", FLEET["svc2"]),
    TenantEvent(1, "arrive", "svc1", FLEET["svc1"]),
    TenantEvent(2, "arrive", "svc3", FLEET["svc3"]),
    TenantEvent(5, "depart", "svc2"),
]

STORM = FaultPlan.storm(seed=7, num_epochs=NUM_EPOCHS, num_cores=2,
                        p_seu=0.2, p_flush=0.15, p_stall=0.1)


def main(argv=None, print_fn=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print_fn("-- instruction mixes from the counted smoke steps (fraction "
             "per group) --")
    show = ["base", "fadd", "fmul", "fdiv", "fcmp", "fma"]
    print_fn("workload".ljust(28) + "".join(g.rjust(8) for g in show))
    for name in FLEET.values():
        spec = workloads.get_workload(name)
        frac = spec.mix()
        cells = "".join(f"{frac[isa.GROUP_ID[g]]:8.3f}" for g in show)
        print_fn(name.ljust(28) + cells)

    print_fn("-- contention-aware placement of the model fleet --")
    model = ContentionModel(PCFG, device=dev)
    placed = place_tenants(FLEET, num_cores=2, model=model, device=dev)
    for i, core in enumerate(placed.cores):
        print_fn(f"  core {i}: " + ", ".join(
            f"{t} ({FLEET[t]})" for t in core))
    print_fn(f"  worst slowdown={placed.worst_slowdown:.4f} "
             f"mean={placed.mean_slowdown:.4f}")

    print_fn("-- online serve of the model fleet under a fault storm --")
    rep = OnlineReplacer(OCFG, model=model, policy="warm", faults=STORM,
                         recovery="warm", device=dev).run(EVENTS, NUM_EPOCHS)
    print_fn(f"policy={rep.policy} epochs={rep.epochs} "
             f"migrations={rep.migrations} faults={len(rep.fault_log)}")
    print_fn(f"worst slowdown={rep.worst_slowdown:.4f} "
             f"worst lifetime slowdown={rep.worst_lifetime_slowdown:.4f}")
    for t, m in sorted(rep.per_tenant.items()):
        print_fn(f"  {t} ({FLEET[t]}): lifetime slowdown "
                 f"{m['lifetime_slowdown']:.4f}")
    assert rep.worst_lifetime_slowdown < 2.0, rep.per_tenant


if __name__ == "__main__":
    main()
