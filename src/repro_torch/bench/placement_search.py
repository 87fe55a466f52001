"""§Perf — placement-search wall-clock anchor (the serving stack's hot loop).

PyTorch port of `benchmarks/placement_search.py`, on `device`: every row
but the two seconds rows (and the seconds in the finding) equals the
reference's.

`place_tenants` (greedy seeding + swap local search) prices every candidate
co-residency group through `ContentionModel` -> `sweep_fleet`; those
one-shot preempted warm-cache sweeps ride the interleave-aware
stack-distance engine (`repro_torch.core.stackdist_interleaved`) instead
of the cycle-by-cycle scan, which is where the search spends its time.  This
module times one full search on a fixed 6-tenant roster: a regression
on the interleaved engine shows up here as a slower search.

Timed twice: a cold process-first search (on the card, the kernel's
first load included) and the steady-state search (fresh model — what a
serving epoch loop actually pays per re-solve).
"""
from __future__ import annotations

import time

from repro_torch.sched import ContentionModel, PlacementConfig, place_tenants

# fixed roster: four FM-class tenants (slot-hungry) + two M-class, three
# cores — big enough that greedy + swap explores a real candidate set,
# small enough for a CI smoke step
TENANTS = {
    "t-minver": "minver", "t-nbody": "nbody", "t-cubic": "cubic",
    "t-st": "st", "t-crc32": "crc32", "t-tarfind": "tarfind",
}
NUM_CORES = 3
CFG = PlacementConfig(quantum_cycles=2_000, trace_len=8_000,
                      steps_per_program=10_000)


def _search(device):
    model = ContentionModel(CFG, device=device)
    placed = place_tenants(TENANTS, NUM_CORES, model)
    return model, placed


def run(device="cuda") -> tuple[list[str], dict]:
    t0 = time.perf_counter()
    model, placed = _search(device)
    cold_s = time.perf_counter() - t0

    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        model, placed = _search(device)
        best = min(best, time.perf_counter() - t0)

    report = {
        "roster": f"{len(TENANTS)} tenants / {NUM_CORES} cores, quantum "
                  f"{CFG.quantum_cycles}, {CFG.steps_per_program} "
                  "steps/program",
        "cold_search_s": cold_s,
        "search_s": best,
        "sim_calls": model.sim_calls,
        "groups_simulated": model.groups_simulated,
        "worst_slowdown": placed.worst_slowdown,
        "mean_slowdown": placed.mean_slowdown,
        "cores": [list(c) for c in placed.cores],
    }
    rows = [
        "metric,value",
        f"cold_search_s,{cold_s:.3f}",
        f"search_s,{best:.3f}",
        f"sim_calls,{model.sim_calls}",
        f"groups_simulated,{model.groups_simulated}",
        f"worst_slowdown,{placed.worst_slowdown:.4f}",
        f"# finding: steady-state placement search {best:.3f}s "
        f"({model.groups_simulated} groups priced through the interleaved "
        f"fast path), worst-tenant slowdown {placed.worst_slowdown:.4f}",
    ]
    return rows, report


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows, _ = run(device)
    for r in rows:
        print_fn(r)
    print_fn(f"# placement_search done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
