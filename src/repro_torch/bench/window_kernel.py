"""§Perf — the window kernel against the plain window pass.

PyTorch port of `benchmarks/window_kernel.py`.  The interleaved engine's
`use_kernel` knob swaps the plain window pass (`"plain"`:
`window_distance.window_grid_plain` / `window_cell_plain`, PyTorch ops)
for the hand-written CUDA kernel (`"kernel"`: `window_grid` /
`window_cell`, `csrc/window_distance.cu`).  This module times the two
head to head on a small preempted grid — the one-shot counter sweep AND a
state-seeded resume segment (the serving stack's epoch-advance shape) —
with bit-for-bit parity asserted before any timing, at the reference's
sizes (`WK_*`).

The kernel arm needs CUDA tensors: on the CPU it raises, as
`window_distance.resolve("kernel")` does (there is no interpret mode and
no quiet plain arm).  The record says `kernel_mode: "cuda"` and carries
the wrappers' launches per route over the kernel arm.  Feeds the
`window_kernel` section of `perf_sweep` and runs standalone:

    PYTHONPATH=src python -m repro_torch.bench --only window_kernel
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import isa, scheduler, simulator
from repro_torch.device import resolve_device
from repro_torch.kernels import window_distance

WK_FLEETS = 2
WK_PROGRAMS = 2
WK_TRACE_LEN = 4_000
WK_TOTAL_STEPS = 8_000
WK_QUANTUM = 2_000
WK_SLOT_COUNTS = (2, 4)
WK_LATENCIES = (10, 50)
REPS = 2

# the `use_kernel` value of each arm
PLAIN_ARM = "plain"
KERNEL_ARM = "kernel"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_of(fn, device: torch.device, reps: int = REPS) -> float:
    """Warm once, then best-of-`reps` wall-clock seconds, each run ended
    by a device synchronisation (the perf_sweep protocol)."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def assert_same(a, b) -> None:
    """Bit-for-bit equality of two result tuples of tensors."""
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (x, y)


def _routes() -> dict:
    return {"window_grid": dict(window_distance.window_grid.routes),
            "window_cell": dict(window_distance.window_cell.routes)}


def _routes_since(before: dict) -> dict:
    now = _routes()
    return {w: {r: now[w][r] - before[w][r] for r in now[w]} for w in now}


def bench_kernel_vs_plain(device="cuda") -> dict:
    """Kernel vs plain window pass, one-shot sweep + resumed segment."""
    dev = resolve_device(device)
    tensor = scheduler.fleet_traces(
        scheduler.make_fleets(WK_PROGRAMS)[:WK_FLEETS], WK_TRACE_LEN)
    sched = simulator.SchedulerConfig(quantum_cycles=WK_QUANTUM)
    kw = dict(slot_counts=WK_SLOT_COUNTS, total_steps=WK_TOTAL_STEPS,
              path="interleaved", device=dev)

    def sweep(use_kernel):
        return simulator.sweep_fleet(tensor, WK_LATENCIES, isa.SCENARIO_2,
                                     sched, use_kernel=use_kernel, **kw)

    # correctness first: the kernel must agree with the plain pass bit
    # for bit (the randomized grids live in the card tests)
    before = _routes()
    assert_same(sweep(PLAIN_ARM), sweep(KERNEL_ARM))
    plain_s = best_of(lambda: sweep(PLAIN_ARM), dev)
    kernel_s = best_of(lambda: sweep(KERNEL_ARM), dev)

    # state-seeded resume: the seeded kernel form behind resume_preempted
    # (what every online epoch advance rides)
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    tr = np.asarray(tensor)[0]
    half = WK_TOTAL_STEPS // 2
    _, seed = simulator.simulate_many(tr, cfg, isa.SCENARIO_2, sched, half,
                                      return_state=True, device=dev)

    def segment(use_kernel):
        return simulator.simulate_many(tr, cfg, isa.SCENARIO_2, sched,
                                       half, state=seed,
                                       path="interleaved",
                                       use_kernel=use_kernel, device=dev)

    assert_same(segment(PLAIN_ARM), segment(KERNEL_ARM))
    resume_plain_s = best_of(lambda: segment(PLAIN_ARM), dev)
    resume_kernel_s = best_of(lambda: segment(KERNEL_ARM), dev)
    return {
        "grid": f"{WK_FLEETS} fleets x P={WK_PROGRAMS} x "
                f"{WK_TOTAL_STEPS} steps, quantum {WK_QUANTUM}, "
                f"{len(WK_SLOT_COUNTS)} slots x {len(WK_LATENCIES)} "
                f"latencies",
        "kernel_mode": "cuda" if KERNEL_ARM == "kernel" else KERNEL_ARM,
        "window": simulator.INTERLEAVE_WINDOW[dev.type],
        "plain_s": plain_s,
        "kernel_s": kernel_s,
        "speedup": plain_s / kernel_s,
        "resume_plain_s": resume_plain_s,
        "resume_kernel_s": resume_kernel_s,
        "resume_speedup": resume_plain_s / resume_kernel_s,
        "routes": _routes_since(before),
    }


def run(device="cuda") -> tuple[list[str], dict]:
    r = bench_kernel_vs_plain(device)
    mode = r["kernel_mode"]
    rows = [
        "section,variant,seconds,speedup",
        f"window_kernel,plain,{r['plain_s']:.3f},1.00x",
        f"window_kernel,kernel[{mode}],{r['kernel_s']:.3f},"
        f"{r['speedup']:.2f}x",
        f"window_kernel_resume,plain,{r['resume_plain_s']:.3f},1.00x",
        f"window_kernel_resume,kernel[{mode}],{r['resume_kernel_s']:.3f},"
        f"{r['resume_speedup']:.2f}x",
        f"# finding window kernel ({mode}, window {r['window']}) "
        f"{r['speedup']:.2f}x vs plain on the one-shot sweep, "
        f"{r['resume_speedup']:.2f}x on resumed segments; parity asserted "
        f"bit-for-bit before timing; launches by route {r['routes']}",
    ]
    return rows, r


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows, _ = run(device)
    for r in rows:
        print_fn(r)
    print_fn(f"# window_kernel done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
