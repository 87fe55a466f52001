"""§Perf — sweep-engine wall-clock on `device`, each fast engine against
the reference machine (or the first step design), parity asserted bit
for bit before any timing.

PyTorch port of `benchmarks/perf_sweep.py`, at its sizes:

1. **Stack-distance fast path vs the reference machine** on the Fig. 6
   grid ({3 scenarios x 3 miss latencies x 5 FM benchmarks} @ 120k steps).
2. **The current step vs the first step design** on a preempted P=4
   fleet: the first step (dependent double gather per step, two separate
   `slots.lookup` calls) is frozen below as `_legacy_sweep`, a torch step
   over the same lanes; on the card both arms replay through
   `simulator._replay_steps` (CUDA graphs of `SCAN_GRAPH_STEPS` steps),
   so the comparison is of the steps' work, not of the host's dispatch.
   The reference's `scan_unroll` sweep is not ported: `scan_unroll` is
   inert in the port (there is no compiled scan to unroll), and the
   record says so.
3. **Interleaved fast path vs the reference machine** on preempted
   fig6-style grids at P=2..4, with the `interleave_window` sweep
   (`PG_WINDOWS`; the window is live in the port).
4. **Stacked cold-bitstream pass vs the per-cell reference loop** on the
   bitstream_study grid.
5. **Resumable interleaved engine vs the reference machine** on a
   state-seeded P=3 segment; results and final states (through the
   port's canonical state) compared.
6. **The window kernel vs the plain window pass**: `window_kernel`.

Timing: the fast arms are best of `REPS` after a warm-up; each
reference-machine arm runs once, its parity run being its timed run,
after a warm-up of one graph replay (`SCAN_GRAPH_STEPS` steps).  Every
run ends with a device synchronisation.

The record goes through the port's `--record` path (`python -m
repro_torch.bench --only perf_sweep --record` writes
`experiments/bench_torch.json`, with {backend, device, platform_version});
the reference's `BENCH_sweep.json` is never written.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench import window_kernel
from repro_torch.bench.window_kernel import assert_same, best_of, sync
from repro_torch.core import isa, scheduler, simulator, slots, traces
from repro_torch.device import resolve_device

FIG6_TRACE_LEN = 120_000          # matches fig6_single
FIG6_LATENCIES = (10, 50, 250)
FIG6_SCENARIOS = (("s1", isa.SCENARIO_1), ("s2", isa.SCENARIO_2),
                  ("s3", isa.SCENARIO_3))

P4_FLEETS = 6
P4_TRACE_LEN = 30_000
P4_TOTAL_STEPS = 60_000
P4_QUANTUM = 20_000
REPS = 2

PG_FLEETS = 3
PG_TRACE_LEN = 30_000
PG_TOTAL_STEPS = 60_000
PG_QUANTUM = 20_000           # preempting: the paper's Fig. 7 quantum
PG_SLOT_COUNTS = (2, 4, 8)
PG_LATENCIES = (10, 50, 250)
PG_PROGRAMS = (2, 3, 4)
# 256/512/1024 stay fixed so the recorded sweep is comparable across
# devices; each device's default window is added to them
PG_WINDOWS = (256, 512, 1024)

BS_TRACE_LEN = 20_000
BS_CAPACITIES = (2, 4, 8, 16)
BS_PENALTIES = (50, 250)

RS_TRACE_LEN = 30_000
RS_TOTAL_STEPS = 60_000


def _once(fn, warm, device: torch.device):
    """A reference-machine arm: `warm()` (one graph replay's worth of
    steps) loads its kernels, then one timed run; (result, seconds)."""
    warm()
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def _windows(device: torch.device) -> tuple:
    return tuple(sorted({*PG_WINDOWS, simulator.INTERLEAVE_WINDOW[
        device.type]}))


# ---------------------------------------------------------------------------
# 1. fig6 grid: fast path vs the reference machine
# ---------------------------------------------------------------------------


def _fig6_grid(fleet, path: str, device, steps: int | None = None):
    return [simulator.sweep_fleet(
        fleet, FIG6_LATENCIES, scen, simulator.SchedulerConfig.no_preempt(),
        slot_counts=(scen.num_slots,), total_steps=steps or FIG6_TRACE_LEN,
        path=path,
        device=device) for _, scen in FIG6_SCENARIOS]


def bench_fig6_grid(device="cuda") -> dict:
    dev = resolve_device(device)
    fleet = np.stack([traces.build_trace(n, FIG6_TRACE_LEN)
                      for n in traces.FM_BENCHES])[:, None, :]
    scan_r, scan_s = _once(
        lambda: _fig6_grid(fleet, "scan", dev),
        lambda: _fig6_grid(fleet, "scan", dev, simulator.SCAN_GRAPH_STEPS),
        dev)
    fast = lambda: _fig6_grid(fleet, "stackdist", dev)  # noqa: E731
    # correctness first: the two engines must agree bit for bit
    for a, b in zip(scan_r, fast()):
        assert_same(a, b)
    fast_s = best_of(fast, dev, REPS)
    return {
        "grid": f"{len(FIG6_SCENARIOS)} scenarios x {len(FIG6_LATENCIES)} "
                f"latencies x {fleet.shape[0]} benches @ {FIG6_TRACE_LEN} "
                f"steps",
        "scan_s": scan_s,
        "stackdist_s": fast_s,
        "speedup": scan_s / fast_s,
        "parity": True,
    }


# ---------------------------------------------------------------------------
# 2. preempted P=4 fleet: the first step (frozen) vs the current step
# ---------------------------------------------------------------------------


def _legacy_sweep(fleets, tag_table, miss_latencies, slot_counts, quantum,
                  handler, num_slots: int, bs_entries: int, bs_miss_extra,
                  total_steps: int) -> simulator.FleetResult:
    """The first fleet step design, frozen as the perf baseline, over every
    (fleet, slot count, latency) lane: per step a dependent double gather
    (trace -> instruction -> tag / hw cost) and two separate
    `slots.lookup` calls; plain round robin.  Results (B, K, L, P) like
    `sweep_fleet`'s without its quantum axis."""
    dev = fleets.device
    nb, num_progs, trace_len = fleets.shape
    n_ops = tag_table.shape[-1]
    hw = torch.as_tensor(isa.INSTR_HW_CYCLES, dtype=torch.int32, device=dev)
    tags = torch.as_tensor(tag_table, dtype=torch.int32,
                           device=dev).reshape(-1)
    flat = fleets.reshape(-1)
    counts = torch.as_tensor(slot_counts, dtype=torch.int32, device=dev)
    lats = torch.as_tensor(miss_latencies, dtype=torch.int32, device=dev)
    shape = (nb, counts.shape[0], lats.shape[0])
    b, k, l = (x.reshape(-1) for x in torch.meshgrid(
        *(torch.arange(n, device=dev) for n in shape), indexing="ij"))
    lanes = b.shape[0]
    active, lat = counts[k], lats[l]
    row_base = b * num_progs
    parange = torch.arange(num_progs, device=dev)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731

    def step(c: simulator.FleetState) -> simulator.FleetState:
        p = c.sched_idx.long()
        cur = torch.remainder(c.cursors.gather(1, p[:, None])[:, 0],
                              trace_len)
        ins = flat[(row_base + p) * trace_len + cur.long()].long()
        tag = tags[p * n_ops + ins]
        res = slots.lookup(c.slot_st, tag, active)
        bs_res = slots.lookup(c.bs_st, torch.where(res.hit, -1, tag))
        cost = hw[ins] + torch.where(res.hit, 0, lat)
        cost = cost + torch.where(res.hit | bs_res.hit, 0, bs_miss_extra)
        q = c.q_cycles + cost
        do_switch = q >= quantum
        cost_p = cost + torch.where(do_switch, handler, 0)
        onehot = i32(parange == p[:, None])
        return simulator.FleetState(
            slot_st=res.state, bs_st=bs_res.state,
            cursors=c.cursors + onehot,
            sched_idx=i32(torch.where(do_switch, (p + 1) % num_progs, p)),
            q_cycles=i32(torch.where(do_switch, 0, q)),
            cycles=c.cycles + onehot * i32(cost_p)[:, None],
            instrs=c.instrs + onehot,
            misses=c.misses + onehot * i32(~res.hit)[:, None],
            bs_misses=c.bs_misses
            + onehot * i32(~(res.hit | bs_res.hit))[:, None],
            switches=c.switches + i32(do_switch))

    state = simulator._init_lanes(lanes, num_progs, num_slots, bs_entries,
                                  dev)
    if dev.type == "cuda" and total_steps >= simulator.SCAN_GRAPH_STEPS:
        state = simulator._replay_steps(step, state, total_steps)
    else:
        for _ in range(total_steps):
            state = step(state)
    pshape = shape + (num_progs,)
    return simulator.FleetResult(
        state.cycles.reshape(pshape), state.instrs.reshape(pshape),
        state.misses.reshape(pshape), state.bs_misses.reshape(pshape),
        state.switches.reshape(shape))


def bench_p4_preempted(device="cuda") -> dict:
    dev = resolve_device(device)
    tensor = torch.as_tensor(scheduler.fleet_traces(
        scheduler.make_fleets(4)[:P4_FLEETS], P4_TRACE_LEN),
        dtype=torch.int32, device=dev)
    table = simulator.fleet_tag_table(isa.SCENARIO_2, 4)
    sched = simulator.SchedulerConfig(quantum_cycles=P4_QUANTUM)

    def legacy(steps=P4_TOTAL_STEPS):
        return _legacy_sweep(tensor, table, [50], [4], P4_QUANTUM,
                             sched.handler_cycles, 4, 64, 100, steps)

    def current(steps=P4_TOTAL_STEPS):
        return simulator.sweep_fleet(
            tensor, [50], isa.SCENARIO_2, sched, slot_counts=[4],
            total_steps=steps, path="scan", device=dev)

    warm = lambda f: lambda: f(simulator.SCAN_GRAPH_STEPS)  # noqa: E731
    legacy_r, legacy_s = _once(legacy, warm(legacy), dev)
    current_r, current_s = _once(current, warm(current), dev)
    # the current step must reproduce the first step's numbers exactly
    for a, b in zip(legacy_r, current_r):
        assert torch.equal(a.reshape(-1), b.reshape(-1)), (a, b)
    return {
        "grid": f"{P4_FLEETS} fleets x P=4 x {P4_TOTAL_STEPS} steps, "
                f"quantum {P4_QUANTUM}, 50c misses",
        "legacy_s": legacy_s,
        "current_s": current_s,
        "speedup": legacy_s / current_s,
        "unroll_sweep": "not ported: scan_unroll is inert in the port",
        "parity": True,
    }


# ---------------------------------------------------------------------------
# 3. preempted fig6-style grids: interleaved fast path vs the reference
# ---------------------------------------------------------------------------


def bench_preempted_grid(device="cuda") -> dict:
    """Interleaved fast path vs the reference machine, P=2..4, preempting
    quanta, with the `interleave_window` sweep."""
    dev = resolve_device(device)
    sched = simulator.SchedulerConfig(quantum_cycles=PG_QUANTUM)
    default = simulator.INTERLEAVE_WINDOW[dev.type]
    out = {}
    for p in PG_PROGRAMS:
        tensor = scheduler.fleet_traces(
            scheduler.make_fleets(p)[:PG_FLEETS], PG_TRACE_LEN)

        def sweep(path, window=None, steps=PG_TOTAL_STEPS, tensor=tensor):
            return simulator.sweep_fleet(
                tensor, PG_LATENCIES, isa.SCENARIO_2, sched,
                slot_counts=PG_SLOT_COUNTS, total_steps=steps, path=path,
                interleave_window=window, device=dev)

        scan_r, scan_s = _once(
            lambda: sweep("scan"),
            lambda: sweep("scan", steps=simulator.SCAN_GRAPH_STEPS), dev)
        # correctness first: the two engines must agree bit for bit
        assert_same(scan_r, sweep("interleaved"))
        window_sweep = {str(w): best_of(
            lambda w=w: sweep("interleaved", w), dev, REPS)
            for w in _windows(dev)}
        fast_s = window_sweep[str(default)]
        out[f"p{p}"] = {
            "grid": f"{PG_FLEETS} fleets x P={p} x {PG_TOTAL_STEPS} steps, "
                    f"quantum {PG_QUANTUM}, {len(PG_SLOT_COUNTS)} slots x "
                    f"{len(PG_LATENCIES)} latencies",
            "scan_s": scan_s,
            "interleaved_s": fast_s,
            "speedup": scan_s / fast_s,
            "default_window": default,
            "window_sweep_s": window_sweep,
            "parity": True,
        }
    return out


# ---------------------------------------------------------------------------
# 4. cold-bitstream grid: stacked Mattson pass vs the per-cell reference
# ---------------------------------------------------------------------------


def bench_cold_bitstream(device="cuda") -> dict:
    """bitstream_study's {capacity x penalty} grid: one stacked-pass
    `sweep_bitstream` call vs the per-cell reference-machine loop."""
    dev = resolve_device(device)
    trs = np.stack([traces.build_trace(n, BS_TRACE_LEN)
                    for n in traces.FM_BENCHES])
    kw = dict(slot_counts=[4], miss_latencies=[50],
              bs_entries=BS_CAPACITIES, bs_miss_extras=BS_PENALTIES)

    def grid(path, steps=BS_TRACE_LEN):
        return simulator.sweep_bitstream(trs, isa.SCENARIO_2, path=path,
                                         total_steps=steps, device=dev, **kw)

    scan_r, scan_s = _once(
        lambda: grid("scan"),
        lambda: simulator.sweep_bitstream(
            trs[:1], isa.SCENARIO_2, path="scan", slot_counts=[4],
            miss_latencies=[50], bs_entries=BS_CAPACITIES[:1],
            bs_miss_extras=BS_PENALTIES[:1],
            total_steps=simulator.SCAN_GRAPH_STEPS, device=dev), dev)
    assert_same(scan_r, grid("stackdist_cold"))
    fast_s = best_of(lambda: grid("stackdist_cold"), dev, REPS)
    return {
        "grid": f"{trs.shape[0]} benches x {len(BS_CAPACITIES)} capacities "
                f"x {len(BS_PENALTIES)} penalties @ {BS_TRACE_LEN} steps",
        "scan_s": scan_s,
        "stackdist_cold_s": fast_s,
        "speedup": scan_s / fast_s,
        "parity": True,
    }


# ---------------------------------------------------------------------------
# 5. resumed segments: resumable interleaved engine vs the reference
# ---------------------------------------------------------------------------


def bench_resumed_segment(device="cuda") -> dict:
    """State-seeded resume (the online layer's epoch-advance shape): a
    preempted P=3 run split at the midpoint, the second half resumed from
    the materialised FleetState on both engines."""
    dev = resolve_device(device)
    tensor = scheduler.fleet_traces(
        scheduler.make_fleets(3)[:1], RS_TRACE_LEN)[0]
    sched = simulator.SchedulerConfig(quantum_cycles=PG_QUANTUM)
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    half = RS_TOTAL_STEPS // 2
    _, seed = simulator.simulate_many(tensor, cfg, isa.SCENARIO_2, sched,
                                      half, return_state=True, device=dev)

    def segment(path, steps=half):
        return simulator.simulate_many(tensor, cfg, isa.SCENARIO_2, sched,
                                       steps, state=seed, return_state=True,
                                       path=path, device=dev)

    (scan_r, scan_st), scan_s = _once(
        lambda: segment("scan"),
        lambda: segment("scan", simulator.SCAN_GRAPH_STEPS), dev)
    fast_r, fast_st = segment("interleaved")
    # correctness first: results AND final states must agree bit for bit
    assert_same(scan_r, fast_r)
    assert_same(simulator._state_leaves(simulator._canonical_state(scan_st)),
                simulator._state_leaves(simulator._canonical_state(fast_st)))
    fast_s = best_of(lambda: segment("interleaved"), dev, REPS)
    return {
        "grid": f"P=3 x {half} resumed steps, quantum {PG_QUANTUM}, "
                f"50c misses, mid-run FleetState seed",
        "scan_s": scan_s,
        "interleaved_resume_s": fast_s,
        "speedup": scan_s / fast_s,
        "parity": True,
    }


# ---------------------------------------------------------------------------


SECTIONS = {
    "fig6_grid": bench_fig6_grid,
    "p4_preempted": bench_p4_preempted,
    "preempted_grid": bench_preempted_grid,
    "cold_bitstream": bench_cold_bitstream,
    "resumed_segment": bench_resumed_segment,
    "window_kernel": window_kernel.bench_kernel_vs_plain,
}


def run(device="cuda") -> tuple[list[str], dict]:
    dev = resolve_device(device)
    report = {}
    seconds = {}
    for name, fn in SECTIONS.items():
        t0 = time.perf_counter()
        report[name] = fn(dev)
        seconds[name] = time.perf_counter() - t0
    report["meta"] = {"reps": REPS, "section_seconds": seconds}
    g, p = report["fig6_grid"], report["p4_preempted"]
    pg = report["preempted_grid"]
    cb, rs = report["cold_bitstream"], report["resumed_segment"]
    wk = report["window_kernel"]
    rows = [
        "section,variant,seconds,speedup",
        f"fig6_grid,scan,{g['scan_s']:.3f},1.00x",
        f"fig6_grid,stackdist,{g['stackdist_s']:.3f},{g['speedup']:.1f}x",
        f"p4_preempted,legacy,{p['legacy_s']:.3f},1.00x",
        f"p4_preempted,current,{p['current_s']:.3f},{p['speedup']:.2f}x",
    ]
    for key in sorted(pg):
        e = pg[key]
        rows += [
            f"preempted_grid_{key},scan,{e['scan_s']:.3f},1.00x",
            f"preempted_grid_{key},interleaved,{e['interleaved_s']:.3f},"
            f"{e['speedup']:.1f}x",
        ]
        rows += [f"preempted_grid_{key},window={w},{s:.3f},-"
                 for w, s in e["window_sweep_s"].items()]
    rows += [
        f"cold_bitstream,scan,{cb['scan_s']:.3f},1.00x",
        f"cold_bitstream,stackdist_cold,{cb['stackdist_cold_s']:.3f},"
        f"{cb['speedup']:.1f}x",
        f"resumed_segment,scan,{rs['scan_s']:.3f},1.00x",
        f"resumed_segment,interleaved,{rs['interleaved_resume_s']:.3f},"
        f"{rs['speedup']:.1f}x",
        f"window_kernel,plain,{wk['plain_s']:.3f},1.00x",
        f"window_kernel,kernel[{wk['kernel_mode']}],{wk['kernel_s']:.3f},"
        f"{wk['speedup']:.2f}x",
    ]
    worst = min(e["speedup"] for e in pg.values())
    rows.append(f"# fast path {g['speedup']:.1f}x on the fig6 grid; "
                f"current step {p['speedup']:.2f}x the first step on the "
                f"preempted P=4 fleet; interleaved >= {worst:.1f}x on the "
                f"preempted fig6-style grids; stacked cold-bitstream "
                f"{cb['speedup']:.1f}x on the bitstream_study grid; "
                f"resumed segments {rs['speedup']:.1f}x; window kernel "
                f"[{wk['kernel_mode']}] {wk['speedup']:.2f}x vs plain; "
                f"parity asserted in every section [{dev.type}]")
    return rows, report


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows, _ = run(device)
    for r in rows:
        print_fn(r)
    print_fn(f"# perf_sweep done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
