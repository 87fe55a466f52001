#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run it from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the window kernel from `src/repro_torch/kernels/csrc/` with
`nvcc`, holds both of its entry points (`window_grid`, `window_cell`)
against their plain PyTorch versions on the card bit for bit, and then
drives the port's main path at the paper's full size through the entry
points a user calls: the fig7 grid and the P=4 fleet sweep through
`simulator.sweep_fleet`, a serving session of resumed `simulate_many`
epochs, and the fig6/fig4/fig5/bitstream benchmarks.  Every figure's rows
must equal, as text, the rows the JAX package's `benchmarks/` print at
full size on the CPU (sha1 digests below), and the derived anchors must
hold.  Each phase prints one JSON line; any failure raises and exits
non-zero.  The last three lines are the card's `nvidia-smi` name and
power limit, the `kernels` line (launches on the main path, times, bound,
error) and `{"ok": true, "device": ...}`.

Without CUDA, or without the port's sources beside it, the script exits
non-zero before it prints any result.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# sha1 of "\n".join(rows) of each benchmark of the JAX package at full
# size (`benchmarks/<module>.run()`, CPU): the port must print the same
EXPECTED_ROWS = {
    "fig4": "81d5a5280df6a9a86ff57d666cbc544ff5ad4f9c",
    "fig5": "5be650b5f1d41144ada7a9e242f10c7ba9fd601c",
    "fig6": "4a8694be52f6c69d2a948c8cc74fcf852fbca479",
    "fig7": "bcd61f072b10912957a5d4ccd8c58d9aebaf9c0c",
    "fleet_sweep": "08d48b32c5e26b492338192081f7ce0d20974b2f",
    "bitstream_study": "e0049a55487c01d9307040bf4d2adeb0829f1ad7",
}
ANCHORS = {
    "fig4": "minver_speedup_F=27.50 (paper 27.5)",
    "fig5": "classes: FM=5 M=8 insensitive=9 (paper: 5/8/9)",
    "fig6": "avg_s2@50c=0.687 (paper ~0.71)",
    "fig7": ("x3.13 over RV32I", "x1.39 over RV32IM", "x1.67 over RV32IF",
             "abs 0.81 of IMF"),
    "fleet_sweep": "P4_avg@10c=0.935; P4_avg@50c=0.757; P4_avg@250c=0.452",
}

# HBM bytes/s of one H100 SXM (NVIDIA's data sheet, as the on-chip
# measurement guide tabulates it)
HBM_BYTES_PER_S = 3.35e12
# int32 lanes of a Hopper SM: 4 partitions x 16 INT32 units (NVIDIA H100
# Tensor Core GPU Architecture whitepaper, "H100 SM architecture").  The
# card's int32 issue rate is SMs x lanes x its maximum SM clock; the
# data sheet's 1,980 MHz boost stands in where nvidia-smi reports none.
INT32_LANES_PER_SM = 64
H100_SXM_MAX_SM_MHZ = 1_980.0


def int32_ops_per_s() -> tuple[float, str]:
    """The card's int32 issue rate (ops/s) and where its clock came from."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    try:
        mhz, src = float(smi.stdout.split()[0]), "nvidia-smi clocks.max.sm"
    except (IndexError, ValueError):
        mhz, src = H100_SXM_MAX_SM_MHZ, "H100 SXM data sheet boost clock"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, f"{sms} SMs x " \
        f"{INT32_LANES_PER_SM} lanes x {mhz:g} MHz ({src})"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sha(rows) -> str:
    return hashlib.sha1("\n".join(rows).encode()).hexdigest()


def load_port():
    """Import the port from the `src/` beside this script, never from
    anywhere else."""
    pkg = os.path.join(SRC, "repro_torch")
    if not os.path.isdir(pkg):
        raise SystemExit(f"chip_smoke.py: no {pkg}: run it from the root "
                         f"of a checkout of the repository")
    sys.path.insert(0, SRC)
    import repro_torch
    where = os.path.dirname(os.path.abspath(repro_torch.__file__))
    check(where == pkg, f"imported repro_torch from {where}, not {pkg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` on the card: one warm-up call, then
    `reps` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want) -> float:
    """Largest absolute difference over all fields (int32 counters and
    float32 CPIs alike, taken in float64)."""
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def assert_same(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        check(torch.equal(g.cpu(), w.cpu()), f"{what}: field {i} differs")


@contextlib.contextmanager
def engine_calls(name: str):
    """Record each call of the simulator's engine `name` (e.g.
    `_sweep_fleet_interleaved`) while the block runs."""
    from repro_torch.core import simulator
    calls, real = [], getattr(simulator, name)

    def spy(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    setattr(simulator, name, spy)
    try:
        yield calls
    finally:
        setattr(simulator, name, real)


def states_equal(a, b) -> bool:
    from repro_torch.core import simulator
    leaves = lambda s: (list(s.slot_st) + list(s.bs_st) + list(s[2:]))
    na, nb = (leaves(simulator.fleet_state_to_numpy(x)) for x in (a, b))
    return all(np.array_equal(x, y) for x, y in zip(na, nb))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "False: this script needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build() -> None:
    from repro_torch.kernels import window_distance as wd
    t0 = time.perf_counter()
    lib = wd.build(verbose=True)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=os.path.relpath(lib, ROOT))


QUANTUM_MENU = (6, 37, 120, 1 << 30)
WINDOWS = (1, 13, 64, 200, 512, 2048)
CHECK_TRACE_LEN, CHECK_STEPS = 300, 1_200


def phase_kernel_vs_plain(dev, errs: dict) -> None:
    """Seeded random small grids and cells: the kernel against its plain
    version, every field equal bit for bit."""
    from repro_torch.core import simulator
    from repro_torch.kernels import window_distance as wd
    rng = np.random.default_rng(2024)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=dev)
    p, trace_len, steps = 3, CHECK_TRACE_LEN, CHECK_STEPS
    sched = t(simulator.priority_schedule((2, 1, 3), p))     # weighted
    cases = 0
    for num_tags in (7, 29):
        for window in WINDOWS:
            ptags = t(rng.integers(-1, num_tags, (3, p, trace_len)))
            pcosts = t(rng.integers(0, 9, (3, p, trace_len)))
            quanta = t([[QUANTUM_MENU[i] for i in rng.integers(0, 4, p)]
                        for _ in range(3)])
            args = (ptags, pcosts, t([1, 4, 8]), t([0, 73]), quanta, sched,
                    11, 23)
            kw = dict(num_tags=num_tags, total_steps=steps, window=window)
            got = wd.window_grid(*args, **kw)
            want = wd.window_grid_plain(*args, **kw)
            errs["window_grid"] = max(errs["window_grid"],
                                      max_err(got, want))
            assert_same(got, want, f"window_grid T={num_tags} W={window}")
            cases += 1
            for mode in ("unseeded", "seeded", "materialise"):
                seed = None
                if mode == "seeded":
                    seed = (t(rng.permutation(num_tags) - 1),
                            t(rng.integers(0, 3 * trace_len, p)),
                            t(rng.integers(0, sched.shape[0])),
                            t(rng.integers(0, 6)),
                            t(rng.integers(0, 9_000, p)),
                            t(rng.integers(0, 900, p)),
                            t(rng.integers(0, 900, p)),
                            t(rng.integers(0, 90, p)),
                            t(rng.integers(0, 40)))
                cargs = (ptags[0], pcosts[0], 3, 41, quanta[0], sched, 9, 17,
                         seed)
                ckw = dict(kw, materialise=mode != "unseeded")
                got = wd.window_cell(*cargs, **ckw)
                want = wd.window_cell_plain(*cargs, **ckw)
                errs["window_cell"] = max(errs["window_cell"],
                                          max_err(got, want))
                assert_same(got, want,
                            f"window_cell {mode} T={num_tags} W={window}")
                cases += 1
    torch.cuda.synchronize()
    emit("kernel_vs_plain", cases=cases, windows=list(WINDOWS),
         num_tags=[7, 29], match=True)


def phase_fig7(dev, errs: dict) -> None:
    from repro_torch import bench
    from repro_torch.bench import fig7_multi
    from repro_torch.core import scheduler
    from repro_torch.kernels import window_distance as wd
    pairs = scheduler.make_pairs()
    before = wd.window_grid.launches
    with engine_calls("_sweep_fleet_interleaved") as fleets:
        t0 = time.perf_counter()
        res = fig7_multi.sweep(pairs, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(fleets == [len(pairs)], f"fig7 interleaved calls {fleets}")
    check(wd.window_grid.launches > before, "fig7 launched no window_grid")
    t0 = time.perf_counter()
    plain = fig7_multi.sweep(pairs, device=dev, use_kernel="plain")
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    errs["window_grid"] = max(errs["window_grid"], max_err(res, plain))
    assert_same(res, plain, "fig7 grid vs plain")
    rows, _ = fig7_multi.run(pairs, device=dev, res=res)
    derived = bench.fig7_derived(rows)
    for anchor in ANCHORS["fig7"]:
        check(anchor in derived, f"fig7 anchor {anchor!r} not in {derived}")
    check(sha(rows) == EXPECTED_ROWS["fig7"], "fig7 rows differ from JAX's")
    emit("fig7", derived=derived, cells=int(res.switches.numel()),
         engine="interleaved",
         sweep_s=round(secs, 3), plain_sweep_s=round(plain_secs, 3),
         rows_match_jax=True, grid_matches_plain=True,
         window_grid_launches=wd.window_grid.launches - before)


def phase_fleet_sweep(dev, errs: dict) -> None:
    from repro_torch import bench
    from repro_torch.bench import fig7_multi
    from repro_torch.kernels import window_distance as wd
    before = wd.window_grid.launches
    with engine_calls("_sweep_fleet_interleaved") as fleets:
        t0 = time.perf_counter()
        res = fig7_multi.sweep_fleets(device=dev)
        rows, agg = fig7_multi.run_fleets(device=dev, res=res)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(fleets == [24], f"fleet sweep interleaved calls {fleets}")
    check(wd.window_grid.launches > before, "fleet sweep launched nothing")
    t0 = time.perf_counter()
    plain = fig7_multi.sweep_fleets(device=dev, use_kernel="plain")
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    errs["window_grid"] = max(errs["window_grid"], max_err(res, plain))
    assert_same(res, plain, "P=4 fleet grid vs plain")
    derived = bench.fleet_derived(agg)
    check(derived == ANCHORS["fleet_sweep"], f"fleet anchors: {derived}")
    check(sha(rows) == EXPECTED_ROWS["fleet_sweep"],
          "fleet sweep rows differ from JAX's")
    emit("fleet_sweep", derived=derived, cells=int(res.switches.numel()),
         engine="interleaved", seconds=round(secs, 3),
         plain_sweep_s=round(plain_secs, 3), rows_match_jax=True,
         grid_matches_plain=True,
         window_grid_launches=wd.window_grid.launches - before)


SERVE_EPOCHS, SERVE_EPOCH_STEPS = 20, 6_000


def serve_setup():
    from repro_torch.bench import fig7_multi
    from repro_torch.core import isa, scheduler, simulator
    fleet = scheduler.make_fleets(4)[0]
    traces = scheduler.fleet_traces([fleet], fig7_multi.TRACE_LEN)[0]
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    sched = simulator.SchedulerConfig(quantum_cycles=2_000)
    return fleet, traces, cfg, isa.SCENARIO_2, sched


def phase_serve(dev, errs: dict) -> None:
    """A P=4 fleet served in epochs: each epoch resumes the carried
    `FleetState` (`OnlineConfig.epoch_steps` style), which rides the
    seeded/materialising window kernel."""
    from repro_torch.core import simulator
    from repro_torch.kernels import window_distance as wd
    fleet, traces, cfg, scen, sched = serve_setup()

    def epochs(use_kernel):
        state = simulator.init_fleet_state(4, cfg.num_slots, device=dev)
        mid = None
        for e in range(SERVE_EPOCHS):
            res, state = simulator.simulate_many(
                traces, cfg, scen, sched, total_steps=SERVE_EPOCH_STEPS,
                state=state, return_state=True, use_kernel=use_kernel,
                device=dev)
            if e == SERVE_EPOCHS // 2 - 1:
                mid = state
        return res, state, mid

    before = wd.window_cell.launches
    t0 = time.perf_counter()
    res, state, mid = epochs(None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(wd.window_cell.launches - before == SERVE_EPOCHS,
          f"serve epochs launched {wd.window_cell.launches - before} cells")
    total = SERVE_EPOCHS * SERVE_EPOCH_STEPS
    one, one_state = simulator.simulate_many(
        traces, cfg, scen, sched, total_steps=total, return_state=True,
        device=dev)
    assert_same(res, one, "epochs vs one-shot")
    check(states_equal(state, one_state), "epoch state != one-shot state")
    p_res, p_state, _ = epochs("plain")
    errs["window_cell"] = max(errs["window_cell"], max_err(res, p_res))
    assert_same(res, p_res, "epochs vs plain epochs")
    check(states_equal(state, p_state), "epoch state != plain state")
    seg = 3_000
    fast = simulator.simulate_many(traces, cfg, scen, sched,
                                   total_steps=seg, state=mid,
                                   return_state=True, device=dev)
    scan = simulator.simulate_many(traces, cfg, scen, sched,
                                   total_steps=seg, state=mid,
                                   return_state=True, path="scan",
                                   device=dev)
    assert_same(fast[0], scan[0], "segment vs scan reference machine")
    check(states_equal(fast[1], scan[1]), "segment state != scan state")
    emit("serve", fleet="+".join(fleet), epochs=SERVE_EPOCHS,
         epoch_steps=SERVE_EPOCH_STEPS, seconds=round(secs, 3),
         cpi=[round(float(x), 4) for x in res.cpi.cpu()],
         switches=int(res.switches), matches_one_shot=True,
         matches_plain=True, scan_segment_steps=seg,
         window_cell_launches=wd.window_cell.launches - before)


def phase_benches(dev) -> None:
    from repro_torch import bench
    with engine_calls("_sweep_fleet_stackdist") as fleets:
        t0 = time.perf_counter()
        rows, derived = bench.bench_fig6(device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(fleets == [5, 5, 5], f"fig6 stack-distance calls {fleets}")
    check(derived == ANCHORS["fig6"], f"fig6 anchor: {derived}")
    rows = [r for r in rows if not r.startswith("# fig6 done")]
    check(sha(rows) == EXPECTED_ROWS["fig6"], "fig6 rows differ from JAX's")
    emit("fig6", derived=derived, seconds=round(secs, 3), engine="stackdist",
         rows_match_jax=True)
    for name in ("fig4", "fig5"):
        rows, derived = getattr(bench, f"bench_{name}")(device=dev)
        rows = [r for r in rows if not r.startswith("# fig4 done")]
        check(derived == ANCHORS[name], f"{name} anchor: {derived}")
        check(sha(rows) == EXPECTED_ROWS[name], f"{name} rows differ")
        emit(name, derived=derived, rows_match_jax=True)
    from repro_torch.bench import bitstream_study
    t0 = time.perf_counter()
    rows = bitstream_study.run(device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(sha(rows) == EXPECTED_ROWS["bitstream_study"],
          "bitstream_study rows differ from JAX's")
    emit("bitstream_study", rows=len(rows), seconds=round(secs, 3),
         finding=rows[-1][2:], rows_match_jax=True)


def _bound_ms(stream_elems: int, other_bytes: int, accesses: int,
              num_tags: int, int32_rate: float) -> tuple[float, str]:
    """Least time for the window pass, in ms, and what bounds it.  Bytes:
    each tag/cost element the run touches read once (at most the whole
    streams, at most one per committed access) plus the other operands
    and the outputs, over the HBM rate.  Operations: 2*num_tags + 8 int32
    operations per committed access (the stack-distance compares and the
    per-tag last-position update, plus the cost, scan, expiry and counter
    arithmetic) over the card's int32 rate.  The larger of the two."""
    t_bytes = (8 * min(stream_elems, accesses) + other_bytes) / \
        HBM_BYTES_PER_S
    t_ops = accesses * (2 * num_tags + 8) / int32_rate
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_timing(dev, errs: dict) -> dict:
    """Kernel and plain times at the main path's shapes: `window_grid` at
    the fig7 grid (and the P=4 fleet grid), `window_cell` at one serving
    epoch."""
    from repro_torch.bench import fig7_multi
    from repro_torch.core import isa, scheduler, simulator
    from repro_torch.core import stackdist_interleaved as sdi
    from repro_torch.kernels import window_distance as wd
    out = {}
    int32_rate, rate_src = int32_ops_per_s()
    emit("int32_rate", ops_per_s=int32_rate, source=rate_src,
         hbm_bytes_per_s=HBM_BYTES_PER_S)
    # fig7: 50 pairs padded to 52 (bucket of 4) x 2 quanta x 3 slot counts
    pairs = scheduler.make_pairs()
    fl = torch.as_tensor(scheduler.fleet_traces(
        pairs + pairs[:1] * 2, fig7_multi.TRACE_LEN), device=dev)
    table = simulator.fleet_tag_table(isa.SCENARIO_2, 2)
    ptags, pcosts = sdi._gather_streams(fl, table, isa.INSTR_HW_CYCLES)
    quanta = torch.tensor([[q, q] for q in fig7_multi.QUANTA],
                          dtype=torch.int32, device=dev)
    num_tags = int(table.max()) + 1
    window = simulator._interleaved_window(quanta.cpu().numpy(),
                                           fig7_multi.TOTAL_STEPS, None, dev)
    args = (ptags, pcosts, list(fig7_multi.SLOT_COUNTS),
            [fig7_multi.MISS_LATENCY], quanta,
            torch.arange(2, dtype=torch.int32, device=dev), 150, 100)
    kw = dict(num_tags=num_tags, total_steps=fig7_multi.TOTAL_STEPS,
              window=window)
    got = wd.window_grid(*args, **kw)
    want = wd.window_grid_plain(*args, **kw)
    errs["window_grid"] = max(errs["window_grid"], max_err(got, want))
    assert_same(got, want, "fig7 timing inputs")
    cells = got[4].numel()
    ms = cuda_ms(lambda: wd.window_grid(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: wd.window_grid_plain(*args, **kw), 1)
    num_progs = ptags.shape[1]
    bound, by = _bound_ms(ptags.numel(), 4 * cells * (4 * num_progs + 1),
                          cells * fig7_multi.TOTAL_STEPS, num_tags,
                          int32_rate)
    out["window_grid"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, shape="fig7", cells=cells,
                              window=window)
    emit("time_window_grid", **out["window_grid"])

    # one serving epoch: a seeded, materialising cell of the P=4 fleet
    fleet, traces, cfg, scen, sched = serve_setup()
    state = simulator.init_fleet_state(4, cfg.num_slots, device=dev)
    _, state = simulator.simulate_many(
        traces, cfg, scen, sched, total_steps=SERVE_EPOCH_STEPS * 5,
        state=state, return_state=True, device=dev)
    ctable = simulator.fleet_tag_table(scen, 4)
    cnum_tags = simulator._engine_num_tags(ctable, state)
    seed = simulator._seed_carry(state, cnum_tags)
    ct, cc = sdi._gather_streams(torch.as_tensor(traces, device=dev),
                                 ctable, isa.INSTR_HW_CYCLES)
    cq = torch.as_tensor(sched.quanta(4), device=dev)
    cw = simulator._interleaved_window(sched.quanta(4)[None, :],
                                       SERVE_EPOCH_STEPS, None, dev)
    cargs = (ct, cc, cfg.num_slots, cfg.miss_latency, cq,
             torch.as_tensor(sched.schedule(4), device=dev),
             sched.handler_cycles, cfg.bs_miss_extra,
             (seed.last_pos, seed.cursors, seed.sched_idx, seed.q_cycles,
              seed.cycles, seed.instrs, seed.misses, seed.bs_misses,
              seed.switches))
    ckw = dict(num_tags=cnum_tags, total_steps=SERVE_EPOCH_STEPS, window=cw,
               seeded=True, materialise=True)
    got = wd.window_cell(*cargs, **ckw)
    want = wd.window_cell_plain(*cargs, **ckw)
    errs["window_cell"] = max(errs["window_cell"], max_err(got, want))
    assert_same(got, want, "serving-epoch timing inputs")
    ms = cuda_ms(lambda: wd.window_cell(*cargs, **ckw), 50)
    plain_ms = cuda_ms(lambda: wd.window_cell_plain(*cargs, **ckw), 3)
    # outputs: 2 tag vectors, 5 program vectors, 4 scalars; the seed
    bound, by = _bound_ms(ct.numel(), 4 * 2 * (cnum_tags + 5 * 4 + 4),
                          SERVE_EPOCH_STEPS, cnum_tags, int32_rate)
    out["window_cell"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, shape="serving epoch",
                              window=cw, steps=SERVE_EPOCH_STEPS)
    emit("time_window_cell", **out["window_cell"])
    return out


def main() -> None:
    load_port()
    card = phase_device()
    from repro_torch.kernels import window_distance as wd
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_build()
    errs = {"window_grid": 0, "window_cell": 0}
    phase_kernel_vs_plain(dev, errs)

    # the main path: counts from 0, read right after it
    wd.window_grid.launches = 0
    wd.window_cell.launches = 0
    phase_fig7(dev, errs)
    phase_fleet_sweep(dev, errs)
    phase_serve(dev, errs)
    phase_benches(dev)
    launches = {"window_grid": wd.window_grid.launches,
                "window_cell": wd.window_cell.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    emit("main_path", launches=launches)

    times = phase_timing(dev, errs)
    for name, err in errs.items():
        check(err == 0, f"{name} differs from its plain version by {err}")
    replaces = {"window_grid": "src/repro/kernels/window_distance.py:325",
                "window_cell": "src/repro/kernels/window_distance.py:438"}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window_distance.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"], "library_ms": None,
        "match": True, "shape": times[name]["shape"]}
        for name in ("window_grid", "window_cell")]
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
