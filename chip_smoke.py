#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run it from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's three kernels from `src/repro_torch/kernels/csrc/`
with `nvcc` (one process per source, all started together).

The simulator slice: it holds both entry points of the window kernel
(`window_grid`, `window_cell`) against their plain PyTorch versions on the
card bit for bit, and then drives the simulator's main path at the
paper's full size through the entry points a user calls: the fig7 grid
and the P=4 fleet sweep through `simulator.sweep_fleet`, a serving
session of resumed `simulate_many` epochs, and the fig6/fig4/fig5/
bitstream benchmarks.  Every figure's rows must equal, as text, the rows
the JAX package's `benchmarks/` print at full size on the CPU (sha1
digests below), and the derived anchors must hold.

The dense-model slice: it holds the flash and decode attention kernels
against their plain versions (bf16 and f32, head dims 64/128, GQA, MQA,
ragged lengths, windows, kv_len 0/1/S) at test_kernels.py's tolerances;
runs granite-3-2b at full width, 2 layers, f32, through the kernels and
holds 9 steps of logits to the JAX package's (constants below, from
`tests/jax_anchor.py`); checks at full depth in bf16 that prefill plus
decode reproduces the full-sequence logits and that the kernel path
equals the plain one; then serves 16 requests of granite-3-2b at full
width and depth through `repro_torch.launch.serve` (the main path of this
slice, both kernels' launches counted), and times both kernels at the
serving shapes beside their bound, their plain versions and PyTorch's
`scaled_dot_product_attention` (timed only, never on the path).

Each phase prints one JSON line; any failure raises and exits non-zero.
The last three lines are the card's `nvidia-smi` name and power limit,
the `kernels` line (launches on the main path, times, bound, error) and
`{"ok": true, "device": ...}`.

Without CUDA, or without the port's sources beside it, the script exits
non-zero before it prints any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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

JAX_ANCHOR = {
    "ids": [
        88, 1669, 1915, 2886, 4592, 8584, 12593, 14919, 16047, 17344, 17608,
        20453, 20641, 21813, 23088, 24309, 24569, 25522, 28357, 33194, 34458,
        35728, 36547, 36989, 39017, 39166, 39209, 42041, 42915, 44464, 46063,
        48645],
    "logits": [
        [0.8349325, 0.5564706, 0.4803833, 0.4947059, 0.874156, 0.153767,
        -0.7384936, 0.3480513, -0.9014791, 2.04846, -1.327042, -0.9915609,
        -0.3983736, -1.016637, 0.2055046, -0.3216699, -0.3573205, -1.362282,
        -0.1617711, -0.642314, -0.5371283, -0.3576413, -1.634769, -0.7541413,
        -0.5677709, 0.1244353, 0.9472037, -1.330779, -0.2296532, 0.8675332,
        -0.2586546, -0.7195846],
        [1.063141, 0.03013297, 0.3017052, 0.3652909, -0.1038345, -0.3914072,
        -0.4772812, -1.087976, -0.5503518, 1.25127, 0.965122, -0.1062978,
        -0.3979743, -1.19198, -0.785124, 0.1039467, -0.7469777, -0.1407592,
        0.9613039, 0.2497094, 0.1070666, 0.09109443, -0.9119735, 2.584139,
        -0.05588926, 0.743999, -0.6059507, 0.2331166, 0.9162216, 0.897109,
        -0.521718, -2.137908],
        [0.8436919, -1.056566, 2.135766, 1.533339, 1.849396, 0.793468,
        0.8610055, -0.1822883, 1.080245, 0.4034586, 1.242629, -0.2498783,
        -0.5213537, -0.5083528, 0.3792535, 1.651104, -1.946255, -0.6923496,
        0.4492723, -0.5924249, -1.381632, 2.879575, -1.542106, -0.08940526,
        0.8287466, 0.3014392, -1.666813, 0.7829713, 1.096585, 0.2801168,
        -0.9138727, -0.2720479],
        [-0.214982, -1.339163, 0.03679512, 2.157123, 0.3363093, 0.1469091,
        0.1577609, 1.260007, -0.3528661, -0.09985338, -0.4485885, -0.7334901,
        -1.676003, -0.4740516, -0.7764836, 0.4213002, -0.1035119, -0.2624854,
        -1.040752, 0.1747499, 0.1071145, 0.123358, -1.033981, -0.4750347,
        0.8419559, -0.07449543, -0.2547243, -0.2956035, 0.624927, 0.8175223,
        1.139109, -3.030848],
        [1.230535, -0.8212826, 1.973333, 1.812337, 1.727169, 1.091834,
        0.206405, 0.158328, -0.2360633, -0.1778244, 0.8791313, -0.4257953,
        0.1107813, -1.08449, 0.7624906, 0.08150293, -1.190283, 0.01825264,
        0.3928718, -1.265078, -0.528325, -1.008178, 0.2722888, 2.01487,
        0.7512109, -2.573967, -0.9601763, -0.7249795, 0.8061907, 0.2242236,
        0.8010261, -2.032683],
        [1.811359, -2.067924, 1.318605, 2.51458, 1.122855, 0.06094385,
        -1.533679, 0.5693012, -0.4620675, -0.4939148, 0.6342771, -0.5257693,
        -0.1270723, -0.5420331, -0.2333738, 0.5011026, -0.7781134,
        -0.001302612, 1.415381, -0.2107833, -1.450231, -0.1149438, -0.6670612,
        -0.5586988, 0.337664, 0.5359989, 0.7168035, 0.4911839, 0.1718895,
        1.376023, -0.8379095, -0.5239082],
        [1.091759, -0.9371223, 1.960105, 1.357069, -0.7484001, 0.7949663,
        0.8706264, -0.4186225, 0.1390078, 1.298477, -0.5089136, -1.207838,
        -1.029361, -1.387645, 0.2629774, -1.54398, 0.4357385, -0.4182017,
        0.7077208, -0.858943, -0.1201104, -0.2722214, -0.8483382, 0.1210557,
        -0.45013, 0.2662328, 2.310829, -0.2381575, 2.42792, 0.3276951,
        1.236176, -1.634087],
        [0.5749879, -0.3932647, 0.6986502, 1.614389, 0.9145082, 0.9102515,
        -0.3909657, 0.325337, -0.5225634, -0.08067092, 2.04463, -0.3977899,
        0.4890165, -1.99433, -0.8238759, 1.45417, -0.5953979, 1.409954,
        -0.9973905, -2.083793, -0.8744525, 0.388604, -1.114267, -0.7518743,
        -0.7243747, -0.6162018, -0.5829156, 0.7648348, 0.8725211, 1.121339,
        -1.713282, -2.038196],
        [-0.2287691, -0.2720309, -0.8873715, 1.339879, 0.5507802, -0.7441686,
        0.7520065, 0.7628414, -0.4622079, -0.5954652, 0.2883223, 0.04890828,
        0.5885181, 0.4568821, -0.7526501, 0.6783896, -0.7899295, -1.322268,
        0.001814877, -0.8015313, 0.7061204, 0.1427595, -1.730647, 1.250331,
        0.6995131, 0.567955, 0.1699921, 0.1001074, -1.129924, 0.5805687,
        0.0003300077, -2.145766],
    ],
    "argmax": [
        4372, 31350, 3103, 43374, 41406, 39090, 25621, 46948, 30911],
    "gap": [
        0.03007, 0.091, 0.2913, 0.0006471, 0.0002387, 0.3376, 0.1036, 0.4,
        0.2129],
    "tokens_sha1": "ee35da3e2d8d697c732889a52cdc4d1dd4dbc008",
}
# the anchor's logits are f32 on the card against f32 on the JAX
# package's CPU run: 2 layers of d 2048 / ff 8192 products in another
# summation order leave ~1e-5; the argmax must agree wherever the JAX
# run's top two logits are further apart than twice this
ANCHOR_TOL = 1e-3
# kernel against plain version: test_kernels.py's tolerances
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 at full depth: 8 significant bits (unit roundoff 3.9e-3) re-rounded
# by 40 residual layers of matmuls whose shapes (and so summation orders)
# differ between the two paths compared: a random walk of ~sqrt(80) x
# 3.9e-3 = 3.5e-2 in relative L2 norm of the logits
DEEP_BF16_REL = 5e-2

# HBM bytes/s of one H100 SXM (NVIDIA's data sheet, as the on-chip
# measurement guide tabulates it)
HBM_BYTES_PER_S = 3.35e12
# int32 lanes of a Hopper SM: 4 partitions x 16 INT32 units (NVIDIA H100
# Tensor Core GPU Architecture whitepaper, "H100 SM architecture").  The
# card's int32 issue rate is SMs x lanes x its maximum SM clock; the
# data sheet's 1,980 MHz boost stands in where nvidia-smi reports none.
INT32_LANES_PER_SM = 64
H100_SXM_MAX_SM_MHZ = 1_980.0
# dense bf16 tensor-core rate of one H100 SXM (NVIDIA's data sheet)
BF16_FLOPS_PER_S = 989e12


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
    """nvcc on every kernel source at once, one process each."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import window_distance as wd
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(mod.build, True) for name, mod in
                (("window_distance", wd), ("flash_attention", fa),
                 ("decode_attention", da))}
        libs = {name: os.path.relpath(f.result(), ROOT)
                for name, f in futs.items()}
    secs = round(time.perf_counter() - t0, 3)
    emit("build", seconds=secs, library=libs.pop("window_distance"))
    emit("build_attention", seconds=secs, libraries=libs)


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


# ---------------------------------------------------------------------------
# the dense-model slice: attention kernels, granite-3-2b, serving
# ---------------------------------------------------------------------------

ATTN_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu"}
ATTN_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:100",
    "decode_attention": "src/repro/kernels/decode_attention.py:78"}
FLASH_CASES = (  # (B, T, H, KH, D, window): prompt lengths, GQA g 1/4, MQA
    (1, 1, 32, 8, 64, 0), (2, 63, 8, 8, 64, 0), (1, 64, 32, 8, 64, 0),
    (2, 65, 8, 2, 128, 0), (1, 1000, 32, 8, 64, 0), (2, 300, 8, 1, 128, 0),
    (1, 257, 8, 2, 64, 100), (2, 129, 4, 4, 128, 64))
DECODE_CASES = (  # (B, S, H, KH, D)
    (4, 2048, 32, 8, 64), (4, 300, 8, 8, 64), (4, 256, 8, 1, 128),
    (4, 128, 16, 4, 128))
SERVE = dict(num_requests=16, batch=8, max_len=2048, new_tokens=64,
             prompt_len=(100, 1500))


def _attn_err(got, want, dtype, what: str) -> float:
    """Max |got - want|, after holding it to allclose at ATTN_TOL."""
    tol = ATTN_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol, msg=lambda m: f"{what}: {m}")
    return float((got.float() - want.float()).abs().max())


def phase_attention_vs_plain(dev, errs: dict) -> None:
    """Both attention kernels against their plain versions, bf16 and
    f32, over the shapes of the model path and its edges."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        for b, t, h, kh, d, window in FLASH_CASES:
            q, k, v = r(b, t, h, d), r(b, t, kh, d), r(b, t, kh, d)
            err = _attn_err(fa.flash_attention(q, k, v, window=window),
                            fa.flash_attention_plain(q, k, v, window=window),
                            dtype, f"flash {dtype} T={t} H={h}/{kh} D={d} "
                                   f"window={window}")
            key = ("flash", str(dtype).split(".")[-1])
            worst[key] = max(worst.get(key, 0.0), err)
        for b, s, h, kh, d in DECODE_CASES:
            q, kc, vc = r(b, h, d), r(b, s, kh, d), r(b, s, kh, d)
            kv_len = torch.tensor([0, 1, s, s // 3 + 7], dtype=torch.int32,
                                  device=dev)
            got = da.decode_attention(q, kc, vc, kv_len)
            check(not got[0].any(), "decode kv_len == 0 is not zero")
            err = _attn_err(got, da.decode_attention_plain(q, kc, vc, kv_len),
                            dtype, f"decode {dtype} S={s} H={h}/{kh} D={d}")
            key = ("decode", str(dtype).split(".")[-1])
            worst[key] = max(worst.get(key, 0.0), err)
    torch.cuda.synchronize()
    for (name, _), err in worst.items():
        key = f"{name}_attention"
        errs[key] = max(errs[key], err)
    emit("attention_vs_plain", flash_cases=len(FLASH_CASES),
         decode_cases=len(DECODE_CASES), dtypes=["float32", "bfloat16"],
         tolerance=ATTN_TOL, max_abs_err={f"{n} {d}": e for (n, d), e in
                                           worst.items()}, match=True)


def _granite(**kw):
    from repro_torch.configs import base as cb
    cb.load_all()
    return dataclasses.replace(cb.get_config("granite-3-2b"), **kw)


def anchor_inputs(vocab: int):
    """`tests/jax_anchor.py`'s tokens (97-token prompt, then 8 decode
    inputs) and the 32 vocab ids compared: the same draws."""
    rng = np.random.default_rng(2026)
    tokens = rng.integers(0, vocab, (1, 105)).astype(np.int32)
    ids = np.sort(rng.choice(vocab, 32, replace=False)).astype(np.int64)
    return tokens, ids


def phase_model_jax_anchor(dev) -> None:
    """granite-3-2b at full width, 2 layers, f32, weights from
    `numpy_params(cfg, 0)`: prefill 97 tokens and decode 8 through the
    kernels; logits at 32 ids and the argmax of each step against the JAX
    package's (JAX_ANCHOR)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import convert, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False, "tf32 is on")
    cfg = _granite(num_layers=2, dtype="float32")
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), dev,
                                       torch.float32)
    tokens, ids = anchor_inputs(cfg.vocab)
    check(ids.tolist() == JAX_ANCHOR["ids"] and
          hashlib.sha1(tokens.tobytes()).hexdigest() ==
          JAX_ANCHOR["tokens_sha1"], "numpy drew other anchor inputs")
    f0, d0 = fa.flash_attention.launches, da.decode_attention.launches
    prompt = 97
    logits, cache, _ = transformer.prefill(cfg, params,
                                           {"tokens": tokens[:, :prompt]})
    cache = [[{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, 8))
               for n in c} for c in seg] for seg in cache]
    rows = [logits[0, -1]]
    for i in range(prompt, prompt + 8):
        logits, cache, _ = transformer.decode_step(
            cfg, params, {"tokens": tokens[:, i:i + 1],
                          "positions": np.full((1,), i, np.int32)}, cache)
        rows.append(logits[0, -1])
    torch.cuda.synchronize()
    launched = (fa.flash_attention.launches - f0,
                da.decode_attention.launches - d0)
    check(launched == (2, 16), f"anchor launched {launched}, not (2, 16)")
    got = torch.stack(rows).double().cpu().numpy()
    want = np.asarray(JAX_ANCHOR["logits"])
    err = float(np.abs(got[:, ids] - want).max())
    check(err <= ANCHOR_TOL, f"anchor logits differ from JAX's by {err}")
    argmax = got.argmax(1).tolist()
    for step, (a, w, gap) in enumerate(zip(argmax, JAX_ANCHOR["argmax"],
                                           JAX_ANCHOR["gap"])):
        if gap > 2 * ANCHOR_TOL:
            check(a == w, f"anchor step {step}: argmax {a}, JAX {w}")
        else:   # a near-tie in the JAX run: its winner must still tie
            check(got[step].max() - got[step, w] <= 2 * ANCHOR_TOL,
                  f"anchor step {step}: JAX's argmax {w} is not a top logit")
    emit("model_jax_anchor", arch="granite-3-2b", layers=2, dtype="float32",
         prompt=prompt, decode_steps=8, compared_ids=len(ids),
         max_abs_err=err, tolerance=ANCHOR_TOL, argmax=argmax,
         argmax_match=sum(a == w for a, w in zip(argmax,
                                                 JAX_ANCHOR["argmax"])),
         launches={"flash_attention": launched[0],
                   "decode_attention": launched[1]})
    del params, cache


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def phase_model_consistency(dev) -> None:
    """granite-3-2b at full width and depth in bf16, random weights: the
    golden check (prefill + teacher-forced decode reproduce the
    full-sequence logits) and the kernel path against the plain one."""
    from repro_torch.models import transformer
    cfg = _granite()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    b, t, t0 = 2, 80, 64
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (b, t)).astype(
        np.int32)
    out = {}
    t_start = time.perf_counter()
    for mode in ("auto", "plain"):
        x, _, _, ctx = transformer.forward(cfg, params, {"tokens": tokens},
                                           use_kernel=mode)
        full = transformer._logits(cfg, params, x, ctx)
        logits, cache, _ = transformer.prefill(
            cfg, params, {"tokens": tokens[:, :t0]}, use_kernel=mode)
        cache = [[{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, t - t0))
                   for n in c} for c in seg] for seg in cache]
        steps = [logits]
        for i in range(t0, t - 1):
            logits, cache, _ = transformer.decode_step(
                cfg, params, {"tokens": tokens[:, i:i + 1],
                              "positions": np.full((b,), i, np.int32)},
                cache, use_kernel=mode)
            steps.append(logits)
        out[mode] = (full, torch.cat(steps, 1))
        del cache
    torch.cuda.synchronize()
    full, steps = out["auto"]
    rel = {"golden": _rel(steps, full[:, t0 - 1:t - 1]),
           "kernel_vs_plain_full": _rel(full, out["plain"][0]),
           "kernel_vs_plain_decode": _rel(steps, out["plain"][1])}
    for name, value in rel.items():
        check(value <= DEEP_BF16_REL, f"model_consistency {name}: relative "
                                      f"L2 {value} > {DEEP_BF16_REL}")
    agree = float((steps.argmax(-1) == full[:, t0 - 1:t - 1].argmax(-1))
                  .float().mean())
    emit("model_consistency", arch="granite-3-2b",
         layers=cfg.num_layers, dtype="bfloat16", batch=b, prefill=t0,
         decode_steps=t - 1 - t0, rel_l2=rel, tolerance=DEEP_BF16_REL,
         golden_max_abs=float((steps.float() - full[:, t0 - 1:t - 1].float())
                              .abs().max()),
         golden_argmax_agreement=agree,
         seconds=round(time.perf_counter() - t_start, 3))
    del params, out, full, steps


def phase_model_serve(dev) -> dict:
    """The slice's main path: `repro_torch.launch.serve` serving
    granite-3-2b at full width and depth, bf16, through both kernels.
    The kernels' counts are set to 0 just before and read just after."""
    from repro_torch.configs import base as cb
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    fa.flash_attention.launches = 0
    da.decode_attention.launches = 0
    report = serve.serve("granite-3-2b", device=dev, **SERVE)
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": da.decode_attention.launches}
    check(report["finished"] == SERVE["num_requests"],
          f"served {report['finished']} of {SERVE['num_requests']}")
    check(report["generated_tokens"] ==
          SERVE["num_requests"] * SERVE["new_tokens"], "tokens missing")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the serving path")
    cfg = cb.get_config("granite-3-2b")
    emit("model_serve", arch=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, **{k: v for k, v in SERVE.items()
                             if k != "prompt_len"},
         prompt_len=list(SERVE["prompt_len"]), launches=launches, **report)
    return launches


def _kernel_ms(prof) -> dict:
    """Device milliseconds of the kernels a torch.profiler run saw, summed
    by kind (the two attention kernels, GEMMs, everything else)."""
    kinds = dict.fromkeys(("flash_attention", "decode_attention", "gemm",
                           "other"), 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.lower()
        if "flash_kernel" in name:
            kind = "flash_attention"
        elif "decode_kernel" in name:
            kind = "decode_attention"
        elif any(w in name for w in ("gemm", "xmma", "nvjet", "cutlass")):
            kind = "gemm"
        else:
            kind = "other"
        kinds[kind] += us / 1e3
    return kinds


def phase_serve_profile(dev) -> None:
    """Where a serving step's time goes, at the serving shapes: host wall
    time of an admission step (8 prompts prefilled, then one decode) and
    of 8 steady decode steps, without the profiler; then the same windows
    under `torch.profiler` for the device time of each kind of kernel.
    The device's idle share is 1 - device time / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serve.engine import model_batcher
    cfg = _granite()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = lambda: serve.requests(cfg, SERVE["batch"], 24,
                                  SERVE["prompt_len"], seed=1)
    prompt_tokens = sum(len(r.prompt) for r in reqs())

    def windows(batcher, wrap):
        for r in reqs():
            batcher.submit(r)
        out = {}
        for name, n, warm in (("admission", 1, 0), ("decode", 8, 7)):
            for _ in range(warm):
                batcher.step()
            torch.cuda.synchronize()
            with wrap() as ctx:
                t0 = time.perf_counter()
                for _ in range(n):
                    batcher.step()
                torch.cuda.synchronize()
                out[name] = (1e3 * (time.perf_counter() - t0) / n, ctx)
        return out

    plain = windows(model_batcher(cfg, params, SERVE["batch"],
                                  SERVE["max_len"], device=dev),
                    contextlib.nullcontext)
    traced = windows(model_batcher(cfg, params, SERVE["batch"],
                                   SERVE["max_len"], device=dev),
                     lambda: profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]))
    steps = {"admission": 1, "decode": 8}
    for name in ("admission", "decode"):
        wall_ms = plain[name][0]
        kinds = {k: v / steps[name]
                 for k, v in _kernel_ms(traced[name][1]).items()}
        busy = sum(kinds.values())
        # a profiler that sees no device time measures nothing: say so
        # rather than report an idle share of 1
        emit(f"serve_profile_{name}", batch=SERVE["batch"],
             prompt_tokens=prompt_tokens if name == "admission" else 0,
             wall_ms_per_step=wall_ms,
             traced_wall_ms_per_step=traced[name][0],
             device_ms_per_step=busy if busy > 0 else None,
             idle_share=1.0 - busy / wall_ms if busy > 0 else None,
             device_ms_by_kind=kinds if busy > 0 else None)
    del params


def _sdpa(q, k, v, **kw):
    """PyTorch's fused attention on (B, T, H, D) views: the yardstick
    (`library_ms`), never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def phase_time_attention(dev, errs: dict) -> dict:
    """Kernel, plain and library times at the serving shapes: prefill of
    a 1024-token prompt, and a decode step at batch 8 over a 2048-slot
    cache with ragged kv_len.  Decode cycles through 4 layers' caches
    (134 MB, beyond the 50 MB L2), as a decode step meets them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    cfg = _granite()
    h, kh, d, dt = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
    out = {}

    t = 1024
    q, k, v = r(1, t, h, d), r(1, t, kh, d), r(1, t, kh, d)
    err = _attn_err(fa.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v), dt, "flash timing")
    errs["flash_attention"] = max(errs["flash_attention"], err)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
    lib_ms = cuda_ms(lambda: _sdpa(q, k, v, is_causal=True), 20)
    flops = 4 * h * d * (t * (t + 1) // 2)
    nbytes = 2 * t * (2 * h + 2 * kh) * d
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    out["flash_attention"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=f"prefill B=1 T={t} H={h} KH={kh} D={d} bf16 causal",
        flops=flops, bytes=nbytes)
    emit("time_flash_attention", **out["flash_attention"])

    b, s, layers = 8, 2048, 4
    kv_len = torch.as_tensor(np.random.default_rng(1).integers(
        100, 1565, b).astype(np.int32), device=dev)
    q = r(b, h, d)
    kc, vc = r(layers, b, s, kh, d), r(layers, b, s, kh, d)
    err = _attn_err(da.decode_attention(q, kc[0], vc[0], kv_len),
                    da.decode_attention_plain(q, kc[0], vc[0], kv_len), dt,
                    "decode timing")
    errs["decode_attention"] = max(errs["decode_attention"], err)
    mask = (torch.arange(s, device=dev)[None, :] < kv_len[:, None])[
        :, None, None, :]

    def cycled(fn):
        state = {"i": 0}

        def call():
            i = state["i"] = (state["i"] + 1) % layers
            fn(kc[i], vc[i])
        return call

    ms = cuda_ms(cycled(lambda kk, vv: da.decode_attention(q, kk, vv,
                                                           kv_len)), 200)
    plain_ms = cuda_ms(cycled(lambda kk, vv: da.decode_attention_plain(
        q, kk, vv, kv_len)), 20)
    lib_ms = cuda_ms(cycled(lambda kk, vv: _sdpa(
        q[:, None], kk, vv, attn_mask=mask)), 200)
    n_len = int(kv_len.sum())
    nbytes = 2 * (2 * n_len * kh * d + 2 * b * h * d) + 4 * b
    flops = 4 * n_len * h * d
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    out["decode_attention"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        shape=f"decode B={b} S={s} H={h} KH={kh} D={d} bf16, "
              f"kv_len {kv_len.tolist()}",
        flops=flops, bytes=nbytes)
    emit("time_decode_attention", **out["decode_attention"])
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

    # the dense-model slice
    attn_errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    phase_attention_vs_plain(dev, attn_errs)
    phase_model_jax_anchor(dev)
    phase_model_consistency(dev)
    torch.cuda.empty_cache()
    attn_launches = phase_model_serve(dev)    # its main path, counted
    torch.cuda.empty_cache()
    attn_times = phase_time_attention(dev, attn_errs)
    phase_serve_profile(dev)
    kernels += [{
        "name": name, "route": "cuda", "source": ATTN_SOURCES[name],
        "replaces": ATTN_REPLACES[name], "launches": attn_launches[name],
        "max_abs_err": attn_errs[name], "ms": attn_times[name]["ms"],
        "plain_ms": attn_times[name]["plain_ms"],
        "bound_ms": attn_times[name]["bound_ms"],
        "bound_by": attn_times[name]["bound_by"],
        "library_ms": attn_times[name]["library_ms"],
        "match": True, "shape": attn_times[name]["shape"]}
        for name in ("flash_attention", "decode_attention")]
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
