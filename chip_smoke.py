#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run it from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--parent DIR]

(`--parent` names a checkout of another commit, e.g. the parent unpacked
with `git archive`, whose window kernel is then timed beside this one's
on the same inputs.)

It builds the port's six kernel sources from
`src/repro_torch/kernels/csrc/` with `nvcc` (one process per source, all
started together).  Each line is stamped with the seconds since the
script started (`t`).

The simulator slice: it holds both entry points of the window kernel
(`window_grid`, `window_cell`) on the card against their plain PyTorch
versions bit for bit, on seeded small grids and cells on both kernel
routes ("bitset" at 7, 29 and 32 tags, "generic" at 33; windows around a
warp and a pass; the plain results computed meanwhile by
`PLAIN_WORKERS` host processes, the comparison made after the sched
slice), and drives the simulator's main path at the paper's full size
through the entry points a user calls: the fig7 grid and the P=4 fleet sweep through
`simulator.sweep_fleet`, a serving session of resumed `simulate_many`
epochs, and the fig6/fig4/fig5/bitstream benchmarks; every window launch
there must take the bitset route.  Every figure's rows must equal, as
text, the rows the JAX package's `benchmarks/` print at full size on the
CPU (sha1 digests below), and the derived anchors must hold.  The fig7
and serving phases split their wall time (`host_split`: trace build,
stream gather, copies to the card, state translation, the rest), and the
window timings give each main-path shape (fig7 grid, P=4 fleet grid,
serving epoch) its event and profiler device time, bound, plain time and
the slowest cell's trips, passes and device ns a pass.

The sched slice (`repro_torch.sched` and the serve engine's sched half)
drives the window kernel on new paths, each phase counting its launches
from 0 (every one must take the bitset route): `sched_placement` runs
`placement_study` and `placement_search` (every candidate co-residency
group priced through `window_grid`); `sched_online` runs `online_churn`
and `chaos_serve` with its crash-restart parity (every seedable epoch and
migration probe resumed through `window_cell`; the segments after an SEU
or a flush, and those of a degraded core, on the reference machine,
counted and timed); `sched_fleet_scale`, the slice's main path, serves
`fleet_scale_study` at its full sizes (256, 512 and 1,000 tenants on 32,
64 and 128 cores, both re-solve modes, its parity and sublinearity
asserts included, no resumed segment on the reference machine), holds
the window kernel to its plain version at the widest shapes that loop
gave it (a cell's epoch and probe, a candidate-group grid), and splits
its wall time (placement search, `sweep_fleet`, resumed epochs with
`_seed_carry` and `_state_from_final`, the kernel's device time, the
rest, and the least the split's own synchronisations cost);
`sched_engine` runs `SlotServeEngine.plan_coresidency`,
`apply_admission` and `serve_online` under a seeded `FaultPlan.storm`,
then `perf_slot_decode`'s fleet rows (its slot half serves the reduced
arctic's 16-wide heads, which the card's attention kernels do not take;
the CPU test holds it).  Rows equal the JAX package's (sha1 digests below, from
`tests/jax_sched_anchor.py`): as text, or on every field but the seconds
(placement_search's, fleet_scale_study's rows and its reports: final
cores, move and epoch logs, per-tenant metrics); the engine's plan and
report as JSON; perf_slot_decode's fleet rows as text; and
BENCH_fleet.json's anchors hold (1.075/1.075/1.113, 1.0768, 1.0441 with
1 migration, 1.0377/1.0551/2.3480).

The workloads slice (`repro_torch.workloads` and the simulator's perf
benchmarks): `workloads_mix` prints the zoo's 20-cell mix table from the
port's op counter (the smoke models under a `TorchDispatchMode` with
plain kernels, counted by a host worker process while the card runs the
earlier phases), each cell's isa-group fractions, hottest F groups and
seconds, the prefill/decode asymmetry checked; `model_serve_study` places
a mixed prefill/decode fleet of model-zoo tenants on the card (every
candidate group priced through `window_grid`; placed <= random mean at
P=2 and P=3, no reference-machine dispatch, the rows held to the port's
CPU digest: the JAX package's come from XLA-counted mixes); `perf_sweep`
runs its five engine sections at the reference's sizes (each fast engine
held bit for bit to the reference machine, whose arms run once after a
one-graph warm-up; the current step to the frozen first step design, both
replayed as CUDA graphs), then `window_kernel`, the kernel against the
plain window pass on a one-shot sweep and a resumed segment, parity
before timing, its launches per route printed apart (they compare the
kernel with its plain version and are not counted on the kernels line).

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
`scaled_dot_product_attention` (timed only, never on the path).  The
bf16 kernels are Hopper designs: flash runs both products as `wgmma` on
TMA-fed bf16 tiles, decode splits the KV axis across CTAs (then a merge
kernel) with `mma.sync` products; each is timed twice, by CUDA events
over back-to-back wrapper calls (`ms`) and by its device time under
`torch.profiler` (`device_ms`, the merge included), SDPA likewise, and
flash at prompts of 128 to 2,048 tokens.

The MoE slice: it holds the grouped-FFN kernel's two entry points
(`moe_gmm`, `moe_gmm_skip`) against their plain versions (f32 and bf16,
test_kernels.py's shapes, ragged and ungated cases, empty experts exact
zeros, and both model-path shapes at full width); runs arctic-480b at
full width, 1 layer and 8 experts, f32, through the kernels and holds 9
steps of logits and every step's expert load to the JAX package's
(constants below, from `tests/jax_anchor.py`); checks at full width, 2
layers and all 128 experts in bf16 that the kernel path equals the plain
one; serves 8 requests of that model through `repro_torch.launch.serve`
with its expert-slot half (the main path of this slice, both entry
points' launches counted); runs the paper-technique setting of
`benchmarks/perf_slot_decode.py` (4 tenants, 16 expert shards, slots x
slot-hit bias) through `SlotServeEngine`; and times both entry points at
the serving shapes beside their bound, their plain versions and three
`torch.bmm` calls (timed only, never on the path).

The recurrent slice: it holds the RG-LRU and WKV scans (`rglru_scan`,
`rwkv6_scan`) against their plain versions on each of their two kernel
routes, "chunked" and "step" (test_kernels.py's shapes, the serving
path's ragged prompt lengths, T below a sub-chunk, strong decay, bf16 and
f32, from zero and from given states, and the full-width prefill and
decode shapes) and the attention kernels at
recurrentgemma's head dim 256 with 16 query heads over 1; runs
recurrentgemma-9b (3 layers: one (rec, rec, lattn) segment) and rwkv6-7b
(2 layers) at full width, f32, through the kernels and holds 9 steps of
logits to the JAX package's (constants below, from `tests/jax_anchor.py`);
times both scans and both attention kernels at head dim 256 beside their
bounds and plain versions (SDPA for the attention ones); then, for each
model at full width and depth in bf16, checks the kernel path against the
plain one (recurrentgemma: a 4,096-token prompt, two windows, then decode
past 4,096 around the ring; rwkv6: 1,024 tokens), profiles a serving
step and an admission, and serves 16 requests through
`repro_torch.launch.serve` (the main path of this slice, each kernel's
launches counted, and each scan's routes: every prefill on the chunked
route, every decode step on the step route).

The training slice (`repro_torch.data`, `optim`, `train`, `checkpoint`,
`runtime`, `launch.train`): `train_grads` holds each of the four kernels
on the training path (flash attention, `moe_gmm`, both scans: the
kernel's forward with its plain version's gradient) against the plain
route, gradients of a fixed random cotangent within 1e-4 relative L2, at
the shapes of their checks above in f32; `train_granite`, the slice's
main path, trains granite-3-2b at full width and depth (40 layers, bf16
weights with an f32 master, m and v, remat "full", loss_chunk 512, batch
4 of 1,024 tokens, 8 steps) through `launch.train.run`: the loss falls,
flash launches twice a layer a step and takes one plain backward a layer
a step, decode attention and `moe_gmm_skip` never launch; the median step
time, tokens/s, peak memory and flash's plain-vjp share of a step are
printed; `train_restart` runs the supervised restart at full width cut
to 2 layers (8 steps, a checkpoint every 4, a failure before step 6):
one restart, the final loss the clean run's within rel 1e-4.

The substrate slice (`repro_torch.analysis.cost`, `launch.dryrun`,
`launch.perf`, the bench runner, `bench.perf_gate`, the examples), each
path's kernel launches counted from 0: `dryrun_sweep` counts all 32
(arch x shape) cells through `launch.dryrun` on the meta device in a host
worker (started once the window kernel's plain results are in) and
prints one line a cell and the roofline table; `dryrun_vs_card`, the slice's gate, counts one training
step of granite-3-2b at train_granite's shape on the card with the same
counter and holds its FLOPs by dtype class, bytes, ops and kernel
charges equal to the meta estimate, then prints the estimate against
train_granite's median step, that step's TFLOP/s and share of the bf16
peak (counted, and by 6 N T) and the one-card budget against its peak
memory; `examples` runs the port's seven examples on the card (the smoke
configs at head dim 64), paper_repro's anchors held; `bench_runner` runs
`python -m repro_torch.bench --list` and two `--only` runs merged into
one record with the card's provenance, and `perf_gate` over it (the
record against itself passes, a copy with one entry 2x slower fails).

Each phase prints one JSON line; any failure raises and exits non-zero.
The last three lines are the card's `nvidia-smi` name and power limit,
the `kernels` line (all eight kernels: launches on their slice's main
path, the window rows' with the sched, model_serve_study and perf_sweep
phases' added and split in `launches_by_slice`; times, bound, error; the
four training kernels' `train_launches` and `train_backward_recomputes`
on granite's training run; the substrate slice's launches in
`launches_by_slice`) and `{"ok": true, "device": ...}`.

Without CUDA, or without the port's sources beside it, the script exits
non-zero before it prints any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
    # the sched benchmarks (`tests/jax_sched_anchor.py`): rows as text, or
    # every field but the seconds (`search_rows_held`, `fleet_rows_held`,
    # `fleet_reports_held`), the engine's plan and report as JSON
    "placement_study": "c48774d65508142da09a1c74677489164889a149",
    "placement_search": "773a3a29cea41e8a02d455d96c6e40d0b2f21ee1",
    "online_churn": "8ed16ba3aea2616849cb89835e684da84216d8a1",
    "chaos_serve": "8ff4da8817db223bb01cf80d97a18b528c7a3f31",
    "fleet_scale_rows": "e4724c544f3a55fc76fcd6ca2585bdac5845b5f1",
    "fleet_scale_reports": "d0e7a1648113c3eefbd70648d832b8325c3033e8",
    "perf_slot_decode_fleet": "c771e6fecf71018a56bff74e7662f23fb1077ea0",
    "engine_plan": "23927f9e334602444799753147976d570ab8212d",
    "engine_online": "7f0cf39bfdf601a9c8b8af4c9c17b40ca8feae62",
    # model_serve_study on the port's own counted mixes (the port on the
    # CPU, held by tests/test_torch_workloads.py): the JAX package's rows
    # come from XLA-counted mixes and are not expected here
    "model_serve_study_torch": "62c96072e37b64f90888c6133f08610a9e7f2ce0",
}
ANCHORS = {
    "fig4": "minver_speedup_F=27.50 (paper 27.5)",
    "fig5": "classes: FM=5 M=8 insensitive=9 (paper: 5/8/9)",
    "fig6": "avg_s2@50c=0.687 (paper ~0.71)",
    "fig7": ("x3.13 over RV32I", "x1.39 over RV32IM", "x1.67 over RV32IF",
             "abs 0.81 of IMF"),
    "fleet_sweep": "P4_avg@10c=0.935; P4_avg@50c=0.757; P4_avg@250c=0.452",
    # BENCH_fleet.json's sched anchors
    "placement_study": ("P2 1.075 vs random", "P3 1.075 vs random",
                        "P4 1.113 vs random"),
    "placement_search": "worst-tenant slowdown 1.0768",
    "online_churn": ("worst slowdown 1.0441", "with 1 migration(s)"),
    "chaos_serve": ("worst lifetime slowdown 1.0377 vs cold_restart 1.0551 "
                    "and none 2.3480", "reproduced the serve bit-for-bit"),
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
MOE_JAX_ANCHOR = {
    "ids": [
        57, 1086, 1246, 1879, 2989, 5587, 8198, 9711, 10445, 11290,
        11463, 13311, 13433, 14199, 15026, 15820, 15993, 16612, 18456,
        21603, 22432, 23256, 23784, 24076, 25395, 25491, 25519, 27361,
        27933, 28944, 29980, 31666],
    "logits": [
        [2.237372, -0.5908996, 1.538924, 0.359022, -0.3612966,
        -0.3892732, 1.586985, 1.274173, -0.2702395, 0.2624988,
        -1.284545, -0.8029127, -0.8912312, 0.9399121, 0.1298637,
        -1.390414, 0.2765056, -0.251314, -0.9560781, -1.705454,
        0.3042816, 0.4699914, -0.3810716, -1.004022, 0.2433458,
        -0.140947, -1.578435, -0.5262463, 1.499557, -0.9746365,
        -1.251054, 1.028966],
        [0.5115263, -0.2004971, 1.017103, -1.654363, 2.906305,
        0.9620841, 0.01280197, -0.000972991, -1.742161, 1.694141,
        -1.090039, -1.47174, -0.124833, -1.819838, -0.08808596,
        -2.123774, 0.7631221, -0.1642651, -1.461378, -0.3037586,
        1.695498, 2.327598, -1.187647, -0.4122697, 0.08682809,
        1.04992, 0.1732143, 0.1706952, 0.8064168, 1.824742, 0.5075678,
        -0.07037106],
        [1.177049, -0.2334222, -0.4929495, 1.655165, -0.04446586,
        1.55529, -0.3794141, 1.299629, -0.3445933, 1.435796, 0.242186,
        -0.3544826, 0.2899604, -1.601366, -1.078171, -1.073672,
        1.876868, -0.9043599, -0.4444573, -1.756056, 0.3117967,
        0.8685732, 0.7599143, -2.075164, -0.01686722, -0.6273391,
        -0.6572786, 0.3107998, -1.149142, -0.4812473, -1.183639,
        -1.216271],
        [0.3784321, -0.5713495, -0.8212148, 0.2763456, 1.351708,
        1.349309, 0.01757317, 0.5932599, -1.521479, 0.3398908,
        -1.383098, -0.1889763, 0.4767704, -2.311808, 0.1415271,
        -1.285247, 1.603681, 1.328449, 0.6304212, -1.011408,
        -1.304453, 0.5787185, 0.3901258, -1.002911, -0.7787659,
        -0.03727992, -0.3668339, 1.582669, -0.1667276, -0.4137266,
        -1.122325, 0.08776538],
        [0.4245566, 0.3980561, -0.2081905, -0.7370323, 2.221416,
        -1.015319, 0.6627094, -0.6917573, 1.012281, -0.164768,
        0.450792, 0.08895432, 0.4482795, -1.177007, -1.520356,
        -0.3172019, -0.4427914, -1.174531, -1.09527, 0.7137988,
        -0.01267156, 1.57408, -0.7462069, -1.395719, 0.1943417,
        -0.05900409, -0.4492127, 0.7158381, -1.056088, -1.078024,
        -0.1217779, 1.77741],
        [-0.3780286, -1.408537, -1.027951, -1.002822, -1.58245,
        1.524794, 0.4607726, 0.8846921, 1.84854, 0.2505696,
        -0.2982658, 0.2907114, -1.518565, -1.423737, 2.156719,
        -0.4107226, 1.077631, -1.414985, -0.3633354, 0.2384803,
        -0.4342262, 0.8698977, -0.344696, -0.8681459, 0.05746187,
        1.315602, -0.5352636, 0.1087202, -0.4053726, 0.4162572,
        -1.147899, -0.660727],
        [0.115905, 0.6694766, -0.2697161, 1.090019, 1.530983,
        -0.9843925, -0.04303294, -1.063346, 0.2344802, 0.2614882,
        -0.1375142, -0.03146726, -0.8917374, -0.4366609, 0.2833623,
        0.6808513, 0.1026595, 0.3995705, -0.6057801, 1.205557,
        -0.129851, 1.372784, -0.070142, -0.08950985, -0.5544121,
        0.7751527, -0.6003513, 0.492048, -1.0278, 0.8568924, -0.06155,
        0.8348945],
        [-0.7716243, 0.272666, 0.84279, -0.1709425, 0.6942478,
        0.5476964, -1.151013, -0.07531491, -0.6825429, -0.4188038,
        -0.193828, 0.7448609, -1.063637, 0.5698252, -1.300678,
        -2.452104, -0.570408, 0.3026768, 0.1141389, 0.3041827,
        -0.359109, -0.05322567, 0.4804122, -0.7519646, 0.04081622,
        0.4965396, 0.1049546, 0.551921, 1.461323, 0.2436262,
        0.9090801, -0.2603284],
        [0.2203759, -1.368036, -1.487612, 1.647262, 1.072437, 1.747789,
        0.8843895, -0.7102207, 1.142558, -0.2184379, 0.5015211,
        -0.2498745, 1.309563, 1.064789, 0.08567041, 0.4076215,
        1.131042, -1.158099, -1.04966, -0.1497414, -0.5491714,
        0.8693866, -0.8197592, -0.1994051, -0.3960609, 0.04666168,
        -1.425079, 0.4913451, -0.3197488, -0.2270255, -0.1887621,
        -0.4520103],
    ],
    "argmax": [
        16436, 30333, 5479, 22146, 23438, 2974, 10204, 3091, 20658],
    "gap": [
        0.2793, 0.19, 0.02946, 0.4893, 0.2497, 0.1812, 0.2032, 0.377,
        0.0513],
    "expert_load": [
        [32, 18, 14, 29, 10, 30, 18, 32],
        [0, 0, 0, 1, 0, 0, 0, 1],
        [0, 0, 0, 0, 1, 0, 0, 1],
        [0, 0, 0, 0, 1, 0, 0, 1],
        [0, 0, 0, 0, 0, 0, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 0],
        [1, 0, 0, 0, 0, 0, 0, 1],
        [0, 0, 0, 1, 0, 0, 1, 0],
        [0, 0, 0, 0, 1, 0, 0, 1],
    ],
    "tokens_sha1": "b566d2a65ceecfa73e1546c4097358da29f688cc",
}
# tests/jax_anchor.py's recurrentgemma and rwkv6 lines (the JAX package
# on the CPU, f32, numpy_params(cfg, 0), 3 and 2 layers at full width)
REC_JAX_ANCHOR = {
    "recurrentgemma-9b": {
        "ids": [
            461, 8699, 9978, 15036, 23921, 44712, 65589, 77712, 83591, 90334,
            91706, 106556, 107556, 113614, 120299, 126662, 127982, 132954,
            147744, 172946, 179458, 186109, 190434, 192685, 203258, 204045,
            204286, 219055, 223564, 231597, 239988, 253367],
        "logits": [
            [1.018698, 0.735514, -0.8984888, -0.3085579, -0.6928808,
            -0.9313681, -1.040863, -0.8109363, 0.9416547, 0.917736, 0.5373851,
            -1.390789, 0.2507879, -1.260308, -0.009328227, 0.8942477,
            -1.453488, 0.583285, -1.497176, 0.5575449, 0.07587409, 0.09495304,
            0.3814689, 0.3075298, 1.352969, 0.9748912, 0.2401006, 0.7727683,
            0.5471948, 0.1736068, -1.087383, 0.5205967],
            [-1.728733, 1.03149, 1.59414, -0.1691406, -0.6164652, -1.342843,
            1.51504, 0.7599623, 1.555015, 0.9841584, 0.4455002, -0.3055396,
            -0.003904819, 1.103458, 0.2283777, 0.1861021, 0.8716831, 1.339756,
            -3.546087, 0.2771772, -1.711669, -0.8209175, 0.2095081, 1.319246,
            0.3824846, 0.2899546, 0.4873616, 2.356256, 0.2168267, -1.095273,
            0.6809593, 0.0453755],
            [0.1073881, 0.822058, -1.455932, -1.271351, 0.1041657, -0.637399,
            2.264084, -0.7208947, -1.738868, 1.293093, 1.216326, 1.212418,
            0.9372728, -0.2722662, -0.1665189, -1.005948, -0.03496424,
            0.4154847, -1.370112, 0.0212053, 1.131291, -0.9691015, -0.9843297,
            0.7633576, 2.133091, -0.814183, -0.01240006, -0.6463373, 1.380478,
            0.2670448, -0.2911757, 0.6155074],
            [-0.1789533, -1.050211, 1.581204, 0.4320412, 0.09379181,
            -0.2843785, 1.985458, -1.317755, 2.149033, 0.8364466, 0.9561391,
            0.04910415, 0.1346583, 0.1238976, 0.4708491, 0.9550574,
            -0.09293137, -2.336084, 0.1652075, 1.113646, 0.1135947, -0.4335955,
            -0.2394716, 0.05581877, -0.6144457, -0.6023268, -0.6515675,
            0.4454378, 1.765241, 1.196804, 0.7467095, 0.3620026],
            [0.7277739, -1.829059, 1.006321, 1.098695, 1.21548, 0.06160735,
            0.748718, -0.7589518, 1.37331, 0.5634727, -0.4425386, -0.5785635,
            -0.4705786, -0.9701193, 0.2112734, 0.3028111, -0.1048598, -1.19434,
            -0.7354079, -1.39111, 0.8166099, -1.415748, 0.6369444, 0.5442073,
            2.107854, -0.8066988, -0.3112919, -0.6574033, -2.377915,
            -0.6194635, 1.650569, -0.5796881],
            [0.6663041, -0.7134057, -2.231908, -0.2347042, -0.6875417,
            -1.878944, -2.021741, 0.433403, 1.330397, 0.7421126, 0.4858523,
            0.5050385, 2.488032, 0.02767721, -0.9681817, 0.007057459,
            -0.3348206, 1.647995, 0.9006841, 0.1024875, 0.3406851, 1.003414,
            0.3185836, 0.5162242, 0.9581241, 0.4410259, -0.3729911, -0.2986686,
            0.2966665, 0.05074862, -0.7740509, 0.9170766],
            [0.2743545, 0.8881807, -0.8489162, 1.18491, -1.905485, 0.7473803,
            1.623532, 1.328535, -1.000232, 1.574853, 1.417011, 0.3593651,
            -0.4913267, -0.2898337, 0.4214064, 1.535755, -0.6092067, 0.211298,
            -0.05414138, -0.5592288, -0.03891622, 0.4611835, -0.4617361,
            0.5687518, 2.897495, 1.088356, -0.2817458, -0.002415877, 0.2851919,
            0.8365051, -1.882184, 1.778705],
            [0.8571795, -0.08944954, 0.4088546, 0.623067, -0.2710397, 1.417598,
            2.293005, -1.675439, -0.05578532, 1.445052, -0.27602, -0.7938517,
            -0.2085311, 0.2113741, -2.894552, 0.180713, -1.404844, -1.353815,
            0.5088928, -1.445585, -0.6801339, 0.02629273, 0.6178017, 1.90996,
            0.2791085, 0.6141564, -0.9412677, 1.599119, -1.038888, 0.9997733,
            -0.6366812, -1.649195],
            [0.4419953, 0.5214753, -0.4697227, -1.055304, 0.4629828, -0.521011,
            -0.5366484, 1.456022, -0.5474143, -3.010437, -0.6598428, -0.93243,
            1.726148, -0.5286554, -2.646858, 0.091088, 0.9049759, -1.564339,
            -0.4076768, -0.7028992, -0.5864503, -1.9981, 0.2863394, -0.2034274,
            1.213194, -0.1969817, -0.4147846, 0.3508691, -0.4163571, 0.1149586,
            0.7014213, -0.07194171],
        ],
        "argmax": [
            244080, 254731, 166595, 210872, 238892, 76464, 189094, 117918,
            231673],
        "gap": [
            0.04731, 0.6174, 0.04346, 0.1452, 0.01492, 0.304, 0.2585, 0.1329,
            0.1313],
        "tokens_sha1": "628ecd36148d22ab6b921ea7a271f98c664a94dd",
    },
    "rwkv6-7b": {
        "ids": [
            118, 2226, 2553, 3849, 6123, 11445, 16790, 19892, 21396, 23124,
            23476, 27271, 27524, 29083, 30787, 32414, 32759, 34030, 37812,
            44261, 45941, 47637, 48734, 49319, 52024, 52223, 52283, 56060,
            57222, 59284, 61421, 64858],
        "logits": [
            [-2.350285, -0.4726654, -0.7917899, -1.264399, -1.973746, 0.390784,
            -0.7060737, 0.5510365, 0.7501987, -0.757821, -0.3116773,
            -0.6023837, -1.501278, 0.7426205, 0.00520525, 1.683385, -0.3995381,
            0.3374277, 0.01837532, -0.8070127, -0.9728953, -0.007300139,
            -0.02565803, 0.0724665, -0.05088924, 1.732957, -0.6765625,
            -0.3728065, 1.635341, -0.1459246, 0.5451612, -1.249231],
            [-0.2565507, -1.069514, 0.1950184, -1.070861, 0.02756393,
            -0.3472816, -0.2209993, 0.5256323, 0.2854192, -0.130297, -1.415007,
            -1.099218, -1.267116, 0.5897917, 0.8183559, 0.7461125, -0.9835152,
            0.3364482, 0.9296156, 0.1352107, -0.5562751, -0.2579877, 0.7063568,
            0.5581586, -1.290525, 1.232774, -0.6071048, -1.52112, 1.526107,
            -0.1573931, 0.7914397, 0.07275136],
            [0.05796605, -2.306087, -0.3576321, 0.6038936, -0.03243478,
            0.1072825, -0.9298621, 0.1354627, -0.8974478, 0.7613785,
            -0.2809737, -1.668024, -0.6003557, -0.2984824, 1.653612, 0.3142149,
            0.5912043, 0.4438815, -0.9680923, -0.02370439, -0.4994634,
            0.07642838, 2.866967, 0.4038159, 0.3613704, 0.8692777, -0.5751393,
            -0.392235, 0.3336165, 1.334867, -0.3891317, -0.7960103],
            [0.3800783, -1.880003, 0.8981623, 1.784161, 0.03748908, 0.3569387,
            0.7049616, 0.2110332, 0.2114167, -0.3940758, 0.4140187, 0.7475567,
            -0.009711237, -0.2161764, 1.332819, -1.67108, -0.8429907,
            0.0666237, 1.216287, -1.459478, -0.04784252, 1.85639, 0.9808472,
            0.3190868, -0.2145577, 1.215142, -1.378512, 0.326036, -1.000824,
            0.6546894, -0.5091891, -0.1586983],
            [0.4302396, -0.6905975, 0.1055214, 2.352709, 0.2029465, 0.9200099,
            2.196998, 0.744951, 0.6440728, -0.5781252, -0.4548102, 1.678893,
            -0.4277707, 0.6246778, 0.5389805, -1.934963, -0.1919302, 0.5395667,
            0.3980522, -1.616039, -1.151129, 0.659846, 1.132425, 0.1829587,
            0.9167669, 2.571751, 1.955458, -1.364695, -0.2511495, 0.6919881,
            -0.2768495, -1.221172],
            [-0.4892927, -1.594279, 0.2194955, 1.25143, 0.02756072, 0.07089557,
            -0.1460209, 0.4482315, 0.3939232, -0.1351599, -1.022245,
            0.0009444409, -0.3075049, -0.070115, 1.415668, -0.8221778,
            0.1202878, -0.1764842, 0.5534784, -0.4802046, -1.434003,
            -0.4043944, 2.632312, 0.15128, 2.339252, -0.212207, 0.5072853,
            -0.2146149, 1.123033, 0.5756732, 0.03900599, -1.264405],
            [-0.176478, -0.03167297, 0.170427, 1.037448, 0.6184548, -0.1538451,
            2.575498, -0.7564026, 1.198465, -1.811432, -0.5742984, -1.864585,
            -0.9834617, -2.299915, 0.759867, -1.403256, -1.490885, -1.33944,
            0.2596593, -0.393157, 0.1068499, 0.8763356, 1.149254, -0.2756452,
            -0.4947666, 0.8060367, 0.3021673, -0.7396038, 1.695276, 0.5699043,
            -0.2545513, -0.7716683],
            [0.07568986, 0.1095396, 1.334091, 0.8803688, 0.8666777, -0.7852255,
            0.2551405, -0.2631436, 1.947149, -4.073595, -2.22992, -2.113391,
            0.124288, -1.07856, -0.07641777, -1.541324, -0.9687642, 0.9686516,
            0.9071197, -0.1898416, -1.42186, -1.506901, -1.895514, 1.130354,
            -1.572088, 0.3462968, 0.60166, -1.400802, 0.2156912, 0.5179883,
            1.593397, 0.3105394],
            [-1.19993, -0.2664025, 0.8127962, 0.7818402, -1.288104, 2.137602,
            -0.5608474, 0.1041086, -0.5369869, -1.108613, -0.2811551,
            -0.9741727, -0.7605146, -1.426836, 0.2582895, 0.9303343, -2.132182,
            -2.083207, -0.2883422, 0.8577261, -0.8672779, 0.02282906,
            -2.416172, -0.4423305, 0.1474737, 0.8637397, 2.607003, -0.08798267,
            0.02295917, 0.1505117, 0.3928798, -0.4750929],
        ],
        "argmax": [
            39039, 58907, 12527, 9943, 40923, 24716, 22702, 64270, 26557],
        "gap": [
            1.267, 0.3025, 0.01763, 0.08427, 0.1067, 0.259, 0.3795, 0.1032,
            0.08967],
        "tokens_sha1": "8b59eb7d22dfb3357b6f7228474f4ff49350fa20",
    },
}
# the anchor's logits are f32 on the card against f32 on the JAX
# package's CPU run: 2 layers of d 2048 / ff 8192 products in another
# summation order leave ~1e-5; the argmax must agree wherever the JAX
# run's top two logits are further apart than twice this
ANCHOR_TOL = 1e-3
# kernel against plain version: test_kernels.py's tolerances
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GMM_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
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
# f32 rate of its CUDA cores (the on-chip guide's table): the scans'
# operations (their modules' `cost`) run there
F32_FLOPS_PER_S = 67e12


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


STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line for `phase`, stamped `t`: seconds since the script
    started (where the run's time goes, phase by phase)."""
    print(json.dumps({"phase": phase, "t": round(
        time.perf_counter() - STARTED, 1), **fields}), flush=True)


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


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


# The profiler can lose the last records of a session, most often in the
# first session after a stretch of unprofiled work (PERF.md).  Every
# session this script profiles therefore ends on `PROFILE_FILLERS` empty
# spin kernels, which no reading counts, and `device_ms` takes the best
# of a few sessions.
PROFILE_FILLERS = 64
FILLER_KERNEL = "spin_kernel"          # torch.cuda._sleep's kernel


@contextlib.contextmanager
def profiled(cpu: bool = True):
    """A `torch.profiler` session of the CPU (unless `cpu` is False) and
    the card whose block is followed by `PROFILE_FILLERS` spin kernels
    (see `cuda_rows`)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        yield prof
        for _ in range(PROFILE_FILLERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


def cuda_rows(prof) -> list:
    """The profiler's per-kernel rows of the card, the fillers left out."""
    return [evt for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.count and FILLER_KERNEL not in evt.key]


def device_ms(fn, reps: int, sessions: int = 3) -> tuple[float | None,
                                                         float]:
    """Device milliseconds of one call of `fn` under `torch.profiler`, and
    the share of its kernels' launches the profiler kept a record of.
    `reps` calls are profiled after one warm-up; each kernel counts at
    its mean over the records kept times the launches it makes a call
    (once for the flash kernel, decode's split and merge, SDPA's kernel
    and its memset, the grouped FFN's two stages; twice for the GEMM
    that three `torch.bmm` run on x @ wg and x @ wi alike, read as the
    nearest whole number of records a call), so a record the profiler
    lost shortens nothing.  A session that lost records is tried again,
    up to `sessions` in all, and the one that kept most is read; where
    none kept a record the device time is None (not measured) and the
    share 0.  `cuda_ms` times the calls back to back and so also sees
    the host between launches (a wrapper's ctypes call and checks, ~30-60
    us); this sees the card's work alone."""
    fn()
    torch.cuda.synchronize()
    best = (None, 0.0)
    for _ in range(sessions):
        with profiled() as prof:
            for _ in range(reps):
                fn()
        kernels = [(evt.count, max(1, round(evt.count / reps)),
                    _device_us(evt)) for evt in cuda_rows(prof)]
        if kernels and sum(us for _, _, us in kernels) > 0:
            kept = min(1.0, min(n / (per * reps) for n, per, _ in kernels))
            if kept > best[1]:
                best = (sum(us / n * per for n, per, us in kernels) / 1e3,
                        kept)
            if kept == 1.0:
                break
    return best


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
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    from repro_torch.kernels import window_distance as wd
    mods = (("window_distance", wd), ("flash_attention", fa),
            ("decode_attention", da), ("moe_gmm", gmm),
            ("rglru_scan", rgs), ("rwkv6_scan", rws))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(mod.build, True) for name, mod in mods}
        libs = {name: os.path.relpath(f.result(), ROOT)
                for name, f in futs.items()}
    secs = round(time.perf_counter() - t0, 3)
    from repro_torch.kernels import common
    emit("build", seconds=secs, library=libs.pop("window_distance"),
         ptxas=common.ptxas_report(wd.SOURCE))
    emit("build_moe", seconds=secs, library=libs.pop("moe_gmm"))
    emit("build_recurrent", seconds=secs,
         libraries={k: libs.pop(k) for k in ("rglru_scan", "rwkv6_scan")})
    emit("build_attention", seconds=secs, libraries=libs,
         ptxas={name: common.ptxas_report(mod.SOURCE)
                for name, mod in mods if name in libs})


QUANTUM_MENU = (6, 37, 120, 1 << 30)
# windows of 1 and 13 rows leave most of a pass idle; 31-33 straddle a warp
# sub-chunk, 256/257 a pass of the bitset route
WINDOWS = (1, 13, 31, 32, 33, 64, 200, 256, 257, 512, 2048)
CHECK_TAGS = (7, 29, 32, 33)        # 32: the bitset route's widest; 33 not
CHECK_PROGS, CHECK_TRACE_LEN, CHECK_STEPS = 3, 300, 1_200


def _routes_since(before: dict, fn) -> dict:
    return {r: n - before[r] for r, n in fn.routes.items()}


def _check_routes(fn, before: dict, launches: int, what: str) -> dict:
    """Every launch of `fn` since `before` took the bitset route."""
    taken = _routes_since(before, fn)
    check(taken == {"bitset": launches, "generic": 0},
          f"{what}: routes {taken} for {launches} launches")
    return taken


PLAIN_WORKERS = 4      # host processes computing kernel_vs_plain's plain results


def kernel_vs_plain_cases() -> list:
    """Seeded random small grids and cells as numpy int32 inputs:
    [(name, args, kw, what)], one grid and three cells (unseeded, seeded,
    materialise) per alphabet and window."""
    from repro_torch.core import simulator
    rng = np.random.default_rng(2024)
    a = lambda x: np.asarray(x, np.int32)
    p, trace_len, steps = CHECK_PROGS, CHECK_TRACE_LEN, CHECK_STEPS
    sched = a(simulator.priority_schedule((2, 1, 3), p))     # weighted
    cases = []
    for num_tags in CHECK_TAGS:
        for window in WINDOWS:
            ptags = a(rng.integers(-1, num_tags, (3, p, trace_len)))
            pcosts = a(rng.integers(0, 9, (3, p, trace_len)))
            quanta = a([[QUANTUM_MENU[i] for i in rng.integers(0, 4, p)]
                        for _ in range(3)])
            args = (ptags, pcosts, a([1, 4, 8]), a([0, 73]), quanta, sched,
                    11, 23)
            kw = dict(num_tags=num_tags, total_steps=steps, window=window)
            cases.append(("window_grid", args, kw,
                          f"window_grid T={num_tags} W={window}"))
            for mode in ("unseeded", "seeded", "materialise"):
                seed = None
                if mode == "seeded":
                    seed = (a(rng.permutation(num_tags) - 1),
                            a(rng.integers(0, 3 * trace_len, p)),
                            a(rng.integers(0, sched.shape[0])),
                            a(rng.integers(0, 6)),
                            a(rng.integers(0, 9_000, p)),
                            a(rng.integers(0, 900, p)),
                            a(rng.integers(0, 900, p)),
                            a(rng.integers(0, 90, p)),
                            a(rng.integers(0, 40)))
                cargs = (ptags[0], pcosts[0], 3, 41, quanta[0], sched, 9, 17,
                         seed)
                cases.append(("window_cell", cargs,
                              dict(kw, materialise=mode != "unseeded"),
                              f"window_cell {mode} T={num_tags} W={window}"))
    return cases


def _tensors(x, dev):
    """numpy arrays, also inside tuples, as tensors on `dev`."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=dev)
    if isinstance(x, tuple):
        return tuple(_tensors(y, dev) for y in x)
    return x


def plain_on_host(name: str, args: tuple, kw: dict) -> tuple:
    """A window wrapper's plain version on the host, in a worker process:
    numpy inputs in; the fields as numpy and the seconds it took out."""
    t0 = time.perf_counter()
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    from repro_torch.kernels import window_distance as wd
    out = getattr(wd, f"{name}_plain")(*_tensors(args, "cpu"), **kw)
    return [o.numpy() for o in out], time.perf_counter() - t0


def start_plain(pool, cases: list) -> list:
    """`plain_on_host` for every case, submitted to `pool` (host processes
    that work while the card runs the other phases)."""
    return [pool.submit(plain_on_host, name, args, kw)
            for name, args, kw, _ in cases]


def phase_kernel_vs_plain(dev, errs: dict, cases: list, plain: list) -> None:
    """The kernel on `kernel_vs_plain_cases`' inputs, on the card, against
    its plain version on the same inputs (computed on the host by
    `start_plain`: on the card its small launches took 134-197 s, PERF.md
    §7), every field equal bit for bit, on the route each alphabet takes
    (bitset up to 32 tags, generic at 33)."""
    from repro_torch.kernels import window_distance as wd
    before = {fn.__name__: dict(fn.routes)
              for fn in (wd.window_grid, wd.window_cell)}
    t0 = time.perf_counter()
    host_s = waited_s = 0.0
    for (name, args, kw, what), fut in zip(cases, plain):
        got = [g.cpu() for g in getattr(wd, name)(*_tensors(args, dev),
                                                    **kw)]
        t1 = time.perf_counter()
        fields, secs = fut.result()
        waited_s += time.perf_counter() - t1
        host_s += secs
        want = [torch.from_numpy(w) for w in fields]
        errs[name] = max(errs[name], max_err(got, want))
        assert_same(got, want, what)
    routes = {fn.__name__: _routes_since(before[fn.__name__], fn)
              for fn in (wd.window_grid, wd.window_cell)}
    # one grid and three cells (unseeded, seeded, materialise) a case
    per_case = {"window_grid": 1, "window_cell": 3}
    for name, taken in routes.items():
        want = {r: per_case[name] * len(WINDOWS) *
                sum(wd.route(x, CHECK_PROGS) == r for x in CHECK_TAGS)
                for r in wd.ROUTES}
        check(taken == want, f"kernel_vs_plain {name} routes {taken}, "
                             f"expected {want}")
    emit("kernel_vs_plain", cases=len(cases), windows=list(WINDOWS),
         num_tags=list(CHECK_TAGS), routes=routes, match=True,
         seconds=round(time.perf_counter() - t0, 3),
         plain_host_s=round(host_s, 3), plain_workers=PLAIN_WORKERS,
         waited_for_plain_s=round(waited_s, 3))


# The host functions of the simulator slice whose wall time the fig7 and
# serving phases split out: trace build, stream gather, int32 tensors made
# on the card (the traces' copy among them), the state translation.
HOST_SPANS = {
    "trace_build": ("repro_torch.core.scheduler", "fleet_traces"),
    "stream_gather": ("repro_torch.core.stackdist_interleaved",
                      "_gather_streams"),
    "to_card": ("repro_torch.core.simulator", "_i32"),
    "seed_carry": ("repro_torch.core.simulator", "_seed_carry"),
    "state_from_final": ("repro_torch.core.simulator", "_state_from_final"),
}


@contextlib.contextmanager
def host_split(spans: dict = HOST_SPANS):
    """Time each function of `spans` (default `HOST_SPANS`) while the
    block runs, patched in its module: {span: {"s", "calls"}}, plus
    "total_s" of the block.  A call runs between two synchronisations, so
    the card's work it launched counts in it; a call made inside another
    timed call of the same `spans` counts in the outer one only (nest two
    of these to split an outer span)."""
    import importlib
    split, patched, depth = {}, [], [0]
    for name, (mod_name, attr) in spans.items():
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)
        span = split[name] = {"s": 0.0, "calls": 0}

        def timed(*a, _real=real, _span=span, **kw):
            if depth[0]:
                return _real(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = _real(*a, **kw)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            _span["s"] += time.perf_counter() - t0
            _span["calls"] += 1
            return out

        setattr(mod, attr, timed)
        patched.append((mod, attr, real))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield split
        torch.cuda.synchronize()
        split["total_s"] = time.perf_counter() - t0
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)


def phase_fig7(dev, errs: dict) -> dict:
    """The fig7 grid through `fig7_multi.sweep` (one `window_grid`
    launch), its wall time split by `host_split`; returns the split."""
    from repro_torch import bench
    from repro_torch.bench import fig7_multi
    from repro_torch.core import scheduler
    from repro_torch.kernels import window_distance as wd
    pairs = scheduler.make_pairs()
    before = wd.window_grid.launches
    routes = dict(wd.window_grid.routes)
    with engine_calls("_sweep_fleet_interleaved") as fleets:
        with host_split() as split:
            res = fig7_multi.sweep(pairs, device=dev)
        secs = split["total_s"]
    check(fleets == [len(pairs)], f"fig7 interleaved calls {fleets}")
    check(wd.window_grid.launches > before, "fig7 launched no window_grid")
    taken = _check_routes(wd.window_grid, routes,
                          wd.window_grid.launches - before, "fig7")
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
         window_grid_launches=wd.window_grid.launches - before,
         routes=taken)
    return split


def phase_fleet_sweep(dev, errs: dict) -> None:
    from repro_torch import bench
    from repro_torch.bench import fig7_multi
    from repro_torch.kernels import window_distance as wd
    before = wd.window_grid.launches
    routes = dict(wd.window_grid.routes)
    with engine_calls("_sweep_fleet_interleaved") as fleets:
        t0 = time.perf_counter()
        res = fig7_multi.sweep_fleets(device=dev)
        rows, agg = fig7_multi.run_fleets(device=dev, res=res)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(fleets == [24], f"fleet sweep interleaved calls {fleets}")
    check(wd.window_grid.launches > before, "fleet sweep launched nothing")
    taken = _check_routes(wd.window_grid, routes,
                          wd.window_grid.launches - before, "fleet sweep")
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
         window_grid_launches=wd.window_grid.launches - before,
         routes=taken)


SERVE_EPOCHS, SERVE_EPOCH_STEPS = 20, 6_000


def serve_setup():
    from repro_torch.bench import fig7_multi
    from repro_torch.core import isa, scheduler, simulator
    fleet = scheduler.make_fleets(4)[0]
    traces = scheduler.fleet_traces([fleet], fig7_multi.TRACE_LEN)[0]
    cfg = simulator.ReconfigConfig(num_slots=4, miss_latency=50)
    sched = simulator.SchedulerConfig(quantum_cycles=2_000)
    return fleet, traces, cfg, isa.SCENARIO_2, sched


def phase_serve(dev, errs: dict) -> dict:
    """A P=4 fleet served in epochs: each epoch resumes the carried
    `FleetState` (`OnlineConfig.epoch_steps` style), which rides the
    seeded/materialising window kernel.  The set-up and the epochs run
    under `host_split`; returns the split."""
    from repro_torch.core import simulator
    from repro_torch.kernels import window_distance as wd

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
    routes = dict(wd.window_cell.routes)
    with host_split() as split:
        fleet, traces, cfg, scen, sched = serve_setup()
        torch.cuda.synchronize()
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
    launches = wd.window_cell.launches - before
    taken = _check_routes(wd.window_cell, routes, launches, "serve")
    emit("serve", fleet="+".join(fleet), epochs=SERVE_EPOCHS,
         epoch_steps=SERVE_EPOCH_STEPS, seconds=round(secs, 3),
         cpi=[round(float(x), 4) for x in res.cpi.cpu()],
         switches=int(res.switches), matches_one_shot=True,
         matches_plain=True, scan_segment_steps=seg,
         window_cell_launches=launches, routes=taken)
    return split


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


def kernel_bound(work: dict, int32_rate: float | None = None
                 ) -> tuple[float, str]:
    """Least time in ms of a kernel's count (its module's `cost`, the one
    the cost counter charges), and what bounds it: its operations at the
    card's peak rate for their class (bf16 tensor cores, f32 CUDA cores,
    `int32_rate` or the data sheet's int32 issue rate), or its bytes at
    the HBM rate, whichever is longer."""
    from repro_torch.analysis import cost
    rates = {"bf16": BF16_FLOPS_PER_S, "f32": F32_FLOPS_PER_S,
             "int": int32_rate or cost.H100_PEAK["int"]}
    t_ops = sum(n / rates[cls] for cls, n in work["flops"].items())
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _window_inputs(dev) -> dict:
    """The window kernel's operands on the main path: {row: (entry point
    name, args, kwargs, num_tags, cells)} for the fig7 grid (50 pairs
    padded to 52, 2 quanta x 3 slot counts), the P=4 fleet grid (24
    fleets x 3 latencies at 4 slots) and one serving epoch (a seeded,
    materialising cell of the P=4 fleet, five epochs in)."""
    from repro_torch.bench import fig7_multi
    from repro_torch.core import isa, scheduler, simulator
    from repro_torch.core import stackdist_interleaved as sdi
    out = {}
    pairs = scheduler.make_pairs()
    fl = torch.as_tensor(scheduler.fleet_traces(
        pairs + pairs[:1] * 2, fig7_multi.TRACE_LEN), device=dev)
    table = simulator.fleet_tag_table(isa.SCENARIO_2, 2)
    ptags, pcosts = sdi._gather_streams(fl, table, isa.INSTR_HW_CYCLES)
    quanta = torch.tensor([[q, q] for q in fig7_multi.QUANTA],
                          dtype=torch.int32, device=dev)
    sched = simulator.SchedulerConfig()
    args = (ptags, pcosts, list(fig7_multi.SLOT_COUNTS),
            [fig7_multi.MISS_LATENCY], quanta,
            torch.as_tensor(sched.schedule(2), device=dev),
            sched.handler_cycles, 100)
    kw = dict(num_tags=int(table.max()) + 1,
              total_steps=fig7_multi.TOTAL_STEPS,
              window=simulator._interleaved_window(
                  quanta.cpu().numpy(), fig7_multi.TOTAL_STEPS, None, dev))
    out["fig7"] = ("window_grid", args, kw,
                   quanta.shape[0] * fl.shape[0] * 3)

    fleets = fig7_multi._fleets(fig7_multi.FLEET_K, 24)
    fl = torch.as_tensor(scheduler.fleet_traces(
        fleets, fig7_multi.TRACE_LEN), device=dev)
    table = simulator.fleet_tag_table(isa.SCENARIO_2, fig7_multi.FLEET_K)
    ptags, pcosts = sdi._gather_streams(fl, table, isa.INSTR_HW_CYCLES)
    sched = simulator.SchedulerConfig(quantum_cycles=20_000)
    quanta = torch.as_tensor(sched.quanta(fig7_multi.FLEET_K)[None, :],
                             device=dev)
    args = (ptags, pcosts, [4], list(fig7_multi.FLEET_LATENCIES), quanta,
            torch.as_tensor(sched.schedule(fig7_multi.FLEET_K), device=dev),
            sched.handler_cycles, 100)
    kw = dict(num_tags=int(table.max()) + 1,
              total_steps=fig7_multi.FLEET_TOTAL_STEPS,
              window=simulator._interleaved_window(
                  quanta.cpu().numpy(), fig7_multi.FLEET_TOTAL_STEPS, None,
                  dev))
    out["fleet"] = ("window_grid", args, kw,
                    fl.shape[0] * len(fig7_multi.FLEET_LATENCIES))

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
    out["serve"] = ("window_cell", cargs, ckw, 1)
    return out


# CUDA-event and profiler repetitions of each timed window row
WINDOW_REPS = {"fig7": (5, 5), "fleet": (5, 5), "serve": (50, 20)}


def _time_window(wd, row: str, inputs: dict) -> dict:
    """Event and profiler times of one window row through `wd`'s entry
    point (the port's, or the parent tree's)."""
    name, args, kw, _ = inputs[row]
    fn = getattr(wd, name)
    reps, dev_reps = WINDOW_REPS[row]
    ms = cuda_ms(lambda: fn(*args, **kw), reps)
    dms, kept = device_ms(lambda: fn(*args, **kw), dev_reps)
    return dict(ms=ms, device_ms=dms, profiler_records_kept=kept)


def load_parent_window(parent: str):
    """The window wrapper of another checkout (the parent commit, for
    timing beside this one): its `kernels/window_distance.py` loaded
    under its own name; it builds its own `csrc/window_distance.cu`."""
    import importlib.util
    path = os.path.join(os.path.abspath(parent), "src", "repro_torch",
                        "kernels", "window_distance.py")
    spec = importlib.util.spec_from_file_location("parent_window_distance",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_timing(dev, errs: dict, splits: dict, parent=None) -> dict:
    """Kernel and plain times at the main path's shapes: `window_grid` at
    the fig7 grid and at the P=4 fleet grid, `window_cell` at one serving
    epoch.  Each row: CUDA-event ms (the wrapper's host work included),
    profiler device ms, the plain version's ms, the throughput bound, the
    route, and the slowest cell's window trips and passes with the device
    ns a pass; with `parent` (a checkout), the parent wrapper's event and
    device ms on the same inputs, held equal first.  Then the host split
    of the fig7 and serving phases (`splits`), with the kernel's device
    time (launches x the device ms of its row) and the rest."""
    from repro_torch.kernels import window_distance as wd
    out = {}
    int32_rate, rate_src = int32_ops_per_s()
    emit("int32_rate", ops_per_s=int32_rate, source=rate_src,
         hbm_bytes_per_s=HBM_BYTES_PER_S)
    inputs = _window_inputs(dev)
    for row, (name, args, kw, cells) in inputs.items():
        fn, plain = getattr(wd, name), getattr(wd, f"{name}_plain")
        key = name if row != "fleet" else "window_grid_fleet"
        stats = []
        before = dict(fn.routes)
        got = fn(*args, **kw, stats=stats)
        taken = _routes_since(before, fn)
        check(taken == {"bitset": 1, "generic": 0},
              f"{row} timing inputs took {taken}")
        want = plain(*args, **kw)
        errs[name] = max(errs[name], max_err(got, want))
        assert_same(got, want, f"{row} timing inputs")
        trips, passes = max(stats, key=lambda tp: tp[1])
        check(len(stats) == cells and passes > 0, f"{row} stats {stats}")
        times = _time_window(wd, row, inputs)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 1 if row != "serve"
                           else 3)
        num_tags, steps = kw["num_tags"], kw["total_steps"]
        ptags = args[0]
        bound, by = kernel_bound(wd.cost(
            ptags.numel(), cells, steps, num_tags, ptags.shape[-2],
            cell=name == "window_cell"), int32_rate)
        out[key] = dict(**times, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, route="bitset", cells=cells,
                        window=kw["window"], steps=steps,
                        slowest_cell_trips=trips,
                        slowest_cell_passes=passes,
                        ns_per_pass=(None if times["device_ms"] is None
                                     else times["device_ms"] * 1e6 / passes),
                        shape={"fig7": "fig7", "fleet": "P=4 fleet",
                               "serve": "serving epoch"}[row])
        if parent is not None:
            assert_same(getattr(parent, name)(*args, **kw), want,
                        f"{row}: the parent kernel")
            out[key]["parent"] = _time_window(parent, row, inputs)
        emit(f"time_{key}", **out[key])

    # where the wall time of the fig7 sweep and of the serving epochs goes
    launches = {"fig7": ("window_grid", 1),
                "serve": ("window_cell", SERVE_EPOCHS)}
    for phase, split in splits.items():
        name, n = launches[phase]
        dms = out[name]["device_ms"]
        kernel_s = None if dms is None else n * dms / 1e3
        spans = {k: v for k, v in split.items() if k != "total_s"}
        rest = split["total_s"] - sum(v["s"] for v in spans.values()) - (
            kernel_s or 0.0)
        emit(f"host_split_{phase}", total_s=split["total_s"], **spans,
             kernel_device_s=kernel_s, kernel_launches=n, rest_s=rest)
    return out


# ---------------------------------------------------------------------------
# the sched slice: placement, admission, online re-placement, faults
# ---------------------------------------------------------------------------

# where the fleet loop's wall time goes: the outermost call of each span
# counts (a placement search's own sweeps count in the search) ...
SCHED_SPANS = {
    "placement_search": ("repro_torch.sched.online", "place_tenants"),
    "sweep_fleet": ("repro_torch.core.simulator", "sweep_fleet"),
    "resumed_epochs": ("repro_torch.core.simulator", "simulate_many"),
}
# ... and, inside the resumed epochs and probes, the state translation
# and the reference machine's segments
RESUME_SPANS = {
    "seed_carry": ("repro_torch.core.simulator", "_seed_carry"),
    "state_from_final": ("repro_torch.core.simulator", "_state_from_final"),
    "scan_segments": ("repro_torch.core.simulator", "_simulate_fleet_impl"),
}
# which engine each resumed segment took
SEGMENT_SPANS = {
    "interleaved_segments": ("repro_torch.core.simulator",
                             "_resume_fleet_interleaved"),
    "scan_segments": ("repro_torch.core.simulator", "_simulate_fleet_impl"),
}

# the engine's sched half (`sched_engine`): four tenants on the slot
# engine, a weighted admission plan over 2 cores, then a churn serve over
# 3 cores under a seeded fault storm (`tests/jax_sched_anchor.py` serves
# the same through the JAX package's engine)
ENGINE_BENCHES = {"fg": "minver", "t1": "nbody", "t2": "crc32",
                  "t3": "tarfind"}
ENGINE_PLAN = dict(slo=1.08, num_cores=2, slo_weights={"fg": 4.0})
ENGINE_PLACEMENT = dict(num_slots=4, miss_latency=50, quantum_cycles=2_000,
                        trace_len=2_000, steps_per_program=2_000)
ENGINE_ONLINE = dict(num_cores=3, epoch_steps=2_000, probe_steps=800)
ENGINE_EVENTS = [(0, "arrive", "fg", "minver"), (0, "arrive", "t1", "nbody"),
                 (1, "arrive", "t2", "crc32"), (1, "arrive", "t3", "tarfind"),
                 (2, "arrive", "t4", "cubic"), (4, "depart", "t2", None),
                 (4, "arrive", "t5", "qrduino")]
ENGINE_STORM = dict(seed=5, num_epochs=8, num_cores=3, p_core_loss=0.15,
                    p_seu=0.2, p_flush=0.15, p_stall=0.15)
ENGINE_EPOCHS = 8


def search_rows_held(rows) -> list:
    """placement_search's rows without their seconds: the two seconds
    rows dropped, the finding's seconds cut out."""
    return [re.sub(r"search [0-9.]+s ", "search ", r) for r in rows
            if not r.startswith(("cold_search_s,", "search_s,"))]


def fleet_rows_held(rows) -> list:
    """fleet_scale_study's rows without their seconds: the
    steady_resolve_s column dropped, and the finding line, whose numbers
    are all seconds and their ratios."""
    out = []
    for row in rows:
        if not row.startswith("#"):
            fields = row.split(",")
            out.append(",".join(fields[:5] + fields[6:]))
    return out


def report_json(value) -> str:
    """A report, decision or plain dict as canonical JSON (tuples as
    lists): the form both packages' results are digested in."""
    if dataclasses.is_dataclass(value):
        value = dataclasses.asdict(value)
    return json.dumps(value, sort_keys=True)


def fleet_reports_held(out: dict) -> list:
    """Every report `fleet_scale_study.run` returns (each size, both
    modes); a report holds no seconds."""
    return [report_json(out[label][mode]) for label in out
            for mode in ("full", "incremental")]


def decision_held(decision) -> str:
    """An `AdmissionDecision` as JSON: admitted, deferred, the predicted
    worst slowdown and the placement's cores and slowdowns."""
    pl = decision.placement
    return report_json({
        "admitted": decision.admitted, "deferred": decision.deferred,
        "predicted_worst": decision.predicted_worst,
        "cores": None if pl is None else pl.cores,
        "tenant_slowdown": None if pl is None else pl.tenant_slowdown})


@contextlib.contextmanager
def window_launches(phase: str, out: dict):
    """Both window counters set to 0 just before the block and read just
    after, into `out[phase]`; the phase must have launched the kernel,
    every launch on the bitset route."""
    from repro_torch.kernels import window_distance as wd
    fns = (wd.window_grid, wd.window_cell)
    for fn in fns:
        fn.launches = 0
        fn.routes = dict.fromkeys(wd.ROUTES, 0)
    yield
    counts = {fn.__name__: fn.launches for fn in fns}
    routes = {fn.__name__: dict(fn.routes) for fn in fns}
    check(sum(counts.values()) > 0, f"{phase} launched no window kernel")
    for name, n in counts.items():
        check(routes[name] == {"bitset": n, "generic": 0},
              f"{phase}: {name} routes {routes[name]} for {n} launches")
    out[phase] = {"launches": counts, "routes": routes}


def _shape(x):
    """The shape class of a window wrapper's argument: a tensor's or an
    array's shape, a tuple's by element, an int or flag as it is."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return tuple(x.shape)
    if isinstance(x, (tuple, list)):
        return tuple(_shape(y) for y in x)
    return x


def _clone(x):
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x.clone() if isinstance(x, torch.Tensor) else x.copy()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(y) for y in x)
    return x


@contextlib.contextmanager
def window_shapes():
    """While the block runs, every call of the window wrappers counted by
    its shape class (wrapper, argument shapes, keywords, seeded or not),
    the first call of each class kept, its arguments and result cloned:
    {key: {"name", "calls", "args", "kw", "out"}}.  The launch counters
    keep counting through the stand-ins."""
    from repro_torch.kernels import window_distance as wd
    classes, patched = {}, []
    for name in ("window_grid", "window_cell"):
        real = getattr(wd, name)

        def kept(*a, _real=real, _name=name, **kw):
            out = _real(*a, **kw)
            key = (_name, _shape(a), tuple(sorted(
                (k, _shape(v)) for k, v in kw.items())))
            if key not in classes:
                classes[key] = {"name": _name, "calls": 0, "args": _clone(a),
                                "kw": dict(kw), "out": _clone(out)}
            classes[key]["calls"] += 1
            return out

        # the wrapper counts through its module's global name, which is
        # the stand-in meanwhile: its launches go back to the wrapper
        kept.launches, kept.routes = 0, real.routes
        setattr(wd, name, kept)
        patched.append((name, real, kept))
    try:
        yield classes
    finally:
        for name, real, kept in patched:
            real.launches += kept.launches
            setattr(wd, name, real)


def _width(cls: dict) -> tuple:
    """(P, B) of a kept call: (B, P, N) streams to the grid, (P, N) to a
    cell (B 1)."""
    shape = tuple(cls["args"][0].shape)
    return shape[1:2] + shape[:1] if len(shape) == 3 else (shape[0], 1)


def hold_shapes_to_plain(classes: dict, errs: dict) -> list:
    """The widest kept calls held against their plain versions on the
    same card tensors bit for bit: `window_cell`'s at each step count
    (epochs and probes) and `window_grid`'s, each with the most programs,
    then the most fleets: [{"name", "programs", "fleets", "steps"}]."""
    from repro_torch.kernels import window_distance as wd
    pick = {}
    for cls in classes.values():
        key = (cls["name"], cls["kw"]["total_steps"]
               if cls["name"] == "window_cell" else 0)
        if key not in pick or _width(cls) > _width(pick[key]):
            pick[key] = cls
    held = []
    for (name, _), cls in sorted(pick.items()):
        want = getattr(wd, f"{name}_plain")(*cls["args"], **cls["kw"])
        (p, b), steps = _width(cls), cls["kw"]["total_steps"]
        errs[name] = max(errs[name], max_err(cls["out"], want))
        assert_same(cls["out"], want, f"{name} at P={p}, B={b}, "
                                      f"{steps} steps")
        held.append({"name": name, "programs": p, "fleets": b,
                     "steps": steps})
    return held


SPIN_CYCLES = 40_000_000       # ~20 ms of `torch.cuda._sleep` on an H100


def queued_ms(call, reps: int = 3) -> float | None:
    """Device ms of one `call`, by CUDA events around `reps` calls queued
    behind a spin kernel: the card runs them back to back once it ends,
    so the wrappers' host work is hidden and their small device copies
    count.  None if the host took longer to queue them than the spin
    lasted, at the spin's length and at four times it."""
    call()
    torch.cuda.synchronize()
    for spin in (SPIN_CYCLES, 4 * SPIN_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        queued = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if queued < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
    return None


def shapes_device_s(classes: dict, dev) -> dict:
    """The window kernel's device seconds over a block, per wrapper: each
    shape class's calls times its kept call's `queued_ms`; None where a
    class was not measured.  The replays take the slot counts, latencies,
    quanta and schedule as int32 tensors on the card already: a wrapper
    given a Python int copies it to the card, which synchronises."""
    from repro_torch.kernels import window_distance as wd
    total = {"window_grid": 0.0, "window_cell": 0.0}
    for cls in classes.values():
        name = cls["name"]
        args = tuple(torch.as_tensor(x, dtype=torch.int32, device=dev)
                     if 2 <= i <= 5 else x
                     for i, x in enumerate(cls["args"]))
        ms = queued_ms(lambda: getattr(wd, name)(*args, **cls["kw"]))
        if ms is None or total[name] is None:
            total[name] = None
        else:
            total[name] += cls["calls"] * ms / 1e3
    return total


def idle_sync_us(reps: int = 2_000) -> float:
    """Host microseconds of one `torch.cuda.synchronize` on an idle card:
    the least each span of `host_split` adds twice a call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def phase_sched_placement(dev, launches: dict) -> None:
    """`placement_study` and `placement_search` at the JAX package's
    sizes: every candidate group priced through `window_grid`."""
    from repro_torch.bench import placement_search, placement_study
    with window_launches("sched_placement", launches):
        t0 = time.perf_counter()
        rows, _ = placement_study.run(dev)
        torch.cuda.synchronize()
        study_s = time.perf_counter() - t0
        search_rows, search = placement_search.run(dev)
    check(sha(rows) == EXPECTED_ROWS["placement_study"],
          "placement_study rows differ from JAX's")
    for anchor in ANCHORS["placement_study"]:
        check(anchor in rows[-1], f"placement_study anchor {anchor!r}")
    check(sha(search_rows_held(search_rows))
          == EXPECTED_ROWS["placement_search"],
          "placement_search rows differ from JAX's")
    check(ANCHORS["placement_search"] in search_rows[-1],
          f"placement_search: {search_rows[-1]}")
    emit("sched_placement", placement_study_s=study_s,
         finding=rows[-1][2:], search_s=search["search_s"],
         cold_search_s=search["cold_search_s"],
         sim_calls=search["sim_calls"],
         groups_simulated=search["groups_simulated"],
         worst_slowdown=search["worst_slowdown"], rows_match_jax=True,
         **launches["sched_placement"])


def phase_sched_online(dev, launches: dict) -> None:
    """`online_churn` and `chaos_serve` (its crash-restart parity
    included): every seedable epoch and probe resumed through
    `window_cell`, the faulted and degraded segments on the reference
    machine, counted and timed."""
    from repro_torch.bench import chaos_serve, online_churn
    with window_launches("sched_online", launches):
        with host_split(SEGMENT_SPANS) as churn_seg:
            churn_rows, _ = online_churn.run(dev)
        with host_split(SEGMENT_SPANS) as chaos_seg:
            chaos_rows, _ = chaos_serve.run(dev)
    check(sha(churn_rows) == EXPECTED_ROWS["online_churn"],
          "online_churn rows differ from JAX's")
    check(sha(chaos_rows) == EXPECTED_ROWS["chaos_serve"],
          "chaos_serve rows differ from JAX's")
    for anchor in ANCHORS["online_churn"]:
        check(anchor in churn_rows[-1], f"online_churn anchor {anchor!r}")
    for anchor in ANCHORS["chaos_serve"]:
        check(anchor in chaos_rows[-1], f"chaos_serve anchor {anchor!r}")
    check(churn_seg["scan_segments"]["calls"] == 0,
          "a fault-free serve took the reference machine")
    check(chaos_seg["scan_segments"]["calls"] > 0,
          "chaos_serve's faulted segments took no reference machine")
    emit("sched_online", online_churn_s=churn_seg["total_s"],
         chaos_serve_s=chaos_seg["total_s"],
         churn_segments={k: churn_seg[k] for k in SEGMENT_SPANS},
         chaos_segments={k: chaos_seg[k] for k in SEGMENT_SPANS},
         chaos_scan_share=(chaos_seg["scan_segments"]["s"]
                           / chaos_seg["total_s"]),
         churn_finding=churn_rows[-1][2:], chaos_finding=chaos_rows[-1][2:],
         crash_restart=chaos_rows[-2][2:], rows_match_jax=True,
         **launches["sched_online"])


def phase_sched_fleet_scale(dev, launches: dict, errs: dict) -> None:
    """The slice's main path: `fleet_scale_study` at its full sizes (256,
    512 and 1,000 tenants on 32, 64 and 128 cores, each served in both
    re-solve modes), its own parity and sublinearity asserts included;
    rows and reports held to JAX's on every field but the seconds; no
    resumed segment on the reference machine.  The window kernel is held
    to its plain version at the widest shapes the loop gave it, and the
    wall time split: placement search, `sweep_fleet`, resumed epochs with
    their state translation, the kernel's device time (each shape class's
    calls times its device ms), the rest; with the least the split's own
    synchronisations cost."""
    from repro_torch.bench import fleet_scale_study
    check(os.environ.get("REPRO_FLEET_SCALE", "") != "smoke",
          "REPRO_FLEET_SCALE=smoke would cut the fleet to 64 tenants")
    with window_launches("sched_fleet_scale", launches):
        with host_split(SCHED_SPANS) as split, \
                host_split(RESUME_SPANS) as inner, window_shapes() as shapes:
            rows, out = fleet_scale_study.run(dev)
    check(sha(fleet_rows_held(rows)) == EXPECTED_ROWS["fleet_scale_rows"],
          "fleet_scale_study rows differ from JAX's")
    check(sha(fleet_reports_held(out))
          == EXPECTED_ROWS["fleet_scale_reports"],
          "fleet_scale_study placements or move logs differ from JAX's")
    check(inner["scan_segments"]["calls"] == 0,
          "a fault-free fleet serve took the reference machine")
    t0 = time.perf_counter()
    held = hold_shapes_to_plain(shapes, errs)
    check_s = time.perf_counter() - t0
    kernel_s = shapes_device_s(shapes, dev)
    big = out[fleet_scale_study.FULL_SIZES[-1][0]]
    spans = {k: split[k] for k in SCHED_SPANS}
    syncs = 2 * sum(v["calls"] for sp in (split, inner)
                    for k, v in sp.items() if k != "total_s")
    sync_us = idle_sync_us()
    emit("sched_fleet_scale", sizes=[label for label, *_ in
                                     fleet_scale_study.FULL_SIZES],
         seconds=split["total_s"], finding=rows[-1][2:],
         steady_resolve_s={label: {"full": o["t_full"],
                                   "incremental": o["t_inc"]}
                           for label, o in out.items()},
         migrations_1000t=big["incremental"].migrations,
         full_equals_incremental=True, rows_match_jax=True,
         reports_match_jax=True, held_to_plain=held,
         plain_check_s=check_s, **launches["sched_fleet_scale"])
    known = sum(v["s"] for v in spans.values())
    emit("host_split_fleet_scale", total_s=split["total_s"], **spans,
         inside_resumed={k: inner[k] for k in RESUME_SPANS},
         window_kernel_device_s=kernel_s,
         shape_classes={name: sum(c["name"] == name
                                  for c in shapes.values())
                        for name in ("window_grid", "window_cell")},
         split_syncs=syncs, idle_sync_us=sync_us,
         split_sync_s_least=syncs * sync_us / 1e6,
         rest_s=split["total_s"] - known)


def phase_sched_engine(dev, launches: dict) -> None:
    """The serve engine's sched half: `plan_coresidency` then
    `apply_admission`, and `serve_online` under `FaultPlan.storm`, each
    result held to the JAX engine's; then `perf_slot_decode`'s fleet
    rows (its slot half serves 16-wide heads, below the card's attention
    kernels: the CPU test holds it), held to JAX's text."""
    from repro_torch.bench import perf_slot_decode
    from repro_torch.models import transformer
    from repro_torch.sched import (FaultPlan, OnlineConfig,
                                   PlacementConfig, TenantEvent)
    from repro_torch.serve.engine import (EngineConfig, SlotServeEngine,
                                          Tenant)
    _, cfg = perf_slot_decode.config()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = np.zeros((1, 4), np.int32)
    eng = SlotServeEngine(cfg, params, EngineConfig(slots_per_shard=4),
                          [Tenant(n, tokens) for n in ENGINE_BENCHES],
                          max_len=8, device=dev)
    storm = FaultPlan.storm(**ENGINE_STORM)
    with window_launches("sched_engine", launches):
        t0 = time.perf_counter()
        decision = eng.plan_coresidency(ENGINE_BENCHES, **ENGINE_PLAN)
        kept = [t.name for t in eng.apply_admission(decision, 0)]
        with host_split(SEGMENT_SPANS) as seg:
            rep = eng.serve_online(
                [TenantEvent(*e) for e in ENGINE_EVENTS],
                online_cfg=OnlineConfig(
                    placement=PlacementConfig(**ENGINE_PLACEMENT),
                    **ENGINE_ONLINE),
                faults=storm, num_epochs=ENGINE_EPOCHS)
        engine_s = time.perf_counter() - t0
        fleet = perf_slot_decode.fleet_rows(dev)
        torch.cuda.synchronize()
        fleet_rows_s = time.perf_counter() - t0 - engine_s
    check(sha([decision_held(decision)]) == EXPECTED_ROWS["engine_plan"],
          f"plan_coresidency differs from JAX's: {decision}")
    check(sha([report_json(rep)]) == EXPECTED_ROWS["engine_online"],
          "serve_online's report differs from JAX's")
    check(seg["scan_segments"]["calls"] > 0,
          "the storm sent no segment to the reference machine")
    check(sha(fleet) == EXPECTED_ROWS["perf_slot_decode_fleet"],
          "perf_slot_decode's fleet rows differ from JAX's")
    emit("sched_engine", admitted=decision.admitted,
         deferred=decision.deferred, kept_on_core0=kept,
         engine_deferred=[t.name for t in eng.deferred],
         storm_events=len(storm.events), evacuations=rep.evacuations,
         worst_lifetime_slowdown=rep.worst_lifetime_slowdown,
         segments={k: seg[k] for k in SEGMENT_SPANS}, seconds=engine_s,
         perf_slot_decode_fleet_s=fleet_rows_s,
         plan_matches_jax=True, report_matches_jax=True,
         fleet_rows_match_jax=True, **launches["sched_engine"])


# ---------------------------------------------------------------------------
# the workloads slice: the zoo's mixes, model_serve_study, perf_sweep
# ---------------------------------------------------------------------------

def mix_table_on_host() -> dict:
    """The zoo's 20-cell mix table from the port's counter
    (`repro_torch.workloads.opcounts`, the smoke models on the CPU), in a
    host worker process while the card runs the other phases: each cell's
    `OpCount` as a dict and the seconds its count took."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    from repro_torch import workloads
    from repro_torch.workloads import opcounts
    out = {}
    for name in workloads.list_workloads():
        t0 = time.perf_counter()
        oc = opcounts.model_opcount(*name.rsplit(":", 1))
        out[name] = {"opcount": oc.to_dict(),
                     "s": time.perf_counter() - t0}
    return out


def phase_workloads_mix(mix) -> None:
    """The host's mix table into this process's counter cache (so the
    study below lowers the same counts), each cell's fractions, hottest F
    groups and counting seconds printed, the phase asymmetry checked."""
    from repro_torch.core import isa
    from repro_torch.workloads import lowering, opcounts
    t0 = time.perf_counter()
    table = mix.result()
    waited_s = time.perf_counter() - t0
    cells = {}
    for name, row in table.items():
        arch, phase = name.rsplit(":", 1)
        oc = opcounts.OpCount.from_dict(row["opcount"])
        opcounts._CACHE[(arch, phase)] = oc
        spec = lowering.spec_from_opcount(arch, phase, oc)
        check(abs(sum(spec.frac) - 1.0) < 1e-9, f"{name} fractions")
        cells[name] = {"frac": {g: round(x, 6) for g, x in
                                zip(isa.GROUP_NAMES, spec.frac) if x > 0},
                       "hot_f_groups": list(spec.hot_f_groups),
                       "s": round(row["s"], 3)}
    for arch in {n.rsplit(":", 1)[0] for n in table}:
        pre = cells[f"{arch}:prefill"]["frac"]
        dec = cells[f"{arch}:decode"]["frac"]
        check(pre["fma"] > dec["fma"] and dec["base"] > pre["base"],
              f"{arch}: no prefill/decode asymmetry ({pre}, {dec})")
    emit("workloads_mix", cells=cells, count=len(cells),
         counter_s=round(sum(r["s"] for r in table.values()), 3),
         waited_s=round(waited_s, 3), where="host process, plain kernels")


def phase_model_serve_study(dev, launches: dict) -> None:
    """`model_serve_study` on the card over the port's mixes: every
    candidate group priced through `window_grid`, the reference machine
    never dispatched, placed <= random mean at P=2 and P=3 (its own
    asserts), the rows held to the port's CPU digest."""
    from repro_torch.bench import model_serve_study
    with window_launches("model_serve_study", launches):
        t0 = time.perf_counter()
        rows, out = model_serve_study.run(dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check(out["scan_dispatches"] == 0, "the study took the reference "
                                       "machine")
    check(sha(rows) == EXPECTED_ROWS["model_serve_study_torch"],
          "model_serve_study rows differ from the port's CPU rows")
    anchors = {f"P{p}": {k: out[p][k] for k in (
        "placed_worst", "placed_mean", "random_worst_mean",
        "random_worst_best", "fifo_worst")} for p in (2, 3)}
    for p, a in anchors.items():
        check(a["placed_worst"] <= a["random_worst_mean"] + 1e-9,
              f"{p}: placed {a} above random")
    emit("model_serve_study", seconds=round(secs, 3), anchors=anchors,
         scan_dispatches=out["scan_dispatches"], finding=rows[-1][2:],
         trace_crc=[r[len("# trace_crc,"):] for r in rows
                    if r.startswith("# trace_crc")],
         rows_match_cpu=True, **launches["model_serve_study"])


def phase_perf_sweep(dev, launches: dict) -> None:
    """`perf_sweep`'s five engine sections on the card, parity asserted in
    each before timing (the reference-machine arms run once, as their
    parity run; the fast arms best of `REPS`), then its `window_kernel`
    section: the kernel against the plain window pass.  Sections 1-5
    count as this path's window launches; the `window_kernel` section's
    compare the kernel with its plain version and are printed apart."""
    from repro_torch.bench import perf_sweep
    sections, seconds = {}, {}
    with window_launches("perf_sweep", launches):
        for name, fn in perf_sweep.SECTIONS.items():
            if name == "window_kernel":
                continue
            t0 = time.perf_counter()
            sections[name] = fn(dev)
            seconds[name] = round(time.perf_counter() - t0, 3)
    for name, r in sections.items():
        for e in (r.values() if name == "preempted_grid" else [r]):
            check(e["parity"] is True, f"perf_sweep {name} parity")
    emit("perf_sweep", sections=sections, section_seconds=seconds,
         seconds=round(sum(seconds.values()), 3), parity=True,
         **launches["perf_sweep"])
    compare = {}
    with window_launches("window_kernel", compare):
        t0 = time.perf_counter()
        r = perf_sweep.SECTIONS["window_kernel"](dev)
        secs = time.perf_counter() - t0
    check(r["kernel_mode"] == "cuda", f"window_kernel ran {r['kernel_mode']}")
    check(r["routes"] == compare["window_kernel"]["routes"],
          f"window_kernel routes {r['routes']}")
    emit("window_kernel", seconds=round(secs, 3), parity=True, **r,
         launches=compare["window_kernel"]["launches"],
         counted_in_kernels_line=False)


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
    (1, 257, 8, 2, 64, 100), (2, 129, 4, 4, 128, 64),
    (1, 1000, 56, 8, 128, 0), (1, 333, 40, 8, 128, 0))  # G 7 arctic, 5 llama4
DECODE_CASES = (  # (B, S, H, KH, D)
    (4, 2048, 32, 8, 64), (4, 300, 8, 8, 64), (4, 256, 8, 1, 128),
    (4, 128, 16, 4, 128), (4, 2048, 56, 8, 128), (4, 777, 40, 8, 128))
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
                                           worst.items()}, match=True,
         decode_smem_bytes={f"G={g} D=128 {n}": da.smem_bytes(g, 128, t)
                            for g in (4, 5, 7) for n, t in (
                                ("f32", torch.float32),
                                ("bf16", torch.bfloat16))})


# (name, flash (T, H, KH, D, window), decode (B, S, H, KH, D)): the
# model path's shapes of granite, arctic and recurrentgemma
ACCURACY_CASES = (
    ("granite", (1024, 32, 8, 64, 0), (8, 2048, 32, 8, 64)),
    ("arctic", (300, 56, 8, 128, 0), (1, 308, 56, 8, 128)),
    ("recurrentgemma", (1024, 16, 1, 256, 2048), (8, 2048, 16, 1, 256)))
# a bf16 kernel's relative L2 error may exceed the floor that rounding
# the exact result to bf16 sets by this factor (P rounded to bf16 alone,
# without its lo part, reads above it)
ACCURACY_FLOOR_FACTOR = 1.1


def _attention_f64(q, k, v, valid):
    """softmax(q k^T dh^-0.5, where `valid` (..., Tq, Tk)) v in float64,
    q (B, Tq, H, D) over k/v (B, Tk, KH, D)."""
    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    kd = k.double().repeat_interleave(h // kh, 2)
    vd = v.double().repeat_interleave(h // kh, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) * d ** -0.5
    sc = sc.masked_fill(~valid, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vd)


def phase_attention_accuracy(dev) -> dict:
    """Relative L2 error of both bf16 kernels against a float64 reference
    at the model path's shapes, beside the floor that rounding the exact
    result to bf16 sets: the kernels split P into bf16 hi + lo parts for
    P V so that they sit at that floor (P in bf16 alone adds ~1e-3 and
    flips near-tied routes of arctic's MoE layers downstream)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(21)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = lambda a, b: float((a.double() - b).norm() / b.norm())
    out = {}
    for name, (t, h, kh, d, window), (b, s, dh, dkh, dd) in ACCURACY_CASES:
        q, k, v = r(1, t, h, d), r(1, t, kh, d), r(1, t, kh, d)
        pos = torch.arange(t, device=dev)
        valid = pos[None, :] <= pos[:, None]
        if window:
            valid &= pos[None, :] > pos[:, None] - window
        want = _attention_f64(q, k, v, valid)
        flash = dict(kernel=rel(fa.flash_attention(q, k, v, window=window),
                                want),
                     floor=rel(want.to(torch.bfloat16), want))
        q, kc, vc = r(b, dh, dd), r(b, s, dkh, dd), r(b, s, dkh, dd)
        kv_len = torch.as_tensor(np.random.default_rng(s).integers(
            1, s + 1, b).astype(np.int32), device=dev)
        valid = (torch.arange(s, device=dev)[None, :] < kv_len[:, None])[
            :, None, None, :]
        want = _attention_f64(q[:, None], kc, vc, valid)[:, 0]
        decode = dict(kernel=rel(da.decode_attention(q, kc, vc, kv_len),
                                 want),
                      floor=rel(want.to(torch.bfloat16), want))
        for kind, x in (("flash", flash), ("decode", decode)):
            check(x["kernel"] <= ACCURACY_FLOOR_FACTOR * x["floor"],
                  f"{kind} at {name}'s shape: relative L2 {x['kernel']} "
                  f"against float64, above {ACCURACY_FLOOR_FACTOR} x the "
                  f"bf16 rounding floor {x['floor']}")
        out[name] = {"flash": flash, "decode": decode}
    emit("attention_accuracy", dtype="bfloat16", rel_l2=out,
         floor_factor=ACCURACY_FLOOR_FACTOR)
    return out


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


def _hold_to_anchor(rows, ids, anchor: dict, what: str):
    """Logits rows (steps, V) against a JAX anchor: every compared logit
    within ANCHOR_TOL, and the argmax equal wherever JAX's top-2 gap
    exceeds 2 ANCHOR_TOL (else JAX's winner must still be a top logit).
    Returns (max abs error, argmax)."""
    got = torch.stack(rows).double().cpu().numpy()
    err = float(np.abs(got[:, ids] - np.asarray(anchor["logits"])).max())
    check(err <= ANCHOR_TOL, f"{what} logits differ from JAX's by {err}")
    argmax = got.argmax(1).tolist()
    for step, (a, w, gap) in enumerate(zip(argmax, anchor["argmax"],
                                           anchor["gap"])):
        if gap > 2 * ANCHOR_TOL:
            check(a == w, f"{what} step {step}: argmax {a}, JAX {w}")
        else:   # a near-tie in the JAX run: its winner must still tie
            check(got[step].max() - got[step, w] <= 2 * ANCHOR_TOL,
                  f"{what} step {step}: JAX's argmax {w} is not a top logit")
    return err, argmax


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
    err, argmax = _hold_to_anchor(rows, ids, JAX_ANCHOR, "anchor")
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


def _kernel_kind(name: str) -> str:
    name = name.lower()
    for needle, kind in (("flash_kernel", "flash_attention"),
                         ("decode_kernel", "decode_attention"),
                         ("moe_gmm_skip_kernel", "moe_gmm_skip"),
                         ("moe_gmm_kernel", "moe_gmm"),
                         ("rglru_kernel", "rglru_scan"),
                         ("rwkv6_kernel", "rwkv6_scan")):
        if needle in name:
            return kind
    if any(w in name for w in ("gemm", "xmma", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def _kernel_records(prof) -> dict:
    """Records the profiler kept of each of the port's kernels, by kind
    (the decode kernel's split and merge launches each count)."""
    out = {}
    for evt in cuda_rows(prof):
        kind = _kernel_kind(evt.key)
        if kind not in ("gemm", "other"):
            out[kind] = out.get(kind, 0) + evt.count
    return out


def _kernel_ms(prof) -> dict:
    """Device milliseconds of the kernels a torch.profiler run saw, summed
    by kind (the attention kernels, the two grouped-FFN entry points, the
    two recurrent scans, GEMMs, everything else).  Each kernel of the
    port names its kind in its symbol (`flash_kernel_wgmma`,
    `decode_kernel_merge`, ...), so it is matched before the library's
    GEMMs."""
    kinds = dict.fromkeys(("flash_attention", "decode_attention", "moe_gmm",
                           "moe_gmm_skip", "rglru_scan", "rwkv6_scan",
                           "gemm", "other"), 0.0)
    for evt in cuda_rows(prof):
        kinds[_kernel_kind(evt.key)] += _device_us(evt) / 1e3
    return kinds


def phase_serve_profile(dev) -> None:
    """Where a granite-3-2b serving step's time goes (`profile_serving`)."""
    from repro_torch.models import transformer
    cfg = _granite()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    profile_serving(dev, cfg, params, "serve_profile")
    del params


def profile_serving(dev, cfg, params, prefix: str) -> None:
    """Where a serving step's time goes, at the serving shapes: host wall
    time of an admission step (8 prompts prefilled, then one decode) and
    of 8 steady decode steps, without the profiler; then the same windows
    under `torch.profiler` for the device time of each kind of kernel.
    The device's idle share is 1 - device time / unprofiled wall time.
    One line each, `<prefix>_admission` and `<prefix>_decode`, with the
    records the profiler kept of each of the port's kernels beside the
    launches their wrappers counted in the same window (the profiler of a
    long-lived process can drop some: the device times are then short by
    that share)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    from repro_torch.launch import serve
    from repro_torch.serve.engine import model_batcher
    wrappers = {"flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention,
                "moe_gmm": gmm.moe_gmm, "moe_gmm_skip": gmm.moe_gmm_skip,
                "rglru_scan": rgs.rglru_scan, "rwkv6_scan": rws.rwkv6_scan}
    # kernels a wrapper call runs: decode's split and merge, the grouped
    # FFN's two stages; a scan's chunked route runs two (its parallel pass
    # and its pass over T), its step route one
    per_launch = {"decode_attention": 2, "moe_gmm": 2, "moe_gmm_skip": 2}
    scans = ("rglru_scan", "rwkv6_scan")

    def kernels_run(before, before_routes):
        out = {k: (w.launches - before[k]) * per_launch.get(k, 1)
               for k, w in wrappers.items() if k not in scans}
        for k in scans:
            d = {r: wrappers[k].routes[r] - before_routes[k][r]
                 for r in wrappers[k].routes}
            out[k] = 2 * d["chunked"] + d["step"]
        return out
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
            before = {k: w.launches for k, w in wrappers.items()}
            before_routes = {k: dict(wrappers[k].routes) for k in scans}
            with wrap() as ctx:
                t0 = time.perf_counter()
                for _ in range(n):
                    batcher.step()
                torch.cuda.synchronize()
                launched = kernels_run(before, before_routes)
                out[name] = (1e3 * (time.perf_counter() - t0) / n, ctx,
                             {k: v for k, v in launched.items() if v})
        return out

    plain = windows(model_batcher(cfg, params, SERVE["batch"],
                                  SERVE["max_len"], device=dev),
                    contextlib.nullcontext)
    traced = windows(model_batcher(cfg, params, SERVE["batch"],
                                   SERVE["max_len"], device=dev),
                     profiled)
    steps = {"admission": 1, "decode": 8}
    for name in ("admission", "decode"):
        wall_ms = plain[name][0]
        _, prof, launched = traced[name]
        kinds = {k: v / steps[name] for k, v in _kernel_ms(prof).items()}
        records = _kernel_records(prof)
        busy = sum(kinds.values())
        # a profiler that sees no device time measures nothing: say so
        # rather than report an idle share of 1
        emit(f"{prefix}_{name}", arch=cfg.name, layers=cfg.num_layers,
             batch=SERVE["batch"],
             prompt_tokens=prompt_tokens if name == "admission" else 0,
             wall_ms_per_step=wall_ms,
             traced_wall_ms_per_step=traced[name][0],
             device_ms_per_step=busy if busy > 0 else None,
             idle_share=1.0 - busy / wall_ms if busy > 0 else None,
             device_ms_by_kind=kinds if busy > 0 else None,
             kernel_records={k: [records.get(k, 0), n]
                             for k, n in launched.items()})


def _sdpa(q, k, v, **kw):
    """PyTorch's fused attention on (B, T, H, D) views: the yardstick
    (`library_ms`), never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def _time_flash(q, k, v, window: int, reps: int, plain: bool) -> dict:
    """Times of the flash kernel at one prompt: the CUDA-event mean of
    back-to-back wrapper calls (`ms`), its device time (`device_ms`),
    SDPA's device and event times on the same inputs (a band mask when
    the window is shorter than the prompt), the plain version's event
    time when `plain`, and the bound."""
    from repro_torch.kernels import flash_attention as fa
    _, t, h, d = q.shape
    kh = k.shape[2]
    if window and window < t:
        pos = torch.arange(t, device=q.device)
        band = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        lib = lambda: _sdpa(q, k, v, attn_mask=band)
    else:
        lib = lambda: _sdpa(q, k, v, is_causal=True)
    kernel = lambda: fa.flash_attention(q, k, v, window=window)
    work = fa.cost(1, t, t, h, kh, d, q.dtype, window=window)
    bound, by = kernel_bound(work)
    dev_ms, kept = device_ms(kernel, reps)
    lib_dev_ms, lib_kept = device_ms(lib, reps)
    return dict(
        ms=cuda_ms(kernel, reps), device_ms=dev_ms,
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, window=window), 3) if plain else None,
        library_ms=cuda_ms(lib, reps), library_device_ms=lib_dev_ms,
        bound_ms=bound, bound_by=by, flops=sum(work["flops"].values()),
        bytes=work["bytes"], profiler_records_kept=[kept, lib_kept])


def _time_decode(q, kc, vc, kv_len, reps: int) -> dict:
    """Times of the decode kernel over a stack of layers' caches, cycled
    (as a decode step meets them, beyond the L2): event and device time
    of the kernel (its split and merge launches) and of SDPA, the plain
    version's event time, and the bytes bound of this kv_len."""
    from repro_torch.kernels import decode_attention as da
    layers, b, s, kh, d = kc.shape
    h = q.shape[1]
    mask = (torch.arange(s, device=q.device)[None, :] < kv_len[:, None])[
        :, None, None, :]
    state = {"i": 0}

    def cycled(fn):
        def call():
            i = state["i"] = (state["i"] + 1) % layers
            fn(kc[i], vc[i])
        return call

    kernel = cycled(lambda kk, vv: da.decode_attention(q, kk, vv, kv_len))
    lib = cycled(lambda kk, vv: _sdpa(q[:, None], kk, vv, attn_mask=mask))
    work = da.cost(b, h, kh, d, int(kv_len.sum()), q.dtype)
    bound, by = kernel_bound(work)
    dev_ms, kept = device_ms(kernel, reps)
    lib_dev_ms, lib_kept = device_ms(lib, reps)
    return dict(
        ms=cuda_ms(kernel, reps), device_ms=dev_ms,
        plain_ms=cuda_ms(cycled(lambda kk, vv: da.decode_attention_plain(
            q, kk, vv, kv_len)), max(2, reps // 10)),
        library_ms=cuda_ms(lib, reps), library_device_ms=lib_dev_ms,
        bound_ms=bound, bound_by=by, splits=list(da.split_plan(b, kh, s)),
        flops=sum(work["flops"].values()), bytes=work["bytes"],
        profiler_records_kept=[kept, lib_kept])


FLASH_PROMPTS = (128, 512, 1024, 2048)   # granite's shape, prompt lengths


def phase_time_attention(dev, errs: dict) -> dict:
    """Kernel, plain and library times at the serving shapes: prefill of
    a 1024-token prompt (and of 128, 512 and 2,048 tokens: kernel, SDPA
    and bound only), and a decode step at batch 8 over a 2048-slot cache
    with ragged kv_len.  Decode cycles through 4 layers' caches (134 MB,
    beyond the 50 MB L2), as a decode step meets them.  Each time twice:
    CUDA events over back-to-back calls (`ms`, the host's wrapper call
    included) and the profiler's device time (`device_ms`)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    cfg = _granite()
    h, kh, d, dt = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
    out = {}

    prompts = {}
    for t in FLASH_PROMPTS:
        q, k, v = r(1, t, h, d), r(1, t, kh, d), r(1, t, kh, d)
        err = _attn_err(fa.flash_attention(q, k, v),
                        fa.flash_attention_plain(q, k, v), dt,
                        f"flash timing T={t}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        prompts[t] = _time_flash(q, k, v, 0, 20, plain=t == 1024)
    out["flash_attention"] = dict(
        prompts[1024],
        shape=f"prefill B=1 T=1024 H={h} KH={kh} D={d} bf16 causal",
        prompts={str(t): {k: v for k, v in x.items() if k != "plain_ms"}
                 for t, x in prompts.items()})
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
    out["decode_attention"] = dict(
        _time_decode(q, kc, vc, kv_len, 200),
        shape=f"decode B={b} S={s} H={h} KH={kh} D={d} bf16, "
              f"kv_len {kv_len.tolist()}")
    emit("time_decode_attention", **out["decode_attention"])
    return out


# ---------------------------------------------------------------------------
# the MoE slice: the grouped-FFN kernel, arctic-480b, expert slots
# ---------------------------------------------------------------------------

MOE_SOURCE = "src/repro_torch/kernels/csrc/moe_gmm.cu"
MOE_REPLACES = {"moe_gmm": "src/repro/kernels/moe_gmm.py:198",
                "moe_gmm_skip": "src/repro/kernels/moe_gmm.py:142"}
GMM_CASES = (  # (E, C, D, F, gated): test_kernels.py's, ragged, ungated
    (2, 128, 128, 256, True), (4, 128, 256, 512, True),
    (2, 128, 128, 128, False), (4, 64, 64, 128, True),
    (3, 24, 96, 80, True), (3, 24, 96, 80, False))
ARCTIC_2L = "arctic-480b-2l"
# the slice's main path: arctic at full width, 2 layers, through the
# launcher (continuous batching, then its expert-slot half)
MOE_SERVE = dict(num_requests=8, batch=8, max_len=2048, new_tokens=32,
                 prompt_len=(100, 1500), slots=4, hit_bias=0.0)
# expert-buffer rows at the path's shapes: a ~1,000-token prefill
# (capacity 24, every expert live) and a batch-8 decode step (capacity 8,
# top-2 of 8 tokens: at most 16 experts live)
PREFILL_C, DECODE_C, DECODE_LIVE = 24, 8, 16
# benchmarks/perf_slot_decode.py's setting
SLOT_STEPS, SLOT_SHARDS, SLOT_TENANTS = 96, 16, 4


def _arctic(**kw):
    from repro_torch.configs import base as cb
    cb.load_all()
    return dataclasses.replace(cb.get_config("arctic-480b"), **kw)


def register_arctic_2l():
    """arctic-480b at full width (all 128 experts) cut to 2 layers, in the
    port's registry under its own name, so the launcher serves it as it
    serves any arch."""
    from repro_torch.configs import base as cb
    return cb.register(_arctic(name=ARCTIC_2L, num_layers=2))


def _gmm_err(got, want, dtype, what: str) -> float:
    """Max |got - want|, after holding it to allclose at GMM_TOL."""
    tol = GMM_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol, msg=lambda m: f"{what}: {m}")
    return float((got.float() - want.float()).abs().max())


def _gmm_check(x, wg, wi, wo, counts, gated: bool, what: str) -> dict:
    """Both entry points against their plain versions on one input; the
    skip's empty experts must be exact zeros."""
    from repro_torch.kernels import moe_gmm as gmm
    dt = x.dtype
    errs = {"moe_gmm": _gmm_err(gmm.moe_gmm(x, wg, wi, wo, gated=gated),
                                gmm.moe_gmm_plain(x, wg, wi, wo,
                                                  gated=gated),
                                dt, f"moe_gmm {what}")}
    got = gmm.moe_gmm_skip(x, wg, wi, wo, counts, gated=gated)
    check(not got[counts <= 0].any(),
          f"moe_gmm_skip {what}: an empty expert is not zero")
    errs["moe_gmm_skip"] = _gmm_err(
        got, gmm.moe_gmm_skip_plain(x, wg, wi, wo, counts, gated=gated), dt,
        f"moe_gmm_skip {what}")
    return errs


def _decode_buffers(gen, e, c, d, live, dtype, dev):
    """Expert buffers of a decode step: `live` experts with 1..c rows
    each (the rest of their rows and every other expert zero)."""
    counts = torch.zeros(e, dtype=torch.int32, device=dev)
    which = torch.randperm(e, generator=gen, device=dev)[:live]
    counts[which] = torch.randint(1, c + 1, (live,), generator=gen,
                                  device=dev, dtype=torch.int32)
    rows = torch.arange(c, device=dev)[None, :] < counts[:, None]
    x = torch.randn((e, c, d), generator=gen, device=dev) * rows[..., None]
    return x.to(dtype), counts


def phase_moe_gmm_vs_plain(dev, errs: dict, layer0) -> None:
    """Both entry points against their plain versions: test_kernels.py's
    shapes, a ragged and an ungated case, f32 and bf16, with counts
    holding zeros; then the two path shapes at full width on the serving
    model's layer-0 experts (bf16): prefill (E 128, C 24, every expert
    live) and decode (E 128, C 8, 16 live)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        for e, c, d, f, gated in GMM_CASES:
            r = lambda *s: torch.randn(s, generator=gen, device=dev)
            x = (r(e, c, d) * 0.5).to(dtype)
            wg, wi = ((r(e, d, f) * d ** -0.5).to(dtype) for _ in range(2))
            wo = (r(e, f, d) * f ** -0.5).to(dtype)
            counts = torch.tensor([(i % 3) * 2 for i in range(e)],
                                  dtype=torch.int32, device=dev)
            for name, err in _gmm_check(
                    x, wg, wi, wo, counts, gated,
                    f"{key} E={e} C={c} D={d} F={f} gated={gated}").items():
                worst[(name, key)] = max(worst.get((name, key), 0.0), err)
    wg, wi, wo = layer0
    e, d, _ = wg.shape
    x = torch.randn((e, PREFILL_C, d), generator=gen, device=dev).to(
        wg.dtype)
    full = {"prefill": _gmm_check(
        x, wg, wi, wo, torch.full((e,), PREFILL_C, dtype=torch.int32,
                                  device=dev), True, "full-width prefill")}
    x, counts = _decode_buffers(gen, e, DECODE_C, d, DECODE_LIVE, wg.dtype,
                                dev)
    full["decode"] = _gmm_check(x, wg, wi, wo, counts, True,
                                "full-width decode")
    torch.cuda.synchronize()
    for (name, _), err in worst.items():
        errs[name] = max(errs[name], err)
    for shape in full.values():
        for name, err in shape.items():
            errs[name] = max(errs[name], err)
    f = wg.shape[-1]
    shapes = {"prefill": f"E={e} C={PREFILL_C} D={d} F={f} bf16, all live",
              "decode": f"E={e} C={DECODE_C} D={d} F={f} bf16, "
                        f"{DECODE_LIVE} live"}
    emit("moe_gmm_vs_plain", cases=len(GMM_CASES),
         dtypes=["float32", "bfloat16"], tolerance=GMM_TOL,
         max_abs_err={f"{n} {t}": v for (n, t), v in worst.items()},
         full_width={k: {"shape": shapes[k], "max_abs_err": v}
                     for k, v in full.items()},
         empty_experts_zero=True, match=True)


def phase_moe_jax_anchor(dev) -> None:
    """arctic-480b at full width, 1 layer and 8 experts, top-2, capacity
    factor 1.25, f32, weights from `numpy_params(cfg, 0)`: prefill 97
    tokens (moe_gmm) and decode 8 (moe_gmm_skip); logits at 32 ids, the
    argmax and every step's expert load against the JAX package's
    (MOE_JAX_ANCHOR)."""
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.models import convert, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _arctic(num_layers=1, num_experts=8, top_k=2, capacity_factor=1.25,
                  dtype="float32")
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), dev,
                                       torch.float32)
    tokens, ids = anchor_inputs(cfg.vocab)
    check(ids.tolist() == MOE_JAX_ANCHOR["ids"] and
          hashlib.sha1(tokens.tobytes()).hexdigest() ==
          MOE_JAX_ANCHOR["tokens_sha1"], "numpy drew other anchor inputs")
    g0, s0 = gmm.moe_gmm.launches, gmm.moe_gmm_skip.launches
    prompt = 97
    logits, cache, aux = transformer.prefill(cfg, params,
                                             {"tokens": tokens[:, :prompt]})
    cache = [[{n: torch.nn.functional.pad(c[n], (0, 0, 0, 0, 0, 8))
               for n in c} for c in seg] for seg in cache]
    rows, loads = [logits[0, -1]], [aux[0][0]["expert_load"][0]]
    for i in range(prompt, prompt + 8):
        logits, cache, aux = transformer.decode_step(
            cfg, params, {"tokens": tokens[:, i:i + 1],
                          "positions": np.full((1,), i, np.int32)}, cache)
        rows.append(logits[0, -1])
        loads.append(aux[0][0]["expert_load"][0])
    torch.cuda.synchronize()
    launched = (gmm.moe_gmm.launches - g0, gmm.moe_gmm_skip.launches - s0)
    check(launched == (1, 8), f"anchor launched {launched}, not (1, 8)")
    loads = torch.stack(loads).tolist()
    for step, (got_l, want_l) in enumerate(zip(loads,
                                               MOE_JAX_ANCHOR["expert_load"])):
        check(got_l == want_l,
              f"anchor step {step}: expert load {got_l}, JAX {want_l}")
    err, argmax = _hold_to_anchor(rows, ids, MOE_JAX_ANCHOR, "moe anchor")
    emit("moe_jax_anchor", arch="arctic-480b", layers=1,
         experts=cfg.num_experts, top_k=cfg.top_k,
         capacity_factor=cfg.capacity_factor, dtype="float32",
         prompt=prompt, decode_steps=8, compared_ids=len(ids),
         max_abs_err=err, tolerance=ANCHOR_TOL, argmax=argmax,
         argmax_match=sum(a == w for a, w in
                          zip(argmax, MOE_JAX_ANCHOR["argmax"])),
         expert_load_match=True, prefill_load=loads[0],
         prefill_dropped=prompt * cfg.top_k - sum(loads[0]),
         launches={"moe_gmm": launched[0], "moe_gmm_skip": launched[1]})
    del params, cache


def phase_moe_model_consistency(dev, cfg, params) -> None:
    """arctic-480b at full width, 2 layers, 128 experts, bf16, random
    weights: one prompt and 8 decode steps through the kernels against
    the plain path; logits within DEEP_BF16_REL, the share of routed
    expert ids the two paths agree on, and where they first differ (a
    further reading: the gate is the logits').  (No
    prefill-vs-full-sequence check here: at capacity 1.25 a prefill of T
    tokens and a decode step of B tokens have other capacities, so other
    drops.)"""
    from repro_torch.models import moe, transformer
    b, t0, steps = 1, 300, 8
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (b, t0 + steps)).astype(np.int32)
    out, routes, calls_by_mode = {}, {}, {}
    t_start = time.perf_counter()
    for mode in ("auto", "plain"):
        with spy_calls(moe, "route") as calls:
            logits, cache, _ = transformer.prefill(
                cfg, params, {"tokens": tokens[:, :t0]}, use_kernel=mode)
            cache = [[{n: torch.nn.functional.pad(c[n],
                                                  (0, 0, 0, 0, 0, steps))
                       for n in c} for c in seg] for seg in cache]
            rows = [logits]
            for i in range(t0, t0 + steps):
                logits, cache, _ = transformer.decode_step(
                    cfg, params, {"tokens": tokens[:, i:i + 1],
                                  "positions": np.full((b,), i, np.int32)},
                    cache, use_kernel=mode)
                rows.append(logits)
        out[mode] = torch.cat(rows, 1)
        calls_by_mode[mode] = [ids.sort(-1).values for ids, _ in calls]
        routes[mode] = torch.cat(calls_by_mode[mode])
        del cache
    torch.cuda.synchronize()
    rel = _rel(out["auto"], out["plain"])
    agree = float((routes["auto"] == routes["plain"]).float().mean())
    first = first_route_difference(calls_by_mode, sum(cfg.moe_layer_mask()))
    check(rel <= DEEP_BF16_REL, f"moe_model_consistency: relative L2 {rel} "
                                f"> {DEEP_BF16_REL} (routed ids agree "
                                f"{agree}; first differ at {first})")
    emit("moe_model_consistency", arch=cfg.name, layers=cfg.num_layers,
         experts=cfg.num_experts, dtype="bfloat16", batch=b, prefill=t0,
         decode_steps=steps, rel_l2_kernel_vs_plain=rel,
         tolerance=DEEP_BF16_REL, routed_ids_agree=agree,
         first_route_difference=first,
         argmax_agree=float((out["auto"].argmax(-1) ==
                             out["plain"].argmax(-1)).float().mean()),
         seconds=round(time.perf_counter() - t_start, 3))


def first_route_difference(calls: dict, moe_layers: int) -> dict | None:
    """Where the kernel path's routed ids first leave the plain path's:
    the route call (MoE layer, forward step: 0 the prefill) and the
    token within it; None where they never do."""
    for n, (a, p) in enumerate(zip(calls["auto"], calls["plain"])):
        bad = (a != p).any(-1).nonzero()
        if bad.numel():
            return {"moe_layer": n % moe_layers, "step": n // moe_layers,
                    "token": int(bad[0, 0])}
    return None


@contextlib.contextmanager
def spy_calls(module, name: str):
    """Record the result of every call of `module.<name>` in the block."""
    real, results = getattr(module, name), []

    def spy(*a, **kw):
        res = real(*a, **kw)
        results.append(res)
        return res

    setattr(module, name, spy)
    try:
        yield results
    finally:
        setattr(module, name, real)


def perf_slot_tenants(cfg, n=SLOT_TENANTS, batch=8, width=16):
    """`benchmarks/perf_slot_decode.py`'s tenants: batch 8, 16 tokens,
    router bias +6 (plus noise) on a band of E/n + 8 experts, -6
    elsewhere; the same numpy draws."""
    from repro_torch.serve.engine import Tenant
    rng = np.random.default_rng(0)
    out = []
    e = cfg.num_experts
    band = e // n
    for i in range(n):
        bias = np.full((e,), -6.0, np.float32)
        bias[i * band:(i + 1) * band + 8] = 6.0 + rng.normal(
            0, 0.5, min(band + 8, e - i * band))
        out.append(Tenant(
            name=f"tenant{i}",
            tokens=rng.integers(0, cfg.vocab, (batch, width)).astype(
                np.int32),
            router_bias=bias))
    return out


def phase_slot_engine(dev, cfg, params) -> None:
    """The paper-technique setting of `benchmarks/perf_slot_decode.py` at
    full width: 4 tenants, 16 expert shards, quantum 16 tokens, slots
    {2, 4} x slot-hit bias {0, 4}, 96 decode steps each through
    `SlotServeEngine`.  Per configuration: hit rate, fills, live experts
    per layer-step and synchronised wall ms per step from one run; then
    a second run of the same engine under `torch.profiler` for
    `moe_gmm_skip`'s device ms per step (`_kernel_ms`)."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.serve.engine import EngineConfig, SlotServeEngine
    moe_layers = sum(cfg.moe_layer_mask())
    for slots in (2, 4):
        for bias in (0.0, 4.0):
            def engine():
                return SlotServeEngine(
                    cfg, params,
                    EngineConfig(quantum_tokens=16, slots_per_shard=slots,
                                 expert_shards=SLOT_SHARDS, hit_bias=bias),
                    perf_slot_tenants(cfg), max_len=SLOT_STEPS + 4,
                    device=dev)
            eng = engine()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = eng.run(SLOT_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            del eng
            eng, before = engine(), moe_gmm.moe_gmm_skip.launches
            # the card alone: the host's slot bookkeeping adds CPU op
            # records by the thousand, which `_kernel_ms` does not read
            t0 = time.perf_counter()
            with profiled(cpu=False) as prof:
                eng.run(SLOT_STEPS)
            profiled_s = time.perf_counter() - t0
            launched = moe_gmm.moe_gmm_skip.launches - before
            check(launched == SLOT_STEPS * moe_layers,
                  f"slot engine launched moe_gmm_skip {launched} times")
            t0 = time.perf_counter()
            skip_ms = _kernel_ms(prof)["moe_gmm_skip"]
            read_s = time.perf_counter() - t0
            emit("slot_engine", arch=cfg.name, slots=slots, hit_bias=bias,
                 shards=SLOT_SHARDS, tenants=SLOT_TENANTS, batch=8,
                 steps=rep["steps"], hit_rate=rep["hit_rate"],
                 fills=rep["fills"], fill_seconds=rep["fill_seconds"],
                 live_experts_per_layer_step=rep["accesses"] /
                 (rep["steps"] * moe_layers),
                 wall_ms_per_step=1e3 * secs / rep["steps"],
                 run_s=secs, profiled_run_s=profiled_s,
                 profile_read_s=read_s,
                 moe_gmm_skip_device_ms_per_step=(
                     skip_ms / rep["steps"] if skip_ms > 0 else None))
            del eng


def _bmm_ffn(x, wg, wi, wo):
    """The same function in three `torch.bmm` calls: the yardstick
    (`library_ms`), never called by the port."""
    h = torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wi)
    return torch.bmm(h, wo)


def _gmm_bound(live: int, e: int, c: int, d: int, f: int, dtype,
               counts: bool) -> tuple[float, str, int, int]:
    """Least time of the grouped FFN, in ms, what bounds it, its flops
    and bytes (`moe_gmm.cost`): the live experts' weights and rows read
    once, the whole output written once (and the counts read), at the
    HBM rate; 6 C D F flops a live expert at the bf16 tensor-core rate."""
    from repro_torch.kernels import moe_gmm as gmm
    work = gmm.cost(live, e, c, d, f, dtype, counts=counts)
    return (*kernel_bound(work), sum(work["flops"].values()),
            work["bytes"])


# moe_gmm's capacities on arctic's path: prompts of 100-1,500 tokens give
# C 8-32 (models/moe.py rounds it up to a multiple of 8); moe_gmm_skip's
# live experts at a batch-8 decode step: 16 at most, 4 when the tokens
# share experts
TIME_CAPACITIES = (8, 16, 24, 32)
TIME_LIVE = (DECODE_LIVE, 4)


def _short_kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespaces and
    arguments: `tc::moe_gmm_kernel_mma<3, 0>`, `nvjet_tst_128x8_...`."""
    name = key.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i].strip()[:80]
    return name[:80]


def kernel_breakdown(fn, reps: int) -> dict:
    """Device milliseconds a call of `fn` spends in each kernel (the mean
    over one profiled session's records times the launches a call, as
    `device_ms` counts them), by short kernel name."""
    fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(reps):
            fn()
    out = {}
    for evt in cuda_rows(prof):
        per = max(1, round(evt.count / reps))
        name = _short_kernel_name(evt.key)
        out[name] = out.get(name, 0.0) + _device_us(evt) / evt.count \
            * per / 1e3
    return out


def _time_gmm(kernel, lib, reps: int, split: bool = False) -> dict:
    """Event and profiler device times of a grouped-FFN call and of the
    library yardstick on the same inputs; with `split`, also each one's
    device time by kernel (the kernel's two stages, the library's
    GEMMs)."""
    dev_ms, kept = device_ms(kernel, reps)
    lib_dev_ms, lib_kept = device_ms(lib, reps)
    out = dict(ms=cuda_ms(kernel, reps), device_ms=dev_ms,
               library_ms=cuda_ms(lib, reps), library_device_ms=lib_dev_ms,
               profiler_records_kept=[kept, lib_kept])
    if split:
        out["device_ms_by_kernel"] = kernel_breakdown(kernel, reps)
        out["library_device_ms_by_kernel"] = kernel_breakdown(lib, reps)
    return out


def phase_time_moe(dev, errs: dict, layer0) -> dict:
    """Kernel, plain and library times of both entry points at the path's
    shapes on the model's layer-0 experts (bf16): `moe_gmm` at a prefill
    (E 128, every expert live) at each capacity of TIME_CAPACITIES, and
    `moe_gmm_skip` at a batch-8 decode step (E 128, C 8) with 16 and 4
    live experts (the library call over the live experts only, gathered
    before the timing).  Each time twice: CUDA events over back-to-back
    calls (`ms`) and the profiler's device time (`device_ms`), beside
    three `torch.bmm` (`library_ms`, `library_device_ms`) and the bound;
    at C 24 and for the skip also each one's device time by kernel (the
    two stages against the library's GEMMs).  The plain version is timed
    at C 24 and at 16 live.  The weights
    (26.8 GB, 3.3 GB for 16 live) are far beyond the 50 MB L2.  Before
    the times, one line gives each call's route and its max abs error
    against the plain version, and the share of its bf16 outputs that
    differ from the plain version's at all."""
    from repro_torch.kernels import moe_gmm as gmm
    wg, wi, wo = layer0
    e, d, f = wg.shape
    dt = wg.dtype
    gen = torch.Generator(device=dev).manual_seed(5)
    out, accuracy, caps, lives = {}, {}, {}, {}

    def routed(fn, entry):
        """fn()'s output and the route its one launch of `entry` took."""
        before = dict(entry.routes)
        got = fn()
        return got, next(r for r, n in entry.routes.items()
                         if n != before[r])

    for c in TIME_CAPACITIES:
        x = torch.randn((e, c, d), generator=gen, device=dev).to(dt)
        got, route = routed(lambda: gmm.moe_gmm(x, wg, wi, wo), gmm.moe_gmm)
        want = gmm.moe_gmm_plain(x, wg, wi, wo)
        err = _gmm_err(got, want, dt, f"moe_gmm timing C={c}")
        errs["moe_gmm"] = max(errs["moe_gmm"], err)
        accuracy[f"moe_gmm C={c}"] = {
            "route": route, "max_abs_err": err,
            "differing_share": float((got != want).float().mean())}
        bound, by, flops, nbytes = _gmm_bound(e, e, c, d, f, dt, False)
        caps[c] = dict(
            _time_gmm(lambda: gmm.moe_gmm(x, wg, wi, wo),
                      lambda: _bmm_ffn(x, wg, wi, wo), 5,
                      split=c == PREFILL_C),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
            shape=f"prefill E={e} C={c} D={d} F={f} bf16, all live")
        if c == PREFILL_C:
            caps[c]["plain_ms"] = cuda_ms(
                lambda: gmm.moe_gmm_plain(x, wg, wi, wo), 1)
        del x, got, want

    for live in TIME_LIVE:
        x, counts = _decode_buffers(gen, e, DECODE_C, d, live, dt, dev)
        got, route = routed(lambda: gmm.moe_gmm_skip(x, wg, wi, wo, counts),
                            gmm.moe_gmm_skip)
        want = gmm.moe_gmm_skip_plain(x, wg, wi, wo, counts)
        err = _gmm_err(got, want, dt, f"moe_gmm_skip timing {live} live")
        errs["moe_gmm_skip"] = max(errs["moe_gmm_skip"], err)
        accuracy[f"moe_gmm_skip C={DECODE_C} {live} live"] = {
            "route": route, "max_abs_err": err,
            "differing_share": float((got != want).float().mean())}
        ids = torch.nonzero(counts > 0)[:, 0]
        gathered = [t[ids] for t in (x, wg, wi, wo)]
        n_live = int(ids.numel())
        bound, by, flops, nbytes = _gmm_bound(n_live, e, DECODE_C, d, f,
                                              dt, True)
        lives[live] = dict(
            _time_gmm(lambda: gmm.moe_gmm_skip(x, wg, wi, wo, counts),
                      lambda: _bmm_ffn(*gathered), 20, split=True),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
            shape=f"decode E={e} C={DECODE_C} D={d} F={f} bf16, "
                  f"{n_live} live, counts {counts[ids].tolist()}")
        if live == DECODE_LIVE:
            lives[live]["plain_ms"] = cuda_ms(
                lambda: gmm.moe_gmm_skip_plain(x, wg, wi, wo, counts), 3)
        del gathered, x, got, want
    emit("moe_gmm_accuracy", tolerance=GMM_TOL, calls=accuracy)

    out["moe_gmm"] = dict(caps[PREFILL_C], capacities={
        str(c): {k: v for k, v in t.items() if k != "plain_ms"}
        for c, t in caps.items()})
    emit("time_moe_gmm", **out["moe_gmm"])
    out["moe_gmm_skip"] = dict(lives[DECODE_LIVE], live={
        str(n): {k: v for k, v in t.items() if k != "plain_ms"}
        for n, t in lives.items()})
    emit("time_moe_gmm_skip", **out["moe_gmm_skip"])
    return out


def phase_moe_serve(dev) -> tuple[dict, dict]:
    """The slice's main path: `repro_torch.launch.serve` serving
    arctic-480b at full width (2 layers, all 128 experts), bf16: 8
    requests by continuous batching (`moe_gmm` at each prefill,
    `moe_gmm_skip` at each decode step), then its expert-slot half (3
    tenants, 48 steps, 4 slots).  The kernels' counts are set to 0 just
    before and read just after."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import serve
    cfg = register_arctic_2l()
    wrappers = {"moe_gmm": gmm.moe_gmm, "moe_gmm_skip": gmm.moe_gmm_skip,
                "flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention}
    for fn in wrappers.values():
        fn.launches = 0
    for fn in (gmm.moe_gmm, gmm.moe_gmm_skip):
        fn.routes = dict.fromkeys(fn.routes, 0)
    report = serve.serve(ARCTIC_2L, device=dev, **MOE_SERVE)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    routes = {name: dict(wrappers[name].routes)
              for name in ("moe_gmm", "moe_gmm_skip")}
    slots = report["expert_slots"]
    n = MOE_SERVE["num_requests"]
    check(report["finished"] == n, f"served {report['finished']} of {n}")
    check(report["generated_tokens"] == n * MOE_SERVE["new_tokens"],
          "tokens missing")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the serving path")
    layers = cfg.num_layers
    check(launches["moe_gmm"] == n * layers,
          f"moe_gmm launched {launches['moe_gmm']}, not {n * layers}")
    want_skip = (report["steps"] + slots["steps"]) * layers
    check(launches["moe_gmm_skip"] == want_skip,
          f"moe_gmm_skip launched {launches['moe_gmm_skip']}, not "
          f"{want_skip}")
    for name, by_route in routes.items():
        check(by_route == {"mma": launches[name], "fma": 0},
              f"{name} took routes {by_route} on the serving path, not the "
              f"tensor cores alone")
    check(slots["fill_seconds"] > 0, "the expert slots filled nothing")
    emit("moe_serve", arch=cfg.name, layers=layers,
         experts=cfg.num_experts, top_k=cfg.top_k,
         capacity_factor=cfg.capacity_factor, dtype=cfg.dtype,
         **{k: v for k, v in MOE_SERVE.items() if k != "prompt_len"},
         prompt_len=list(MOE_SERVE["prompt_len"]), launches=launches,
         routes=routes, **report)
    return launches, routes


# ---------------------------------------------------------------------------
# the recurrent slice: the RG-LRU and WKV scans, recurrentgemma-9b, rwkv6-7b
# ---------------------------------------------------------------------------

REC_SOURCES = {"rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
               "rwkv6_scan": "src/repro_torch/kernels/csrc/rwkv6_scan.cu"}
REC_REPLACES = {"rglru_scan": "src/repro/kernels/rglru_scan.py:71",
                "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:76"}
# kernel against plain version: test_kernels.py's tolerances; bf16 inputs
# are widened exactly in both, so the f32 tolerances hold for them too
SCAN_TOL = {"rglru_scan": 2e-5, "rwkv6_scan": 5e-4}
RG, RWKV = "recurrentgemma-9b", "rwkv6-7b"
RGLRU_CASES = (  # (B, T, W, with h0): test_kernels.py's, ragged, the path's
    (2, 128, 128, False), (1, 256, 256, False), (2, 64, 512, False),
    (3, 77, 200, True), (1, 4096, 4096, True), (8, 1, 4096, True),
    # the serving path's ragged prompts, and T below one 64-step chunk
    (1, 777, 4096, True), (1, 2040, 4096, True), (2, 50, 4096, True))
RWKV_CASES = (  # (B, T, H, N, with S0)
    (1, 128, 2, 32, False), (2, 128, 1, 64, False), (1, 64, 3, 16, False),
    (2, 37, 4, 16, True), (1, 1024, 64, 64, True), (8, 1, 64, 64, True),
    # the serving path's ragged prompts, and T below one 16-token
    # sub-chunk
    (1, 777, 64, 64, True), (1, 1500, 64, 64, True), (2, 7, 64, 64, True))
# strong decay: logw ~ U(-20, 0) a step; lam 6 with r near 1 (b_r + 8),
# a ~ exp(-48): a decay factored across a whole chunk would overflow here
RGLRU_STRONG = ((1, 1024, 4096, True), (2, 100, 512, False))
RWKV_STRONG = ((1, 1024, 64, 64, True), (2, 37, 4, 16, False))
RWKV_SPLIT_CASE = (1, 1024, 64, 64, True)   # the f32 error's attribution
ATTN256_FLASH = (  # (B, T, H, KH, D, window): recurrentgemma's local attn
    (1, 97, 16, 1, 256, 2048), (2, 333, 16, 1, 256, 128),
    (1, 1024, 16, 1, 256, 2048), (1, 4096, 16, 1, 256, 2048))
ATTN256_DECODE = ((8, 2048, 16, 1, 256), (4, 100, 16, 1, 256))
# the anchors' depth: one (rec, rec, lattn) segment; two rwkv blocks
ANCHOR_LAYERS = {RG: 3, RWKV: 2}
# the full-depth bf16 check: a prompt of two windows (the JAX model's
# two-chunk path) and 8 steps past it, around the ring; rwkv6 1,024
DEEP_PROMPT = {RG: 4096, RWKV: 1024}
# the dtype whose kernel-vs-plain check is gated.  rwkv6 with random
# weights is chaotic in bf16: on the CPU, at d 512 / 1,024 and 32 layers,
# its plain path against itself with the scan summed in f64 (a
# perturbation of f32 rounding size) differs by 63 % / 41 % relative L2
# (0.33 % / 0.44 % in f32), so its bf16 end-to-end difference measures
# bf16's rounding, not the kernel: it is gated in f32 (30 GB of weights)
# and its bf16 value reported.  recurrentgemma's bf16 value stays gated.
DEEP_GATED_DTYPE = {RG: "bfloat16", RWKV: "float32"}
# the slice's main paths: 16 requests each through the launcher; rows
# whose recurrentgemma prompt passes 1,984 tokens wrap the window ring
REC_SERVE = {
    RG: dict(num_requests=16, batch=8, max_len=4096, new_tokens=64,
             prompt_len=(100, 2040)),
    RWKV: dict(num_requests=16, batch=8, max_len=2048, new_tokens=64,
               prompt_len=(100, 1500))}
# recurrentgemma's prompts for the flash timing: one window, two windows
FLASH_PROMPTS_D256 = (1024, 4096)
# bytes of inputs a scan timing cycles through: three times the 50 MB L2
SCAN_ROTATE_BYTES = 150_000_000


def _recurrent(arch: str, **kw):
    from repro_torch.configs import base as cb
    cb.load_all()
    return dataclasses.replace(cb.get_config(arch), **kw)


def _scan_inputs(name, case, dtype, gen, dev, strong: bool = False):
    """Seeded inputs of one scan case, in test_kernels.py's distributions
    (gate parameters N(0, 0.01), lam on [2, 6]; logw = -exp(N(0, 0.25)),
    u ~ N(0, 0.01)); states N(0, 1).  `strong`: lam 6 and b_r + 8 (r near
    1); logw ~ U(-20, 0)."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    if name == "rglru_scan":
        b, t, w, start = case
        params = [r(w) * 0.1 for _ in range(4)]
        params.append(torch.linspace(2.0, 6.0, w, device=dev))
        if strong:
            params[1] = params[1] + 8.0
            params[4] = torch.full((w,), 6.0, device=dev)
        return (r(b, t, w).to(dtype), *params, r(b, w) if start else None)
    b, t, h, n, start = case
    rkv = [r(b, t, h, n).to(dtype) for _ in range(3)]
    logw = (-20.0 * torch.rand((b, t, h, n), generator=gen, device=dev)
            if strong else -torch.exp(r(b, t, h, n) * 0.5))
    return (*rkv, logw, r(h, n) * 0.1, r(b, h, n, n) if start else None)


def _scan_err(name, args, what: str) -> tuple[float, float, str]:
    """The scan's wrapper against its plain version on one input: both
    outputs held to SCAN_TOL.  Returns the largest difference, the
    largest share of the tolerance (|got - want| / (tol + tol |want|))
    and the route the wrapper took."""
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    fn = getattr(rgs if name == "rglru_scan" else rws, name)
    before = dict(fn.routes)
    got = fn(*args)
    route = next(r for r in fn.routes if fn.routes[r] > before[r])
    want = getattr(rgs if name == "rglru_scan" else rws,
                   f"{name}_plain")(*args)
    tol = SCAN_TOL[name]
    err = share = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol,
                                   msg=lambda m: f"{name} {what}: {m}")
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        share = max(share, float((diff / (tol + tol * w.abs())).max()))
    return err, share, route


def _path_route(name, case) -> str:
    """The route the wrapper takes for a case of contiguous (so 16-byte
    aligned) tensors, as a serving path calls it: chunked from two WKV
    sub-chunks, or past one RG-LRU chunk; step below."""
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    t = case[1]
    if name == "rglru_scan":
        return "chunked" if t > rgs.CHUNK else "step"
    return "chunked" if t >= 2 * rws.SUB_CHUNK else "step"


def phase_scans_vs_plain(dev, errs: dict) -> None:
    """Both scans through their wrappers against their plain versions, f32
    and bf16 inputs, each case on the route the wrapper picks for it (and
    fails on another): test_kernels.py's shapes, ragged T, T below a
    sub-chunk, a given initial state, the full-width prefill and decode
    shapes of the serving path, and strong decay.  Reports each case's
    largest difference and share of its tolerance, the worst by kernel,
    dtype and route, and the share of one f32 WKV prefill with its
    operands made exact in bf16 one by one (what the splits cost)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    worst, cases_out = {}, {}
    for name, cases, strong_cases in (
            ("rglru_scan", RGLRU_CASES, RGLRU_STRONG),
            ("rwkv6_scan", RWKV_CASES, RWKV_STRONG)):
        for dtype in (torch.float32, torch.bfloat16):
            for case, strong in ([(c, False) for c in cases] +
                                 [(c, True) for c in strong_cases]):
                args = _scan_inputs(name, case, dtype, gen, dev, strong)
                dt = str(dtype).split(".")[-1]
                what = f"{dt} {case}{' strong' if strong else ''}"
                err, share, route = _scan_err(name, args, what)
                check(route == _path_route(name, case),
                      f"{name} {what} took the {route} route, not the "
                      f"{_path_route(name, case)} one")
                key = (name, dt, route)
                e0, f0 = worst.get(key, (0.0, 0.0))
                worst[key] = (max(e0, err), max(f0, share))
                cases_out[f"{name} {what}"] = [route, err, share]
    # where the WKV chunked route's f32 error comes from: one f32 prefill
    # as drawn, with v, and with r, k and v rounded to bf16 values (exact
    # in the bf16 hi part of the kernel's splits; decayed r and k are not)
    args = _scan_inputs("rwkv6_scan", RWKV_SPLIT_CASE, torch.float32, gen,
                        dev)
    exact = lambda x: x.bfloat16().float()
    split_share = {
        what: _scan_err("rwkv6_scan", a, f"float32 {what}")[1]
        for what, a in (
            ("as drawn", args),
            ("v exact", (*args[:2], exact(args[2]), *args[3:])),
            ("r, k, v exact", (*map(exact, args[:3]), *args[3:])))}
    torch.cuda.synchronize()
    for (name, _, _), (err, _) in worst.items():
        errs[name] = max(errs[name], err)
    emit("scans_vs_plain", rglru_cases=[list(c) for c in RGLRU_CASES],
         rwkv6_cases=[list(c) for c in RWKV_CASES],
         rglru_strong_cases=[list(c) for c in RGLRU_STRONG],
         rwkv6_strong_cases=[list(c) for c in RWKV_STRONG],
         dtypes=["float32", "bfloat16"], tolerance=SCAN_TOL,
         max_abs_err={" ".join(k): e for k, (e, _) in worst.items()},
         max_share_of_tolerance={" ".join(k): f
                                 for k, (_, f) in worst.items()},
         by_case_route_err_share=cases_out,
         rwkv6_float32_share_by_exact_operand=dict(
             case=list(RWKV_SPLIT_CASE), **split_share), match=True)


def phase_attention256_vs_plain(dev, errs: dict) -> None:
    """Both attention kernels at recurrentgemma's head dim 256, 16 query
    heads over 1 kv head, against their plain versions (bf16 and f32):
    windowed prefills up to the 4,096-token prompt of two windows, and
    decode over the 2,048-slot ring with ragged kv_len."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(15)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        for b, t, h, kh, d, window in ATTN256_FLASH:
            q, k, v = r(b, t, h, d), r(b, t, kh, d), r(b, t, kh, d)
            err = _attn_err(fa.flash_attention(q, k, v, window=window),
                            fa.flash_attention_plain(q, k, v, window=window),
                            dtype, f"flash {dtype} T={t} D={d} "
                                   f"window={window}")
            worst[("flash", key)] = max(worst.get(("flash", key), 0.0), err)
        for b, s, h, kh, d in ATTN256_DECODE:
            q, kc, vc = r(b, h, d), r(b, s, kh, d), r(b, s, kh, d)
            kv_len = torch.as_tensor(np.random.default_rng(s).integers(
                1, s + 1, b).astype(np.int32), device=dev)
            kv_len[0] = s
            err = _attn_err(da.decode_attention(q, kc, vc, kv_len),
                            da.decode_attention_plain(q, kc, vc, kv_len),
                            dtype, f"decode {dtype} S={s} D={d}")
            worst[("decode", key)] = max(worst.get(("decode", key), 0.0),
                                         err)
    torch.cuda.synchronize()
    for (name, _), err in worst.items():
        errs[f"{name}_attention"] = max(errs[f"{name}_attention"], err)
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    emit("attention256_vs_plain", flash_cases=len(ATTN256_FLASH),
         decode_cases=len(ATTN256_DECODE), dtypes=["float32", "bfloat16"],
         tolerance=ATTN_TOL, max_abs_err={f"{n} {d}": e for (n, d), e in
                                           worst.items()}, match=True,
         decode_smem_bytes={f"G=16 D=256 {n}": da.smem_bytes(16, 256, t)
                            for n, t in dtypes},
         flash_smem_bytes={f"D=256 {n}": fa.smem_bytes(256, t)
                           for n, t in dtypes})


def phase_recurrent_jax_anchor(dev, arch: str) -> None:
    """recurrentgemma-9b (3 layers) or rwkv6-7b (2 layers) at full width,
    f32, weights from `numpy_params(cfg, 0)`: prefill 97 tokens and
    decode 8 through the kernels (the window ring and the states need no
    padding); logits at 32 ids and the argmax of each step against the
    JAX package's (REC_JAX_ANCHOR)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    from repro_torch.models import convert, transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _recurrent(arch, num_layers=ANCHOR_LAYERS[arch], dtype="float32")
    anchor = REC_JAX_ANCHOR[arch]
    params = convert.params_from_numpy(convert.numpy_params(cfg, 0), dev,
                                       torch.float32)
    tokens, ids = anchor_inputs(cfg.vocab)
    check(ids.tolist() == anchor["ids"] and
          hashlib.sha1(tokens.tobytes()).hexdigest() ==
          anchor["tokens_sha1"], "numpy drew other anchor inputs")
    wrappers = {"rglru_scan": rgs.rglru_scan, "rwkv6_scan": rws.rwkv6_scan,
                "flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention}
    before = {name: fn.launches for name, fn in wrappers.items()}
    prompt = 97
    logits, cache, _ = transformer.prefill(cfg, params,
                                           {"tokens": tokens[:, :prompt]})
    rows = [logits[0, -1]]
    for i in range(prompt, prompt + 8):
        logits, cache, _ = transformer.decode_step(
            cfg, params, {"tokens": tokens[:, i:i + 1],
                          "positions": np.full((1,), i, np.int32)}, cache)
        rows.append(logits[0, -1])
    torch.cuda.synchronize()
    launched = {n: fn.launches - before[n] for n, fn in wrappers.items()}
    types = [t for ts, n in transformer.segments(cfg) for t in ts
             for _ in range(n)]
    want = {"rglru_scan": 9 * types.count("rec"),
            "rwkv6_scan": 9 * types.count("rwkv"),
            "flash_attention": types.count("lattn"),
            "decode_attention": 8 * types.count("lattn")}
    check(launched == want, f"{arch} anchor launched {launched}, not {want}")
    err, argmax = _hold_to_anchor(rows, ids, anchor, f"{arch} anchor")
    emit("recurrent_jax_anchor", arch=arch, layers=cfg.num_layers,
         dtype="float32", prompt=prompt, decode_steps=8,
         compared_ids=len(ids), max_abs_err=err, tolerance=ANCHOR_TOL,
         argmax=argmax,
         argmax_match=sum(a == w for a, w in zip(argmax, anchor["argmax"])),
         launches={n: c for n, c in launched.items() if c})
    del params, cache


def phase_recurrent_consistency(dev, cfg, params) -> None:
    """The model at full width and depth, random weights: one prompt of
    DEEP_PROMPT tokens and 8 decode steps through the kernels against the
    plain path, logits within DEEP_BF16_REL where `cfg.dtype` is the
    arch's DEEP_GATED_DTYPE, reported otherwise (recurrentgemma's prompt
    is two windows, so the steps at 4,096.. wrap the ring)."""
    from repro_torch.models import transformer
    arch = cfg.name
    b, t0, steps = 1, DEEP_PROMPT[arch], 8
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab, (b, t0 + steps)).astype(np.int32)
    out = {}
    t_start = time.perf_counter()
    for mode in ("auto", "plain"):
        logits, cache, _ = transformer.prefill(
            cfg, params, {"tokens": tokens[:, :t0]}, use_kernel=mode)
        rows = [logits]
        for i in range(t0, t0 + steps):
            logits, cache, _ = transformer.decode_step(
                cfg, params, {"tokens": tokens[:, i:i + 1],
                              "positions": np.full((b,), i, np.int32)},
                cache, use_kernel=mode)
            rows.append(logits)
        out[mode] = torch.cat(rows, 1)
        del cache
    torch.cuda.synchronize()
    rel = _rel(out["auto"], out["plain"])
    gated = cfg.dtype == DEEP_GATED_DTYPE[arch]
    check(not gated or rel <= DEEP_BF16_REL,
          f"{arch} {cfg.dtype} consistency: relative L2 {rel} > "
          f"{DEEP_BF16_REL}")
    emit("recurrent_consistency", arch=arch, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=b, prefill=t0, decode_steps=steps,
         rel_l2_kernel_vs_plain=rel,
         tolerance=DEEP_BF16_REL if gated else None,
         argmax_agree=float((out["auto"].argmax(-1) ==
                             out["plain"].argmax(-1)).float().mean()),
         seconds=round(time.perf_counter() - t_start, 3))


def phase_recurrent_serve(dev, arch: str) -> dict:
    """The slice's main path for one arch: `repro_torch.launch.serve`
    serving it at full width and depth, bf16 (REC_SERVE).  Every kernel's
    count is set to 0 just before and read just after; each recurrent
    block launches its scan once a prefill and once a decode step, each
    local-attention block the flash kernel once a prefill and the decode
    kernel once a step."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    kw = REC_SERVE[arch]
    cfg = _recurrent(arch)
    wrappers = {"rglru_scan": rgs.rglru_scan, "rwkv6_scan": rws.rwkv6_scan,
                "flash_attention": fa.flash_attention,
                "decode_attention": da.decode_attention}
    for fn in wrappers.values():
        fn.launches = 0
    for name in ("rglru_scan", "rwkv6_scan"):
        wrappers[name].routes = dict.fromkeys(wrappers[name].routes, 0)
    report = serve.serve(arch, device=dev, **kw)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    scan = "rglru_scan" if arch == RG else "rwkv6_scan"
    routes = dict(wrappers[scan].routes)
    n = kw["num_requests"]
    check(report["finished"] == n, f"served {report['finished']} of {n}")
    check(report["generated_tokens"] == n * kw["new_tokens"],
          "tokens missing")
    types = [t for ts, k in transformer.segments(cfg) for t in ts
             for _ in range(k)]
    blocks = types.count("rec") + types.count("rwkv")
    want = {name: 0 for name in wrappers}
    want[scan] = (n + report["steps"]) * blocks
    want["flash_attention"] = n * types.count("lattn")
    want["decode_attention"] = report["steps"] * types.count("lattn")
    check(launches == want, f"{arch} serving launched {launches}, not "
                            f"{want}")
    # every prefill (a row at a time, T >= 100) on the chunked route, every
    # decode step (T 1) on the step route
    want_routes = {"chunked": n * blocks, "step": report["steps"] * blocks}
    check(routes == want_routes, f"{arch} serving took the routes "
                                 f"{routes}, not {want_routes}")
    emit("recurrent_serve", arch=arch, layers=cfg.num_layers,
         dtype=cfg.dtype, **{k: v for k, v in kw.items()
                             if k != "prompt_len"},
         prompt_len=list(kw["prompt_len"]), launches=launches,
         routes={scan: routes}, **report)
    return launches, routes


def _cycled(fn, sets: list):
    """A call of fn on the next of `sets` (argument tuples), round and
    round."""
    state = {"i": 0}

    def call():
        i = state["i"] = (state["i"] + 1) % len(sets)
        return fn(*sets[i])
    return call


def phase_time_recurrent(dev, errs: dict, attn_errs: dict) -> dict:
    """Kernel and plain times of both scans at the full-width prefill
    (T 1,024, bf16 inputs) and decode (B 8, T 1, from a state) shapes
    (event means of back-to-back wrapper calls, the host's call included,
    and the profiler's device time, in all and by kernel, with the route
    the wrapper took and the share of the bound), each call on the next
    of enough input sets (states included) to pass SCAN_ROTATE_BYTES, so
    that every input comes from HBM, as on the serving path, where each
    block keeps its own state,
    and of both attention kernels at head dim 256 (flash: T 1,024 and
    4,096, 16 heads over 1, window 2,048; decode: B 8 over 2,048-slot
    rings with ragged kv_len, cycling through 8 layers' rings, 134 MB,
    beyond the 50 MB L2) with SDPA's event and device times beside them.
    No single PyTorch call computes a scan: their library time is
    None."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    gen = torch.Generator(device=dev).manual_seed(16)
    bf16 = torch.bfloat16
    out = {}
    for name, mod, shapes in (
            ("rglru_scan", rgs, {"prefill": (1, 1024, 4096, True),
                                 "decode": (8, 1, 4096, True)}),
            ("rwkv6_scan", rws, {"prefill": (1, 1024, 64, 64, True),
                                 "decode": (8, 1, 64, 64, True)})):
        for where, case in shapes.items():
            if name == "rglru_scan":
                b, t, w, _ = case
                work = rgs.cost(b, t, w, bf16, True)
                in_bytes = 2 * b * t * w + 5 * 4 * w + 4 * b * w
                shape = f"B={b} T={t} W={w}, u bf16, h0 given"
            else:
                b, t, h, n, _ = case
                work = rws.cost(b, t, h, n, bf16, True)
                in_bytes = (3 * 2 + 4) * b * t * h * n + 4 * h * n + \
                    4 * b * h * n * n
                shape = f"B={b} T={t} H={h} N={n}, r/k/v bf16, S0 given"
            sets = [_scan_inputs(name, case, bf16, gen, dev) for _ in range(
                max(2, -(-SCAN_ROTATE_BYTES // in_bytes)))]
            err, _, route = _scan_err(name, sets[0], f"timing {where}")
            errs[name] = max(errs[name], err)
            fn = _cycled(getattr(mod, name), sets)
            plain = getattr(mod, f"{name}_plain")
            ms = cuda_ms(fn, 50)
            # the profiler kept few records of the short decode calls
            reps = 100 if where == "decode" else 20
            dev_ms, kept = device_ms(fn, reps)
            by_kernel = kernel_breakdown(fn, reps)
            plain_ms = cuda_ms(_cycled(plain, sets), 2)
            bound, by = kernel_bound(work)
            out[f"{name} {where}"] = dict(
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound, bound_by=by,
                flops=sum(work["flops"].values()), bytes=work["bytes"],
                share_of_bound=bound / dev_ms if dev_ms else None,
                shape=shape, route=route, input_sets=len(sets),
                profiler_records_kept=kept, device_ms_by_kernel=by_kernel)
            emit(f"time_{name}_{where}", **out[f"{name} {where}"])

    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf16)
    h, kh, d, window = 16, 1, 256, 2048
    prompts = {}
    for t in FLASH_PROMPTS_D256:
        q, k, v = r(1, t, h, d), r(1, t, kh, d), r(1, t, kh, d)
        attn_errs["flash_attention"] = max(
            attn_errs["flash_attention"], _attn_err(
                fa.flash_attention(q, k, v, window=window),
                fa.flash_attention_plain(q, k, v, window=window), bf16,
                f"flash D=256 T={t} timing"))
        prompts[t] = _time_flash(q, k, v, window, 20, plain=t == 1024)
    out["flash_attention d256"] = dict(
        prompts[1024],
        shape=f"prefill B=1 T=1024 H={h} KH={kh} D={d} bf16 causal, "
              f"window {window}",
        prompts={str(t): {k: v for k, v in x.items() if k != "plain_ms"}
                 for t, x in prompts.items()})
    emit("time_flash_attention_d256", **out["flash_attention d256"])

    b, s, layers = 8, 2048, 8
    kv_len = torch.as_tensor(np.random.default_rng(2).integers(
        100, s + 1, b).astype(np.int32), device=dev)
    q = r(b, h, d)
    kc, vc = r(layers, b, s, kh, d), r(layers, b, s, kh, d)
    attn_errs["decode_attention"] = max(
        attn_errs["decode_attention"],
        _attn_err(da.decode_attention(q, kc[0], vc[0], kv_len),
                  da.decode_attention_plain(q, kc[0], vc[0], kv_len), bf16,
                  "decode D=256 timing"))
    out["decode_attention d256"] = dict(
        _time_decode(q, kc, vc, kv_len, 100),
        shape=f"decode B={b} S={s} H={h} KH={kh} D={d} bf16, "
              f"kv_len {kv_len.tolist()}")
    emit("time_decode_attention_d256", **out["decode_attention d256"])
    return out


def phase_recurrent(dev, attn_errs: dict) -> tuple[list, dict]:
    """The recurrent slice, model by model (each served alone and freed
    before the next).  Returns its two entries of the `kernels` line and,
    for each attention kernel, its head-dim-256 times and its launches on
    recurrentgemma's serving path."""
    from repro_torch.models import transformer
    errs = {"rglru_scan": 0.0, "rwkv6_scan": 0.0}
    phase_scans_vs_plain(dev, errs)
    phase_attention256_vs_plain(dev, attn_errs)
    for arch in (RG, RWKV):
        phase_recurrent_jax_anchor(dev, arch)
        torch.cuda.empty_cache()
    times = phase_time_recurrent(dev, errs, attn_errs)
    torch.cuda.empty_cache()
    launches, routes = {}, {}
    for arch in (RG, RWKV):
        cfg = _recurrent(arch)
        if DEEP_GATED_DTYPE[arch] != cfg.dtype:
            deep = _recurrent(arch, dtype=DEEP_GATED_DTYPE[arch])
            params = transformer.init_params(
                deep, torch.Generator(device=dev).manual_seed(0), dev)
            phase_recurrent_consistency(dev, deep, params)
            del params
            torch.cuda.empty_cache()
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        phase_recurrent_consistency(dev, cfg, params)
        profile_serving(dev, cfg, params,
                        f"serve_profile_{arch.split('-')[0]}")
        del params
        torch.cuda.empty_cache()
        launches[arch], routes[arch] = phase_recurrent_serve(dev, arch)
        torch.cuda.empty_cache()
    entries = []
    for name, arch in (("rglru_scan", RG), ("rwkv6_scan", RWKV)):
        prefill, decode = times[f"{name} prefill"], times[f"{name} decode"]
        entries.append({
            "name": name, "route": "cuda", "source": REC_SOURCES[name],
            "replaces": REC_REPLACES[name],
            "launches": launches[arch][name], "max_abs_err": errs[name],
            "ms": prefill["ms"], "plain_ms": prefill["plain_ms"],
            "bound_ms": prefill["bound_ms"], "bound_by": prefill["bound_by"],
            "library_ms": None, "device_ms": prefill["device_ms"],
            "match": True, "shape": prefill["shape"],
            "prefill_route": prefill["route"], "routes": routes[arch],
            "decode": {k: decode[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "shape", "route")}})
    attn = {name: dict(times[f"{name} d256"],
                       launches_recurrentgemma=launches[RG][name])
            for name in ("flash_attention", "decode_attention")}
    return entries, attn


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_attention", "moe_gmm", "rglru_scan", "rwkv6_scan")
TRAIN_GRAD_REL = 1e-4       # kernel route against plain, relative L2
# the slice's main path: granite-3-2b at full width and depth, bf16 with
# the f32 master, m and v, remat "full" and loss_chunk 512 (the config's
# own), batch 4 of 1,024 tokens, 8 steps through the launcher
TRAIN = dict(smoke=False, steps=8, batch=4, seq=1024, log_every=0)
GRANITE = "granite-3-2b"
# the first step's loss against `loss_fn(use_kernel="plain")` on the same
# weights and batch, relative: bf16 logits walk ~5e-2 apart in relative L2
# over 40 layers (DEEP_BF16_REL), ~5e-2 a token's loss at logits of std ~1;
# averaged over 4,092 tokens that is ~1e-4 of a loss of ~11
TRAIN_LOSS_REL = 1e-3
# the supervised restart, cut in depth to 2 layers (a checkpoint of the
# full-depth state would write ~35 GB): 8 steps, a checkpoint every 4, a
# failure injected before step 6
GRANITE_2L = "granite-3-2b-2l"
RESTART = dict(TRAIN, ckpt_every=4)
RESTART_FAIL_AT = 6


def _train_wrappers() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rglru_scan as rgs
    from repro_torch.kernels import rwkv6_scan as rws
    return {"flash_attention": fa.flash_attention, "moe_gmm": gmm.moe_gmm,
            "rglru_scan": rgs.rglru_scan, "rwkv6_scan": rws.rwkv6_scan}


def _train_cases(dev, gen):
    """(kernel, what, args, keywords) of the training path's calls at
    batch TRAIN["batch"] of TRAIN["seq"] tokens from a zero state, full
    width: granite's attention in bf16 (its own dtype) and f32,
    recurrentgemma's local attention in f32, arctic's grouped FFN in bf16
    (its own dtype) at its training capacity, cut to 4 of its 128 experts,
    and recurrentgemma's RG-LRU and rwkv6's WKV in f32."""
    from repro_torch.configs import base as cb
    from repro_torch.models import moe
    cb.load_all()
    b, t = TRAIN["batch"], TRAIN["seq"]
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    g, rg, rw, arc = (cb.get_config(a) for a in (
        GRANITE, RG, RWKV, "arctic-480b"))
    for dtype in (torch.bfloat16, torch.float32):
        qkv = (r(b, t, g.num_heads, g.head_dim),
               r(b, t, g.num_kv_heads, g.head_dim),
               r(b, t, g.num_kv_heads, g.head_dim))
        yield ("flash_attention", f"{GRANITE} {str(dtype)[6:]} B={b} T={t} "
               f"H={g.num_heads}/{g.num_kv_heads} D={g.head_dim}",
               tuple(x.to(dtype) for x in qkv), {"window": 0})
    yield ("flash_attention", f"{RG} local float32 B={b} T={t} "
           f"H={rg.num_heads}/{rg.num_kv_heads} D={rg.head_dim} "
           f"window={rg.window}",
           (r(b, t, rg.num_heads, rg.head_dim),
            r(b, t, rg.num_kv_heads, rg.head_dim),
            r(b, t, rg.num_kv_heads, rg.head_dim)), {"window": rg.window})
    e, c = 4, moe._capacity(b * t, arc)
    d, f = arc.d_model, arc.d_ff
    yield ("moe_gmm", f"arctic-480b bfloat16 E={e} of {arc.num_experts} "
           f"C={c} D={d} F={f} gated",
           tuple(x.to(torch.bfloat16) for x in (
               r(e, c, d) * 0.5, r(e, d, f) * d ** -0.5,
               r(e, d, f) * d ** -0.5, r(e, f, d) * f ** -0.5)),
           {"gated": True})
    case = (b, t, rg.lru_width, False)
    yield ("rglru_scan", f"{RG} float32 {case}",
           _scan_inputs("rglru_scan", case, torch.float32, gen, dev), {})
    case = (b, t, rw.d_model // rw.head_dim, rw.head_dim, False)
    yield ("rwkv6_scan", f"{RWKV} float32 {case}",
           _scan_inputs("rwkv6_scan", case, torch.float32, gen, dev), {})


def _train_tol(name: str, dtype: torch.dtype) -> float:
    if name in SCAN_TOL:
        return SCAN_TOL[name]
    return (ATTN_TOL if name == "flash_attention" else GMM_TOL)[
        str(dtype).split(".")[-1]]


def phase_train_grads(dev) -> None:
    """train_grads: each of the four Functions (a kernel's forward, its
    plain version's gradient) at the training path's shapes, against
    `use_kernel="plain"` on the same inputs: the outputs within the
    kernel's tolerance against its plain version, bf16 flash also within
    ACCURACY_FLOOR_FACTOR of the bf16 rounding floor against float64, and
    the gradients of every input for a fixed random cotangent of every
    output within TRAIN_GRAD_REL relative L2 (the wiring: both routes'
    backwards are plain bodies, the scans' kernel route's chunked)."""
    fns = _train_wrappers()
    gen = torch.Generator(device=dev).manual_seed(21)
    cases = {}
    for name, what, args, kw in _train_cases(dev, gen):
        outs, grads = {}, {}
        for mode in ("auto", "plain"):
            leaves = [None if a is None else a.detach().requires_grad_(True)
                      for a in args]
            got = fns[name](*leaves, use_kernel=mode, **kw)
            got = got if isinstance(got, tuple) else (got,)
            cot = torch.Generator(device=dev).manual_seed(5)
            loss = sum((o.float() * torch.randn(o.shape, generator=cot,
                                                device=dev)).sum()
                       for o in got)
            grads[mode] = torch.autograd.grad(
                loss, [a for a in leaves if a is not None])
            outs[mode] = [o.detach() for o in got]
            del got, loss, leaves
        dtype = args[0].dtype
        tol = _train_tol(name, dtype)
        for o, w in zip(outs["auto"], outs["plain"], strict=True):
            torch.testing.assert_close(
                o.float(), w.float(), atol=tol, rtol=tol,
                msg=lambda m: f"train_grads {name} {what}: {m}")
        row = {"max_abs_err": max(float((o.float() - w.float()).abs().max())
                                  for o, w in zip(outs["auto"],
                                                  outs["plain"])),
               "tolerance": tol}
        if name == "flash_attention" and dtype == torch.bfloat16:
            q, k, v = args
            pos = torch.arange(q.shape[1], device=dev)
            want = _attention_f64(q, k, v, pos[None, :] <= pos[:, None])
            row["rel_l2_f64"] = _rel(outs["auto"][0], want)
            row["floor_f64"] = _rel(want.to(torch.bfloat16), want)
            del want
            check(row["rel_l2_f64"] <= ACCURACY_FLOOR_FACTOR
                  * row["floor_f64"],
                  f"flash at {what}: relative L2 {row['rel_l2_f64']} against "
                  f"float64, above {ACCURACY_FLOOR_FACTOR} x the bf16 "
                  f"rounding floor {row['floor_f64']}")
        row["grad_rel_l2"] = max(
            float((g - w).norm() / w.norm().clamp_min(1e-30))
            for g, w in zip(grads["auto"], grads["plain"], strict=True))
        check(row["grad_rel_l2"] < TRAIN_GRAD_REL,
              f"{name} {what}: the kernel route's gradients are "
              f"{row['grad_rel_l2']} (relative L2) from the plain route's")
        cases[f"{name} {what}"] = row
        del outs, grads, args
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit("train_grads", grad_tolerance=TRAIN_GRAD_REL,
         floor_factor=ACCURACY_FLOOR_FACTOR, cases=cases, match=True)


def _train_counts() -> dict:
    fns = _train_wrappers()
    return {n: {"launches": fn.launches,
                "backward_recomputes": fn.backward_recomputes}
            for n, fn in fns.items()}


def _reset_train_counts() -> None:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import moe_gmm as gmm
    for fn in _train_wrappers().values():
        fn.launches = 0
        fn.backward_recomputes = 0
    da.decode_attention.launches = 0
    gmm.moe_gmm_skip.launches = 0


def _drawn_params(cfg, dev):
    """`cfg`'s weights drawn on the card from seed 0
    (`transformer.init_params`), for `run(init_params=...)`: the host's
    numpy draw of granite's 2.5 B weights takes ~40 s."""
    from repro_torch.models import transformer
    return transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _plain_first_loss(cfg, params, dev) -> float:
    """`loss_fn(use_kernel="plain")` on the training run's first batch."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import transformer
    b, t = TRAIN["batch"], TRAIN["seq"]
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=t, global_batch=b)
    batch = train.batch_for(cfg, dcfg, 0, {"tokens": ((b, t), torch.int32)},
                            dev)
    with torch.no_grad():
        loss, _ = transformer.loss_fn(cfg, params, batch, use_kernel="plain")
    return float(loss)


def _flash_vjp_ms(dev, cfg, batch: int, seq: int) -> float:
    """Event-timed milliseconds of one flash call's backward on the
    training path (the plain block scan's forward and vector-Jacobian
    product) at the path's shape, bf16, on its own."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    q = r(batch, seq, cfg.num_heads, cfg.head_dim)
    k = r(batch, seq, cfg.num_kv_heads, cfg.head_dim)
    v = r(batch, seq, cfg.num_kv_heads, cfg.head_dim)
    out = fa.flash_attention(q, k, v, causal=True)
    cot = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), cot,
                                               retain_graph=True), 5)


def phase_train_granite(dev, card: str) -> dict:
    """train_granite, the slice's main path: `launch.train.run` of
    granite-3-2b at full width and depth, its weights drawn on the card.
    The first step's loss must agree with `loss_fn(use_kernel="plain")`
    on the same weights and batch within TRAIN_LOSS_REL, the loss must
    fall (the mean of the last 2 steps below the first 2's), flash must
    launch on every layer (twice a step: the forward and remat's
    recompute) and take one plain backward a layer a step, and neither
    decode attention nor moe_gmm_skip may launch.  Reports the median step
    time over steps 3-8, tokens/s, the peak memory and an estimate of
    flash's plain-vjp backward's share of the step (one such backward
    timed on its own, times the layers).  Returns the kernels' counts and
    {"step_s", "peak_memory_bytes"} of the run."""
    from repro_torch.configs import base as cb
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.launch import train
    cb.load_all()
    cfg = cb.get_config(GRANITE)
    check(cfg.remat == "full" and cfg.loss_chunk == 512
          and cfg.dtype == "bfloat16", f"{GRANITE}'s config changed")
    params = _drawn_params(cfg, dev)
    plain_loss = _plain_first_loss(cfg, params, dev)
    torch.cuda.empty_cache()
    _reset_train_counts()
    report = train.run(GRANITE, device=dev, init_params=params, **TRAIN)
    counts = _train_counts()
    del params
    off_path = {"decode_attention": da.decode_attention.launches,
                "moe_gmm_skip": gmm.moe_gmm_skip.launches}
    losses = report["losses"]
    steps, layers = TRAIN["steps"], cfg.num_layers
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"granite training losses {losses}")
    first_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(first_rel <= TRAIN_LOSS_REL,
          f"granite's first loss {losses[0]} against the plain route's "
          f"{plain_loss} on the same weights and batch")
    check(np.mean(losses[-2:]) < np.mean(losses[:2]),
          f"granite's loss did not fall: {losses}")
    check(counts["flash_attention"] == {
        "launches": 2 * layers * steps,
        "backward_recomputes": layers * steps},
        f"flash on the training path: {counts['flash_attention']}")
    check(all(c == {"launches": 0, "backward_recomputes": 0}
              for n, c in counts.items() if n != "flash_attention"),
          f"other kernels on granite's training path: {counts}")
    check(off_path == {"decode_attention": 0, "moe_gmm_skip": 0},
          f"kernels off the training path launched: {off_path}")
    torch.cuda.empty_cache()
    vjp_ms = _flash_vjp_ms(dev, cfg, TRAIN["batch"], TRAIN["seq"])
    step_ms = report["step_s"] * 1e3
    emit("train_granite", arch=GRANITE, card=card, layers=layers,
         d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
         d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.dtype, remat=cfg.remat,
         loss_chunk=cfg.loss_chunk, batch=TRAIN["batch"], seq=TRAIN["seq"],
         steps=steps, losses=losses, plain_first_loss=plain_loss,
         first_loss_rel_diff=first_rel, first_loss_tolerance=TRAIN_LOSS_REL,
         step_times_s=report["step_times"],
         step_ms_median_3_8=round(step_ms, 3),
         tokens_per_s=round(report["tokens_per_s"], 1),
         peak_memory_gb=round(report["peak_memory_bytes"] / 1e9, 3),
         flash_vjp_ms_one_call=round(vjp_ms, 4),
         flash_vjp_share_of_step_estimate=round(layers * vjp_ms / step_ms, 4),
         counts=counts, off_path_launches=off_path)
    return counts, {k: report[k] for k in ("step_s", "peak_memory_bytes")}


def phase_train_restart(dev) -> None:
    """train_restart: the supervised restart at full width cut to 2
    layers, each run from the same weights drawn on the card: 8 steps with
    a checkpoint every 4, clean and with a failure injected before step 6;
    one restart, and the final loss equal to the clean run's within the
    reference test's rel 1e-4."""
    import shutil
    import tempfile
    from repro_torch.configs import base as cb
    from repro_torch.launch import train
    cb.load_all()
    cb.register(dataclasses.replace(cb.get_config(GRANITE), name=GRANITE_2L,
                                    num_layers=2))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for what, fail_at in (("clean", None), ("fail", RESTART_FAIL_AT)):
            ckpt_dir = os.path.join(tmp, what)
            runs[what] = train.run(
                GRANITE_2L, device=dev, ckpt_dir=ckpt_dir, fail_at=fail_at,
                init_params=_drawn_params(cb.get_config(GRANITE_2L), dev),
                **RESTART)
            shutil.rmtree(ckpt_dir)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    clean, failed = runs["clean"], runs["fail"]
    check(failed["restarts"] == 1 and clean["restarts"] == 0,
          f"restarts {clean['restarts']} / {failed['restarts']}")
    check(failed["final_step"] == clean["final_step"] == RESTART["steps"],
          "the restarted run did not finish")
    rel = abs(failed["losses"][-1] - clean["losses"][-1]) / abs(
        clean["losses"][-1])
    check(rel <= 1e-4, f"restarted final loss {failed['losses'][-1]} "
                       f"against the clean run's {clean['losses'][-1]}")
    replayed = RESTART["steps"] - RESTART_FAIL_AT // RESTART[
        "ckpt_every"] * RESTART["ckpt_every"]
    emit("train_restart", arch=GRANITE_2L, reduced={"num_layers": [40, 2]},
         steps=RESTART["steps"], ckpt_every=RESTART["ckpt_every"],
         fail_at=RESTART_FAIL_AT, restarts=failed["restarts"],
         steps_run=[clean["steps_run"], failed["steps_run"]],
         clean_losses=clean["losses"], failed_losses=failed["losses"],
         final_rel_diff=rel,
         bit_equal=failed["losses"][-1] == clean["losses"][-1],
         replayed_steps=replayed,
         bit_equal_replayed=failed["losses"][-replayed:] ==
         clean["losses"][-replayed:])


def phase_train(dev, card: str) -> tuple[dict, dict]:
    """The training slice: the Functions' gradients, then granite's
    training (its main path: the counts and step summary it returns) and
    the supervised restart."""
    t0 = time.perf_counter()
    phase_train_grads(dev)
    torch.cuda.empty_cache()
    counts, train = phase_train_granite(dev, card)
    torch.cuda.empty_cache()
    phase_train_restart(dev)
    emit("train_path", seconds=round(time.perf_counter() - t0, 3))
    return counts, train


# ---------------------------------------------------------------------------
# the substrate slice: the dry run and its counter on the card, the
# examples, the bench runner and the perf gate
# ---------------------------------------------------------------------------

KERNELS = ("window_grid", "window_cell", "flash_attention",
           "decode_attention", "moe_gmm", "moe_gmm_skip", "rglru_scan",
           "rwkv6_scan")
# the totals the dry run's estimate and the counted card step must share
# (`by_op` names ops, which the devices may lower under other names)
COUNT_TOTALS = ("flops", "flops_total", "bytes", "bytes_read",
                "bytes_written", "kernel_bytes", "ops", "kernels")
# the examples on the card, each with the arguments it runs with besides
# --device cuda; train_lm's --tiny run takes 30 steps, not 300
EXAMPLES = (("paper_repro", ()), ("serve_models", ()),
            ("serve_multitenant", ()), ("serve_online", ()),
            ("serve_faulty", ()), ("quickstart", ()),
            ("train_lm", ("--tiny", "--steps", "30")))


def _wrappers() -> dict:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import window_distance as wd
    return {**_train_wrappers(), "window_grid": wd.window_grid,
            "window_cell": wd.window_cell,
            "decode_attention": da.decode_attention,
            "moe_gmm_skip": gmm.moe_gmm_skip}


@contextlib.contextmanager
def kernel_launches(out: dict):
    """Every kernel's launches while the block runs, from 0, into `out`
    (and the window kernel's routes into out["window_routes"])."""
    fns = _wrappers()
    for fn in fns.values():
        fn.launches = 0
    wroutes = {n: dict(fns[n].routes) for n in ("window_grid",
                                                "window_cell")}
    yield out
    out.update({n: fns[n].launches for n in KERNELS})
    out["window_routes"] = {n: {r: fns[n].routes[r] - wroutes[n][r]
                                for r in wroutes[n]} for n in wroutes}


def dryrun_sweep_on_host() -> dict:
    """All 32 cells of `configs.base.cells()` through `launch.dryrun` on
    the meta device, in a host worker process while the card runs the
    other phases: each cell's record (what `run_cell` writes) and the
    seconds the sweep took."""
    import tempfile
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    from repro_torch.configs import base as cb
    from repro_torch.launch import dryrun
    cb.load_all()
    t0, out = time.perf_counter(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in cb.cells():
            out[f"{arch}_{shape}_1"] = dryrun.run_cell(arch, shape, tmp)
    return {"cells": out, "seconds": time.perf_counter() - t0}


def phase_dryrun_sweep(sweep, work_dir: str) -> None:
    """dryrun_sweep: the host worker's 32 cells, one line each (FLOPs by
    dtype class, bytes, the roofline terms at the H100's rates, the
    one-card budget and whether it fits, the kernels charged), written
    where the bench runner's `roofline_table` reads them, and the table."""
    from repro_torch.bench import roofline_table
    from repro_torch.configs import base as cb
    t0 = time.perf_counter()
    got = sweep.result()
    waited_s = time.perf_counter() - t0
    cells = got["cells"]
    check(len(cells) == 32 and set(cells) == {
        f"{a}_{s}_1" for a, s in cb.cells()}, f"dry-run cells {set(cells)}")
    out_dir = os.path.join(work_dir, roofline_table.DRYRUN_DIR)
    os.makedirs(out_dir)
    for name, r in cells.items():
        check(r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
              and r["kernels"], f"dry run {name}: {r}")
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(r, f)
        rf = r["roofline"]
        emit("dryrun_cell", arch=r["arch"], shape=r["shape"], kind=r["kind"],
             flops_by_class=r["flops_by_class"],
             bytes=r["bytes_per_device"], ops=r["ops"],
             kernels={k: v["calls"] for k, v in r["kernels"].items()},
             compute_s=rf["compute_s"], memory_s=rf["memory_s"],
             dominant=rf["dominant"],
             budget_gb=round(r["memory"]["hbm_budget"]["total"] / 1e9, 3),
             fits_hbm=r["memory"]["fits_hbm"], trace_s=r["trace_s"])
    rows = roofline_table.run(out_dir)
    check(len(rows) == 33, f"roofline table rows {len(rows)}")
    emit("dryrun_sweep", cells=len(cells), host_s=round(got["seconds"], 3),
         waited_s=round(waited_s, 3), where="host process, meta device",
         roofline_table=rows)


def phase_dryrun_vs_card(dev, card: str, train: dict, launches: dict
                         ) -> None:
    """dryrun_vs_card, the slice's gate: granite-3-2b at train_granite's
    shape (batch 4 x 1,024, 40 layers, remat full, the dry run's AdamW
    config, weights drawn on the card) takes one training step counted
    on the card by the dry run's counter, and its FLOPs by dtype class,
    bytes, ops and kernel charges must equal `trace_cell`'s estimate on
    the meta device (residue bound 0; ops the two devices name apart are
    printed with their counts).  Then, without gating: the estimate's
    roofline bound against train_granite's median step, the TFLOP/s of
    that step and its share of the bf16 peak from the counted FLOPs and
    from 6 N T, and the one-card budget against its peak memory."""
    from repro_torch.analysis import cost
    from repro_torch.configs import base as cb
    from repro_torch.launch import dryrun
    cb.load_all()
    cfg = cb.get_config(GRANITE)
    spec = cb.ShapeSpec("train_granite", TRAIN["seq"], TRAIN["batch"],
                        "train")
    t0 = time.perf_counter()
    est = dryrun.trace_cell(GRANITE, spec)
    meta_s = time.perf_counter() - t0
    step, _ = dryrun.build_cell(GRANITE, spec, dev)
    torch.cuda.synchronize()
    with kernel_launches(launches):
        t0 = time.perf_counter()
        with cost.CostCounter(device=dev.type) as c:
            step()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    del step
    torch.cuda.empty_cache()
    got, want = c.result(), est["count"]
    residue = {op: {"card": got["by_op"].get(op), "meta": want[
        "by_op"].get(op)} for op in set(got["by_op"]) | set(want["by_op"])
        if got["by_op"].get(op) != want["by_op"].get(op)}
    differ = [k for k in COUNT_TOTALS if got[k] != want[k]]
    check(not differ, f"dryrun_vs_card: the counted card step differs from "
                      f"the meta estimate in {differ}: card "
                      f"{ {k: got[k] for k in differ} }, meta "
                      f"{ {k: want[k] for k in differ} }, by op {residue}")
    check(launches["flash_attention"] == 2 * cfg.num_layers,
          f"the counted step's flash launches {launches}")
    step_s = train["step_s"]
    terms = cost.roofline_terms(want["flops"], want["bytes"])
    n, tokens = cfg.param_count(), TRAIN["batch"] * TRAIN["seq"]
    budget = dryrun.hbm_budget(GRANITE, spec, chips=1)
    emit("dryrun_vs_card", arch=GRANITE, card=card, shape=dataclasses.asdict(
        spec), layers_traced=est["layers_traced"], meta_trace_s=round(
        meta_s, 3), card_step_s=round(card_s, 3), match=True,
        residue_bound=0, flops_by_class=want["flops"],
        flops=want["flops_total"], bytes=want["bytes"], ops=want["ops"],
        kernels=want["kernels"], ops_named_apart=residue,
        estimate_compute_ms=1e3 * terms["compute_s"],
        estimate_memory_ms=1e3 * terms["memory_s"],
        estimate_bound_ms=1e3 * max(terms["compute_s"], terms["memory_s"]),
        train_granite_step_ms=1e3 * step_s,
        tflops_counted=want["flops_total"] / step_s / 1e12,
        bf16_peak_share_counted=want["flops_total"] / step_s
        / BF16_FLOPS_PER_S,
        flops_6nt=6 * n * tokens,
        tflops_6nt=6 * n * tokens / step_s / 1e12,
        bf16_peak_share_6nt=6 * n * tokens / step_s / BF16_FLOPS_PER_S,
        hbm_budget_gb={k: round(v / 1e9, 3) for k, v in budget.items()},
        peak_memory_gb=train["peak_memory_bytes"] / 1e9,
        launches=launches)


def _paper_anchors(lines: list[str]) -> dict:
    """paper_repro's anchor lines: fig4 minver's F speedup, fig5's
    classes, fig6's s2 average at 50 cycles, fig7's 4-slot line."""
    fig4 = [l.split(",") for l in lines if l.startswith("  minver,")][0]
    fig5 = [l for l in lines if l.startswith("  # classes")][0]
    fig6 = [l for l in lines if l.startswith("  AVERAGE,s2,50,")][0]
    fig7 = [l for l in lines if l.startswith("  # 4slot@20K")][0]
    return {"fig4": f"minver_speedup_F={fig4[6]} (paper 27.5)",
            "fig5": fig5[4:], "fig6": f"avg_s2@50c={fig6.split(',')[-1]} "
                                      f"(paper ~0.71)", "fig7": fig7[4:]}


def phase_examples(dev, launches: dict) -> None:
    """examples: each of the port's examples through its `main` with
    --device cuda (the smoke-config rule: granite's and llama4's smoke
    configs with head dim 64), its seconds and every kernel's launches:
    paper_repro's anchor lines equal the derived anchors, the serve
    examples run to their end (serve_faulty's crash-restart bit for bit),
    every window launch takes the bitset route, the model examples
    launch their attention kernels."""
    import importlib
    import io
    out = {}
    for name, extra in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf, counts = io.StringIO(), {}
        with kernel_launches(counts), contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            mod.main(["--device", dev.type, *extra])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        routes = counts.pop("window_routes")
        for n in ("window_grid", "window_cell"):
            check(routes[n]["generic"] == 0, f"{name}: {n} routes {routes}")
        row = {"seconds": round(secs, 3), "lines": len(lines),
               "first_line": lines[0], "last_line": lines[-1],
               "launches": counts}
        if name == "paper_repro":
            got = _paper_anchors(lines)
            for fig, want in ANCHORS.items():
                if fig in got:
                    for part in (want if isinstance(want, tuple)
                                 else (want,)):
                        check(part in got[fig],
                              f"paper_repro {fig}: {got[fig]}")
            row["anchors"] = got
            check(counts["window_grid"] > 0, f"{name}: {counts}")
        elif name.startswith("serve_"):
            check(counts["window_grid"] + counts["window_cell"] > 0,
                  f"{name}: {counts}")
            if name != "serve_models":
                check(lines[0].startswith(
                    f"# config llama4-maverick-400b-a17b-smoke on "
                    f"{dev.type}:") and "head_dim=64" in lines[0], lines[0])
        else:
            check(lines[0].startswith(f"# config granite-3-2b-smoke on "
                                      f"{dev.type}:")
                  and "head_dim=64" in lines[0], lines[0])
            check(counts["flash_attention"] > 0, f"{name}: {counts}")
        if name in ("serve_multitenant", "serve_online", "quickstart"):
            check(counts["decode_attention"] > 0, f"{name}: {counts}")
        out[name] = row
        emit(f"example_{name}", **row)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    emit("examples", seconds=round(sum(r["seconds"] for r in out.values()),
                                   3), launches=launches)


def phase_bench_runner(dev, card: str, work_dir: str,
                       launches: dict) -> None:
    """bench_runner: `python -m repro_torch.bench --list`, then two
    `--only` runs with `--record` (fig4 and fig5; the roofline table of
    the dry-run sweep's records and fig6) into one merged record, every
    entry with the provenance `nvidia-smi` gives; then `perf_gate` of the
    record against itself (passes) and against a copy with fig6's entry
    2x slower (fails)."""
    import io
    from repro_torch.bench import BENCHES, perf_gate
    from repro_torch.bench import __main__ as runner
    here = os.getcwd()
    os.chdir(work_dir)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runner.main(["--list"])
        check(buf.getvalue().split() == list(BENCHES),
              f"--list printed {buf.getvalue()!r}")
        with kernel_launches(launches), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            runner.main(["--device", dev.type, "--only", "fig4,fig5",
                         "--record"])
            runner.main(["--device", dev.type, "--only", "roofline,fig6",
                         "--record"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches.pop("window_routes")
        path = os.path.join(work_dir, runner.RECORD)
        with open(path) as f:
            rec = json.load(f)
        res = rec["results"]
        check(set(res) == {"fig4_extensions", "fig5_classification",
                           "roofline_table", "fig6_single"},
              f"merged record {sorted(res)}")
        for name, entry in res.items():
            check(entry["backend"] == dev.type
                  and entry.get("nvidia_smi") == card
                  and entry["us_per_call"] > 0, f"{name}: {entry}")
        check(res["roofline_table"]["derived"] ==
              "32 dry-run cells tabulated", res["roofline_table"]["derived"])
        check(res["fig4_extensions"]["derived"] == ANCHORS["fig4"]
              and res["fig6_single"]["derived"] == ANCHORS["fig6"],
              f"anchors {res}")
        slow = os.path.join(work_dir, "slow.json")
        res["fig6_single"]["us_per_call"] *= 2
        with open(slow, "w") as f:
            json.dump(rec, f)
        gate = {}
        for what, current in (("self", path), ("fig6 2x", slow)):
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()) as err:
                gate[what] = perf_gate.main(["--baseline", path,
                                             "--current", current,
                                             "--min-us", "0"])
            if what != "self":
                check("fig6_single slowed 2.00x" in err.getvalue(),
                      err.getvalue())
        check(gate == {"self": 0, "fig6 2x": 1}, f"perf gate {gate}")
    finally:
        os.chdir(here)
    emit("bench_runner", seconds=round(secs, 3), listed=len(BENCHES),
         recorded={n: {k: e.get(k) for k in ("us_per_call", "derived",
                                              "nvidia_smi")}
                   for n, e in res.items()},
         gate_exit_codes=gate, launches=launches)


def phase_substrate(dev, card: str, train: dict, sweep) -> dict:
    """The substrate slice, each path's kernel launches counted from 0:
    the dry-run sweep (host), dryrun_vs_card, the examples and the bench
    runner.  Returns every kernel's launches on the slice."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_substrate_")
    paths = {"dryrun_vs_card": {}, "examples": {}, "bench_runner": {}}
    try:
        phase_dryrun_sweep(sweep, work_dir)
        phase_dryrun_vs_card(dev, card, train, paths["dryrun_vs_card"])
        torch.cuda.empty_cache()
        phase_examples(dev, paths["examples"])
        torch.cuda.empty_cache()
        phase_bench_runner(dev, card, work_dir, paths["bench_runner"])
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    for p in paths.values():
        p.pop("window_routes", None)
    total = {n: sum(p.get(n, 0) for p in paths.values()) for n in KERNELS}
    emit("substrate_path", launches=total, by_path=paths,
         seconds=round(time.perf_counter() - t0, 3))
    return total


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of another commit (the parent) whose "
                         "window kernel is timed beside this one's")
    opts = ap.parse_args()
    load_port()
    card = phase_device()
    # the plain results of the window kernel's first check are computed
    # by host processes while the card runs the simulator and sched slices
    cases = kernel_vs_plain_cases()
    pool = ProcessPoolExecutor(PLAIN_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        # the zoo's mix table first: it is counted on the host too
        mix = pool.submit(mix_table_on_host)
        run(opts, card, cases, start_plain(pool, cases), mix, pool)
    finally:
        pool.shutdown(cancel_futures=True)


def run(opts, card: str, cases: list, plain: list, mix, pool) -> None:
    from repro_torch.kernels import window_distance as wd
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_build()
    parent = None if opts.parent is None else load_parent_window(opts.parent)
    errs = {"window_grid": 0, "window_cell": 0}

    # the main path: counts from 0, read right after it
    for fn in (wd.window_grid, wd.window_cell):
        fn.launches = 0
        fn.routes = dict.fromkeys(wd.ROUTES, 0)
    splits = {"fig7": phase_fig7(dev, errs)}
    phase_fleet_sweep(dev, errs)
    splits["serve"] = phase_serve(dev, errs)
    phase_benches(dev)
    launches = {"window_grid": wd.window_grid.launches,
                "window_cell": wd.window_cell.launches}
    routes = {"window_grid": dict(wd.window_grid.routes),
              "window_cell": dict(wd.window_cell.routes)}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
        check(routes[name] == {"bitset": n, "generic": 0},
              f"{name}'s main-path routes {routes[name]}")
    emit("main_path", launches=launches, routes=routes)

    times = phase_timing(dev, errs, splits, parent)
    for name, err in errs.items():
        check(err == 0, f"{name} differs from its plain version by {err}")
    replaces = {"window_grid": "src/repro/kernels/window_distance.py:325",
                "window_cell": "src/repro/kernels/window_distance.py:438"}
    row_keys = ("device_ms", "profiler_records_kept", "slowest_cell_trips",
                "slowest_cell_passes", "ns_per_pass", "parent")
    kernels = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window_distance.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"], "library_ms": None,
        "match": True, "shape": times[name]["shape"],
        "routes": routes[name],
        **{k: times[name][k] for k in row_keys if k in times[name]},
        **({"fleet": times["window_grid_fleet"]}
           if name == "window_grid" else {})}
        for name in ("window_grid", "window_cell")]

    # the sched slice; its main path is the 1,000-tenant fleet loop
    # (`sched_fleet_scale`).  Each phase counts the window launches from 0
    # and must launch the kernel, every launch on the bitset route; the
    # window rows add them to the simulator's
    sched, late_errs = {}, {"window_grid": 0, "window_cell": 0}
    phase_sched_placement(dev, sched)
    phase_sched_online(dev, sched)
    phase_sched_fleet_scale(dev, sched, late_errs)
    phase_sched_engine(dev, sched)
    emit("sched_path", phases=sched)
    # the seeded small grids and cells, their plain results from the host
    phase_kernel_vs_plain(dev, late_errs, cases, plain)
    # the dry run's 32 cells, counted on the host once the plain results
    # are in, while the card runs the phases up to the substrate slice
    sweep = pool.submit(dryrun_sweep_on_host)
    for row in kernels:
        name = row["name"]
        check(late_errs[name] == 0, f"{name} differs from its plain "
                                    f"version by {late_errs[name]}")
        row["max_abs_err"] = max(row["max_abs_err"], late_errs[name])
        n = sum(ph["launches"][name] for ph in sched.values())
        row["launches_by_slice"] = {"simulator": row["launches"], "sched": n}
        row["launches"] += n
        row["routes"] = {r: row["routes"][r] + sum(
            ph["routes"][name][r] for ph in sched.values())
            for r in wd.ROUTES}

    # the workloads slice: the mix table (counted on the host meanwhile),
    # model_serve_study and perf_sweep; their window launches join the
    # window rows
    t_new = time.perf_counter()
    phase_workloads_mix(mix)
    new = {}
    phase_model_serve_study(dev, new)
    phase_perf_sweep(dev, new)
    emit("workloads_path", phases=new,
         seconds=round(time.perf_counter() - t_new, 3))
    for row in kernels:
        name = row["name"]
        for slice_, ph in (("workloads", "model_serve_study"),
                           ("perf_sweep", "perf_sweep")):
            n = new[ph]["launches"][name]
            row["launches_by_slice"][slice_] = n
            row["launches"] += n
            row["routes"] = {r: row["routes"][r] + new[ph]["routes"][name][r]
                             for r in wd.ROUTES}

    # the dense-model slice
    attn_errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    phase_attention_vs_plain(dev, attn_errs)
    phase_attention_accuracy(dev)
    phase_model_jax_anchor(dev)
    phase_model_consistency(dev)
    torch.cuda.empty_cache()
    attn_launches = phase_model_serve(dev)    # its main path, counted
    torch.cuda.empty_cache()
    attn_times = phase_time_attention(dev, attn_errs)
    phase_serve_profile(dev)
    torch.cuda.empty_cache()          # granite's weights are gone

    # the MoE slice
    from repro_torch.models import transformer
    moe_errs = {"moe_gmm": 0.0, "moe_gmm_skip": 0.0}
    phase_moe_jax_anchor(dev)
    torch.cuda.empty_cache()
    cfg = register_arctic_2l()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    layer0 = tuple(params["segments"][0][0]["moe"][k][0]
                   for k in ("wg", "wi", "wo"))
    phase_moe_gmm_vs_plain(dev, moe_errs, layer0)
    moe_times = phase_time_moe(dev, moe_errs, layer0)
    phase_moe_model_consistency(dev, cfg, params)
    phase_slot_engine(dev, cfg, params)
    profile_serving(dev, cfg, params, "serve_profile_moe")
    del params, layer0
    torch.cuda.empty_cache()
    moe_launches, moe_routes = phase_moe_serve(dev)   # its main path
    kernels += [{
        "name": name, "route": "cuda", "source": MOE_SOURCE,
        "replaces": MOE_REPLACES[name], "launches": moe_launches[name],
        "max_abs_err": moe_errs[name], "ms": moe_times[name]["ms"],
        "plain_ms": moe_times[name]["plain_ms"],
        "bound_ms": moe_times[name]["bound_ms"],
        "bound_by": moe_times[name]["bound_by"],
        "library_ms": moe_times[name]["library_ms"],
        "device_ms": moe_times[name]["device_ms"],
        "library_device_ms": moe_times[name]["library_device_ms"],
        "match": True, "shape": moe_times[name]["shape"],
        "routes": moe_routes[name],
        **{k: moe_times[name][k] for k in ("capacities", "live")
           if k in moe_times[name]}}
        for name in ("moe_gmm", "moe_gmm_skip")]
    torch.cuda.empty_cache()          # arctic's weights are gone

    # the recurrent slice
    rec_kernels, attn256 = phase_recurrent(dev, attn_errs)
    kernels[2:2] = [{
        "name": name, "route": "cuda", "source": ATTN_SOURCES[name],
        "replaces": ATTN_REPLACES[name], "launches": attn_launches[name],
        "max_abs_err": attn_errs[name], "ms": attn_times[name]["ms"],
        "plain_ms": attn_times[name]["plain_ms"],
        "bound_ms": attn_times[name]["bound_ms"],
        "bound_by": attn_times[name]["bound_by"],
        "library_ms": attn_times[name]["library_ms"],
        "device_ms": attn_times[name]["device_ms"],
        "library_device_ms": attn_times[name]["library_device_ms"],
        "match": True, "shape": attn_times[name]["shape"],
        **({"prompts": attn_times[name]["prompts"]}
           if "prompts" in attn_times[name] else {}),
        "d256": attn256[name]}
        for name in ("flash_attention", "decode_attention")]
    kernels += rec_kernels
    torch.cuda.empty_cache()

    # the training slice: the four kernels on its path, their launches and
    # their plain backwards on granite's training run
    train_counts, train = phase_train(dev, card)
    for row in kernels:
        if row["name"] in train_counts:
            row["train_launches"] = train_counts[row["name"]]["launches"]
            row["train_backward_recomputes"] = \
                train_counts[row["name"]]["backward_recomputes"]
    torch.cuda.empty_cache()

    # the substrate slice: the dry run against a counted card step, the
    # examples and the bench runner; their launches join every row
    substrate = phase_substrate(dev, card, train, sweep)
    for row in kernels:
        by_slice = row.setdefault("launches_by_slice",
                                  {"model slices": row["launches"]})
        by_slice["substrate"] = substrate[row["name"]]
        row["launches"] += substrate[row["name"]]
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
