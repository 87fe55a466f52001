"""§Perf iteration 3 — arctic-480b decode_32k, the paper-technique cell.

Baseline: dense expert streaming.  Every decode step, each of the 16
expert shards computes its 8 experts' capacity buffers through the grouped
FFN, so each device streams all resident expert weights from HBM:

    8 experts x 3 x 7168 x 4864 x 2 B  =  1.67 GB/device/step  (2.04 ms)

Change (the paper's architecture, DESIGN.md §2): per-shard expert slots
with the block-LRU disambiguator + slot-hit routing bias, and the
count-aware Pallas GMM (`moe_gmm_skip`) whose scalar-prefetch index map
skips the weight streams of empty experts.  Expert-weight traffic then
scales with (slot working set + fill traffic), not with E.

Measurement: routing dynamics are simulated with a width-reduced arctic
(exact 128-expert router dimensionality, 4 tenants with banded working
sets) through the real serving engine; the byte model then applies the
FULL config's expert_bytes.  The kernel-level skip is validated by
tests/test_kernels.py::test_moe_gmm_skip_matches_dense_on_live_experts.

PyTorch port of `benchmarks/perf_slot_decode.py`, on `device` (the
slot engine's decode steps through the port's model, and the fleet rows'
contention estimate through `window_grid`).  The fleet rows
(`fleet_rows`) equal the reference's as text.  The slot rows depend on
the model's weights: the reference draws them with
`jax.random.PRNGKey(0)`, which the port does not import, so by default
this module draws its own (`transformer.init_params` from a torch
generator seeded 0) and its slot rows are its own; pass the reference's
weights as `params` (`models.convert.params_from_numpy`) to reproduce
its slot rows exactly, as the CPU test does.  The reduced model keeps
the reference's 16-wide heads, which the card's attention kernels do not
take (64/128/256), so on a CUDA device the slot half raises at its first
attention call and only `fleet_rows` runs there; the slot engine is
driven on the card at arctic's full width by `chip_smoke.py`'s
`slot_engine` phase.  The rows are printed, not written to a file.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.engine import (EngineConfig, SlotServeEngine, Tenant,
                                      estimate_fleet_contention)

STEPS = 96
SHARDS = 16

# instruction-mix profiles backing the 4 tenants' contention estimate:
# mixed FM/M working sets, like the banded expert sets below
TENANT_PROFILES = ("nbody", "minver", "matmult-int", "cubic")


def make_tenants(cfg, n=4, batch=8, width=16):
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


def config():
    """The full arctic config, whose expert bytes the model charges, and
    the width-reduced one with the REAL router dimensionality (128
    experts) that serves."""
    cb.load_all()
    full = cb.get_config("arctic-480b")
    cfg = dataclasses.replace(
        full.smoke(), num_experts=128, top_k=2, capacity_factor=8.0)
    return full, cfg


def fleet_rows(device="cuda") -> list[str]:
    """The core-level contention estimate for the same 4-tenant mix, from
    the fleet simulator behind the Fig. 7 sweeps (serve-layer
    endpoint): a header and one row per slot count and tenant."""
    rows = ["fleet,tenant,profile,fleet_cpi,solo_cpi,slowdown"]
    for slots in (2, 4):
        est = estimate_fleet_contention(
            list(TENANT_PROFILES), num_slots=slots,
            trace_len=30_000, total_steps=80_000, device=device)
        for key, t in est["tenants"].items():
            i, prof = key.split(":", 1)
            rows.append(
                f"fleet,{slots}slot/t{i},{prof},{t['fleet_cpi']:.3f},"
                f"{t['solo_cpi']:.3f},{t['contention_slowdown']:.2f}x")
    return rows


def run(params=None, device="cuda") -> list[str]:
    """The rows; `params` (the reduced config's tree on `device`) default
    to `init_params` from a torch generator seeded 0."""
    dev = resolve_device(device)
    full, cfg = config()
    if params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    mlp_mats = 3
    expert_bytes_full = mlp_mats * full.d_model * full.d_ff * 2  # 209 MB
    e_per_shard = full.num_experts // SHARDS                      # 8

    base_bytes = e_per_shard * expert_bytes_full  # dense streaming /step
    rows = ["variant,slots,hit_bias,hit_rate,experts_live_per_step,"
            "bytes_per_step_GB,mem_term_ms,vs_base"]
    rows.append(f"base(dense-stream),-,-,-,{e_per_shard},"
                f"{base_bytes / 1e9:.2f},{base_bytes / 819e9 * 1e3:.3f},"
                f"1.00x")
    for slots in (2, 4):
        for bias in (0.0, 4.0):
            eng = SlotServeEngine(
                cfg, params,
                EngineConfig(quantum_tokens=16, slots_per_shard=slots,
                             expert_shards=SHARDS, hit_bias=bias),
                make_tenants(cfg), max_len=STEPS + 4, device=dev)
            rep = eng.run(STEPS)
            # live experts per shard-step = accesses / (steps * layers...)
            layer_steps = rep["steps"] * sum(cfg.moe_layer_mask()) * SHARDS
            live = rep["accesses"] / max(layer_steps, 1)
            # per-step traffic: live experts hit VMEM-resident slots (free
            # re-stream avoided), misses stream full expert weights
            fill_bytes = rep["fills"] / max(rep["steps"], 1) / SHARDS * \
                expert_bytes_full
            resident_bytes = min(live, slots) * expert_bytes_full
            per_step = fill_bytes + resident_bytes
            rows.append(
                f"slots,{slots},{bias},{rep['hit_rate']:.3f},{live:.2f},"
                f"{per_step / 1e9:.2f},{per_step / 819e9 * 1e3:.3f},"
                f"{base_bytes / per_step:.2f}x")

    rows += fleet_rows(dev)
    return rows


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows = run(device=device)
    for r in rows:
        print_fn(r)
    print_fn(f"# perf_slot_decode done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
