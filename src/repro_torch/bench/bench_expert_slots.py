"""Paper §IV applied to serving: slot-resident experts under multi-tenant
round-robin scheduling (the Fig. 6/7 phenomenology at the serving level).
PyTorch port of `benchmarks/bench_expert_slots.py`.

Three tenants with disjoint token distributions (= processes with distinct
instruction mixes) decode against a reduced MoE model (arctic-480b's
smoke config); per-shard expert slots are managed by the block-LRU
disambiguator.  Swept: slots/shard {2, 4, 8} (Fig. 7's slot variants),
quantum {8, 64} tokens (1K vs 20K cycles), and the beyond-paper slot-hit
routing bias.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.engine import EngineConfig, SlotServeEngine, Tenant

STEPS = 120


def make_tenants(cfg, n=3, batch=2, width=16):
    """Tenants with explicit expert working sets (router-bias bands): the
    paper's processes with distinct instruction distributions."""
    rng = np.random.default_rng(0)
    tenants = []
    e = cfg.num_experts
    band = e // n + 1
    for i in range(n):
        toks = rng.integers(0, cfg.vocab, size=(batch, width)).astype(
            np.int32)
        bias = np.full((e,), -6.0, np.float32)
        lo = (i * band) % e
        members = [(lo + j) % e for j in range(band + 1)]
        bias[members] = 6.0 + rng.normal(0, 0.5, len(members))
        tenants.append(Tenant(name=f"tenant{i}", tokens=toks,
                              router_bias=bias))
    return tenants


def run(params=None, steps: int = STEPS, device="cuda") -> list[str]:
    """The sweep's rows.  `params` (the smoke config's tree on `device`)
    defaults to `init_params` from seed 0."""
    cb.load_all()
    cfg = cb.get_config("arctic-480b").smoke()
    dev = resolve_device(device)
    if params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rows = ["slots,quantum,hit_bias,hit_rate,fills,fill_s,overhead_frac"]
    for slots in (2, 4, 8):
        for quantum in (8, 64):
            for bias in (0.0, 4.0):
                ecfg = EngineConfig(
                    quantum_tokens=quantum, slots_per_shard=slots,
                    expert_shards=1, hit_bias=bias)
                eng = SlotServeEngine(cfg, params, ecfg, make_tenants(cfg),
                                      max_len=steps + 4, device=dev)
                rep = eng.run(steps)
                rows.append(
                    f"{slots},{quantum},{bias},{rep['hit_rate']:.3f},"
                    f"{rep['fills']},{rep['fill_seconds']:.3f},"
                    f"{rep['overhead_frac']:.3f}")
    rows.append("# expectations: hit_rate grows with slots and with "
                "quantum; hit_bias trades routing fidelity for fewer fills")
    return rows


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    for row in run(device=device):
        print_fn(row)
    print_fn(f"# bench_expert_slots done in {time.time() - t0:.1f}s")
