"""Serving engine, model half: PyTorch port of `repro.serve.engine`'s
`model_batcher` and slot-aware multi-tenant engine.

`model_batcher` wires a `ContinuousBatcher` to a model: a queued request
claims a free row of the fixed-width decode batch, its prompt is
prefilled alone (on the card the flash kernel, and `moe_gmm`,
`rglru_scan` or `rwkv6_scan` as the arch has them) and its (1, T) cache
is copied into the row of the shared cache: the K/V prefix of a global
attention cache, the whole row of a window cache or a recurrent state;
every step then decodes one token for all rows (the decode kernel, and
`moe_gmm_skip` or the scans, on the card).

`SlotServeEngine` is the paper's §VI-C at the serving level (DESIGN.md
§2): tenants are processes; each tenant's routing distribution is its
instruction mix; per-shard expert slots are the reconfigurable regions;
the round-robin token quantum is FreeRTOS's timer quantum.  Per decode
step the engine:

  1. picks the active tenant (round-robin, `quantum_tokens` per turn);
  2. runs `decode_step` on that tenant's batch, writing its cache in place
     (the JAX engine's jitted step donates the cache instead);
  3. feeds the per-layer expert-load vectors into each model-shard's
     block-LRU disambiguator (`repro_torch.core.expert_slots`, on the
     host: one copy of the loads a step) — misses are slot fills costed
     at bytes/bandwidth;
  4. optionally computes a *slot-hit routing* bias from the resident sets
     (the beyond-paper knob): +hit_bias on resident experts' logits.

Not here yet: `estimate_fleet_contention` and the engine's
`fleet_contention`, `plan_coresidency`, `serve_online` and
`apply_admission`, which need `repro.sched`, come with the port of that
package.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import expert_slots as es
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.batching import ContinuousBatcher

__all__ = ["model_batcher", "Tenant", "EngineConfig", "SlotServeEngine"]


def model_batcher(cfg, params, batch_size: int, max_len: int, shd=None,
                  device="cuda", use_kernel=None) -> ContinuousBatcher:
    """A ContinuousBatcher wired to the real model: per-row prompt prefill
    writes the (1, T) prefill cache into the shared fixed-width decode
    cache in place; the decode callback is one `decode_step` over the
    whole batch, and the next token is the first argmax of its logits.
    `params` live on `device`."""
    transformer._no_shd(shd)
    dev = resolve_device(device)
    cache = transformer.init_cache(cfg, batch_size, max_len, dev)

    def prefill_row(row, tokens):
        t0 = len(tokens)
        _, row_cache, _ = transformer.prefill(
            cfg, params, {"tokens": np.asarray(tokens)[None, :]},
            use_kernel=use_kernel)
        for seg, row_seg in zip(cache, row_cache):
            for dst, src in zip(seg, row_seg):
                for name, d in dst.items():
                    # d: (n, B, ...) shared cache; s: (n, 1, ...) the row's:
                    # a K/V prefix where s has a t0-long time axis, else
                    # (window caches, recurrent states) the whole row
                    s = src[name]
                    if s.dim() >= 3 and s.shape[2] == t0 and \
                            d.shape[2] >= t0:
                        d[:, row, :t0] = s[:, 0]
                    else:
                        d[:, row] = s[:, 0]

    def decode(tokens, positions):
        logits, _, _ = transformer.decode_step(
            cfg, params, {"tokens": tokens, "positions": positions}, cache,
            use_kernel=use_kernel)
        return torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

    return ContinuousBatcher(batch_size, max_len, prefill_row=prefill_row,
                             decode=decode)


@dataclass
class Tenant:
    name: str
    tokens: np.ndarray            # (B, T) prompt/stream tokens
    # the tenant's "extension working set": a fixed router bias favouring
    # its preferred experts (the process binary carrying its own
    # instruction extensions, paper §IV)
    router_bias: np.ndarray | None = None
    position: int = 0
    done_tokens: int = 0
    cache: object = None


@dataclass
class EngineConfig:
    quantum_tokens: int = 32      # tokens per tenant turn (OS quantum)
    slots_per_shard: int = 4      # resident experts per model shard
    expert_shards: int = 1        # model-axis shards holding experts
    hit_bias: float = 0.0         # 0 = paper-faithful LRU (no reroute)
    fill_bandwidth: float = 50e9  # bytes/s for slot fills (PCIe-class)
    compute_s_per_token: float = 1e-3  # modelled decode compute time


class SlotServeEngine:
    """Round-robin multi-tenant decode over one model with slot-resident
    expert accounting.  `params` live on `device` (default "cuda", which
    raises without a card); each tenant's cache is made there."""

    def __init__(self, cfg, params, engine_cfg: EngineConfig,
                 tenants: list[Tenant], max_len: int = 128, shd=None,
                 device="cuda"):
        transformer._no_shd(shd)
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg
        self.tenants = tenants
        self.max_len = max_len
        self.device = resolve_device(device)
        mlp_mats = 3 if cfg.mlp in ("swiglu", "gelu_glu") else 2
        expert_bytes = mlp_mats * cfg.d_model * cfg.d_ff * 2
        e_per_shard = max(cfg.num_experts // engine_cfg.expert_shards, 1)
        self.slot_cfg = es.ExpertSlotConfig(
            num_experts=e_per_shard,
            slots_per_device=engine_cfg.slots_per_shard,
            expert_bytes=expert_bytes,
            fill_bandwidth=engine_cfg.fill_bandwidth,
            hit_bias=engine_cfg.hit_bias)
        # the slot pools are host-side bookkeeping, fed once a step
        self.shard_states = [es.init_state(self.slot_cfg, "cpu")
                             for _ in range(engine_cfg.expert_shards)]
        self.stats = {"fills": 0, "accesses": 0, "fill_seconds": 0.0,
                      "steps": 0, "per_tenant": {t.name: 0 for t in tenants}}
        for t in tenants:
            t.cache = transformer.init_cache(cfg, t.tokens.shape[0], max_len,
                                             self.device)

    # ------------------------------------------------------------------
    def _router_bias(self, tenant: Tenant):
        if not self.cfg.is_moe:
            return None
        bias = np.zeros((self.cfg.num_experts,), np.float32)
        if tenant.router_bias is not None:
            bias += tenant.router_bias
        if self.ecfg.hit_bias != 0.0:
            e_per = self.slot_cfg.num_experts
            for s, st in enumerate(self.shard_states):
                res = st.resident.numpy()
                bias[s * e_per:(s + 1) * e_per] += res * self.ecfg.hit_bias
        if not bias.any():
            return None
        return bias

    def _account(self, loads: np.ndarray):
        """Feed per-layer global expert loads, (moe layers, E), into the
        shard slot pools, layer by layer (each MoE layer's slot pool is
        the same physical pool here; finer per-layer pools are a knob)."""
        e_per = self.slot_cfg.num_experts
        for load in loads:
            for s in range(self.ecfg.expert_shards):
                ids = np.nonzero(load[s * e_per:(s + 1) * e_per])[0]
                if len(ids) == 0:
                    continue
                st, stats = es.access_block(
                    self.shard_states[s],
                    torch.as_tensor(ids, dtype=torch.int32), self.slot_cfg)
                self.shard_states[s] = st
                self.stats["fills"] += int(stats.misses)
                self.stats["accesses"] += int(stats.accessed)
                self.stats["fill_seconds"] += float(stats.fill_seconds)

    def _decode_once(self, tenant: Tenant):
        b = tenant.tokens.shape[0]
        pos = min(tenant.position, self.max_len - 1)
        batch = {"positions": np.full((b,), pos, np.int32)}
        if self.cfg.embed_inputs:
            batch["tokens"] = tenant.tokens[:, pos % tenant.tokens.shape[1]][
                :, None]
        else:
            batch["embeds"] = torch.zeros((b, 1, self.cfg.d_model),
                                          dtype=self.cfg.torch_dtype,
                                          device=self.device)
        rb = self._router_bias(tenant)
        if rb is not None:
            batch["router_bias"] = rb
        _, cache, aux = transformer.decode_step(
            self.cfg, self.params, batch, tenant.cache)
        tenant.cache = cache
        tenant.position += 1
        tenant.done_tokens += b
        loads = [a["expert_load"] for seg in aux for a in seg
                 if "expert_load" in a]
        if loads:   # one copy to the host for every layer of the step
            self._account(torch.cat(loads).cpu().numpy())

    # ------------------------------------------------------------------
    def run(self, total_steps: int) -> dict:
        if not self.tenants:
            raise ValueError("engine has no tenants — nothing to serve")
        ti = 0
        quantum_left = self.ecfg.quantum_tokens
        for _ in range(total_steps):
            tenant = self.tenants[ti]
            self._decode_once(tenant)
            self.stats["steps"] += 1
            self.stats["per_tenant"][tenant.name] += 1
            quantum_left -= tenant.tokens.shape[0]
            if quantum_left <= 0:
                ti = (ti + 1) % len(self.tenants)
                quantum_left = self.ecfg.quantum_tokens
        s = self.stats
        hit_rate = (1.0 - s["fills"] / s["accesses"]
                    if s["accesses"] else 1.0)
        compute_s = s["steps"] * self.ecfg.compute_s_per_token
        return {
            **s,
            "hit_rate": hit_rate,
            "modelled_compute_s": compute_s,
            "overhead_frac": s["fill_seconds"] /
            max(compute_s + s["fill_seconds"], 1e-12),
        }
