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

The sched half asks the core fleet simulator which tenants should share
a core: `estimate_fleet_contention` predicts each tenant's contention
slowdown through the same `simulate_many`/`sweep_fleet` machinery as the
Fig. 7 numbers (the window kernel's `window_grid` on the card);
`SlotServeEngine.fleet_contention` asks it for the engine's tenants,
`plan_coresidency` admits or defers them at a slowdown SLO
(`repro_torch.sched.AdmissionController`), `serve_online` serves a churn
workload, with an optional fault storm, through
`repro_torch.sched.OnlineReplacer` (every seedable epoch resumed through
`window_cell`), and `apply_admission` keeps one core's residents,
parking the rest in `deferred`.  Tenant profiles are Embench bench names
or model-zoo "<arch>:<phase>" workloads (`repro_torch.workloads`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import expert_slots as es
from repro_torch.core import isa, simulator
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve import step as serve_step
from repro_torch.serve.batching import ContinuousBatcher

__all__ = ["model_batcher", "Tenant", "EngineConfig", "SlotServeEngine",
           "estimate_fleet_contention"]


def model_batcher(cfg, params, batch_size: int, max_len: int, shd=None,
                  device="cuda", use_kernel=None) -> ContinuousBatcher:
    """A ContinuousBatcher wired to the real model: per-row prompt prefill
    writes the (1, T) prefill cache into the shared fixed-width decode
    cache in place; the decode callback is one `decode_step` over the
    whole batch, and the next token is the first argmax of its logits.
    `params` live on `device`; both callbacks run under
    `torch.no_grad()`.

    Under a `ShardingPlan` (`shd`, every rank of its mesh calling with
    the same requests) `params` hold this rank's blocks
    (`shd.shard_params`), and the steps are `serve.step`'s under the
    plan's prefill and decode layouts: a prompt is prefilled on every
    rank in the prefill layout, its cache put back together over `model`
    and this rank's block of it written into the shared cache, of which
    each rank holds only its block (rows over the data axes, positions
    over `model`); a decode step takes the whole batch, cut to this
    rank's rows, and the next tokens are the argmax over the
    vocab-sharded logits (the lowest index among equal maxima, as
    `torch.argmax`), gathered back over the rows.  Prompts, tokens and
    logs stay replicated."""
    plan = transformer.check_plan(shd)
    dev = resolve_device(device)
    if plan is not None:
        return _plan_batcher(cfg, params, batch_size, max_len, plan, dev,
                             use_kernel)
    cache = transformer.init_cache(cfg, batch_size, max_len, dev)

    @torch.no_grad()
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

    @torch.no_grad()
    def decode(tokens, positions):
        logits, _, _ = transformer.decode_step(
            cfg, params, {"tokens": tokens, "positions": positions}, cache,
            use_kernel=use_kernel)
        return torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

    return ContinuousBatcher(batch_size, max_len, prefill_row=prefill_row,
                             decode=decode)


def _plan_batcher(cfg, params, batch_size: int, max_len: int, plan, dev,
                  use_kernel) -> ContinuousBatcher:
    """`model_batcher` under a plan: `serve.step`'s prefill and decode
    steps under the plan's two layouts."""
    pre = dataclasses.replace(plan, mode="prefill")
    dec = dataclasses.replace(plan, mode="decode")
    prefill_step = serve_step.make_prefill(cfg, pre, use_kernel)
    decode_step = serve_step.make_decode(cfg, dec, use_kernel)
    cache = transformer.init_cache(cfg, batch_size, max_len, dev, shd=dec)
    shapes = serve_step.abstract_cache(cfg, batch_size, max_len)

    @torch.no_grad()
    def prefill_row(row, tokens):
        t0 = len(tokens)
        _, row_cache, _ = prefill_step(
            params, {"tokens": np.asarray(tokens)[None, :]})
        row_shapes = serve_step.abstract_cache(cfg, 1, t0)
        for si, (seg, row_seg) in enumerate(zip(cache, row_cache)):
            for j, (dst, src) in enumerate(zip(seg, row_seg)):
                for name, d in dst.items():
                    path = f"{si}/{j}/{name}"
                    # the row's leaf put back together as its prefill
                    # spec splits it, then this rank's block of it written
                    spec = pre.cache_spec(path, row_shapes[si][j][name].shape)
                    s = pre.relayout(src[name], spec, ())
                    _write_block(d, s[:, 0], row, dec.cache_block(
                        path, shapes[si][j][name].shape))

    @torch.no_grad()
    def decode(tokens, positions):
        logits, _, _ = decode_step(
            params, cache, {"tokens": tokens, "positions": positions})
        return _greedy(logits, dec, (batch_size, 1, cfg.vocab))

    return ContinuousBatcher(batch_size, max_len, prefill_row=prefill_row,
                             decode=decode)


def _greedy(logits, plan, shape) -> np.ndarray:
    """The first argmax over the vocabulary of every row of logits whose
    global shape is `shape` (B, 1, V), given this rank's block: each
    rank's maximum and its first index, then the block with the largest
    maximum (the lowest block among equal ones), gathered over the
    rows."""
    spec = plan.spec("logits", shape)
    x = logits[:, 0]
    idx = torch.argmax(x, dim=-1)
    if spec[2] is not None:
        val = torch.gather(x, -1, idx[:, None])[:, 0].float()
        idx = idx + plan.block(shape[2], spec[2]).start
        vals = plan.mesh.all_gather(val[None], spec[2], dim=0)
        idxs = plan.mesh.all_gather(idx[None], spec[2], dim=0)
        idx = torch.gather(idxs, 0, torch.argmax(vals, dim=0)[None])[0]
    if spec[0] is not None:
        idx = plan.mesh.all_gather(idx, spec[0], dim=0)
    return idx.cpu().numpy()


def _write_block(d, s, row: int, block: tuple) -> None:
    """Write a row's cache leaf s (n, ...) into this rank's block d (n,
    B_loc, ...) of the shared cache, which holds slice `block[k]` of
    each dimension k of the shared leaf: the part of s that falls there
    (of a full cache's time axis, the prompt's prefix)."""
    rows = block[1]
    if not rows.start <= row < rows.stop:
        return
    src, dst = [slice(None)], [slice(None), row - rows.start]
    for blk, n in zip(block[2:], s.shape[1:]):
        hi = min(blk.stop, n)
        if hi <= blk.start:
            return
        src.append(slice(blk.start, hi))
        dst.append(slice(0, hi - blk.start))
    d[tuple(dst)] = s[tuple(src)]


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
    raises without a card); each tenant's cache is made there.  Under a
    `ShardingPlan` (`shd`) `params` hold this rank's experts and each
    tenant's cache this rank's blocks; the stats and slot pools are
    replicated (every rank sees the global expert loads)."""

    def __init__(self, cfg, params, engine_cfg: EngineConfig,
                 tenants: list[Tenant], max_len: int = 128, shd=None,
                 device="cuda"):
        self.shd = transformer.check_plan(shd)
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
        self.deferred: list[Tenant] = []   # tenants parked by admission
        self.stats = {"fills": 0, "accesses": 0, "fill_seconds": 0.0,
                      "steps": 0, "per_tenant": {t.name: 0 for t in tenants}}
        for t in tenants:
            t.cache = transformer.init_cache(cfg, t.tokens.shape[0], max_len,
                                             self.device, shd=self.shd)

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

    @torch.no_grad()
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
            self.cfg, self.params, batch, tenant.cache, shd=self.shd)
        tenant.cache = cache
        tenant.position += 1
        tenant.done_tokens += b
        loads = [a["expert_load"] for seg in aux for a in seg
                 if "expert_load" in a]
        if loads:   # one copy to the host for every layer of the step
            self._account(torch.cat(loads).cpu().numpy())

    # ------------------------------------------------------------------
    def fleet_contention(self, tenant_benches: dict[str, str],
                         **kw) -> dict:
        """Slot-contention estimate for this engine's tenant set.

        `tenant_benches` maps tenant name -> instruction-mix profile
        (benchmark name).  Slot count defaults to the engine's
        `slots_per_shard` and the device to the engine's; everything else
        forwards to `estimate_fleet_contention`.
        """
        benches = [tenant_benches[t.name] for t in self.tenants]
        kw.setdefault("num_slots", self.ecfg.slots_per_shard)
        kw.setdefault("device", self.device)
        return estimate_fleet_contention(benches, **kw)

    # ------------------------------------------------------------------
    def plan_coresidency(self, tenant_benches: dict[str, str], *,
                         slo: float = 1.5, num_cores: int = 1,
                         model=None, max_rounds: int = 8,
                         slo_weights: dict[str, float] | None = None):
        """Contention-aware admission plan for this engine's tenant set.

        Instead of taking tenant order as given, ask `repro_torch.sched`
        which tenants should co-reside: tenants are placed onto
        `num_cores` model replicas minimising predicted worst-tenant slot
        contention, and any tenant whose best placement still violates the
        slowdown `slo` is deferred.  `slo_weights` (name -> positive
        weight) protects foreground tenants: deferral picks the worst
        slowdown/weight, so batch tenants absorb contention first.
        Without a `model`, one is made on the engine's device.  Returns
        the `AdmissionDecision`; use `apply_admission` to restrict this
        engine to one core's residents.
        """
        from repro_torch.sched.admission import AdmissionController
        from repro_torch.sched.placement import (ContentionModel,
                                                 PlacementConfig)

        if model is None:
            model = ContentionModel(
                PlacementConfig(num_slots=self.ecfg.slots_per_shard),
                device=self.device)
        ctrl = AdmissionController(slo=slo, num_cores=num_cores,
                                   model=model, max_rounds=max_rounds)
        return ctrl.decide({t.name: tenant_benches[t.name]
                            for t in self.tenants},
                           slo_weights=slo_weights)

    def serve_online(self, events, *, policy: str = "warm",
                     num_cores: int = 2, model=None, online_cfg=None,
                     num_epochs: int | None = None, apply_core=None,
                     faults=None, recovery: str = "warm"):
        """Serve a churn workload (tenants arriving/leaving mid-serve)
        with online re-placement — the dynamic counterpart of the static
        `plan_coresidency` flow.

        `events` is a sequence of `repro_torch.sched.TenantEvent`s; the
        epoch loop (`repro_torch.sched.online.OnlineReplacer`, on the
        engine's device) carries warm slot/bitstream state per core across
        epochs and, under the default "warm" policy, migrates a tenant
        only when the predicted contention saving beats the measured
        warm-state migration penalty.  The per-epoch advances and the
        migration probes resume `FleetState`s through the interleaved
        engine's resumable entry (`window_cell` on the card), and the
        contention model's one-shot sweeps ride its windowed entry
        (`window_grid`).  Returns the `OnlineReport`.  With
        `apply_core=<i>` the engine afterwards restricts itself to the
        tenants the final placement left on that core (deferred and
        other-core tenants are parked as `apply_admission` does).

        `faults` (a `repro_torch.sched.FaultPlan`) injects a deterministic
        fault storm into the serve; `recovery` picks the reaction
        (`repro_torch.sched.RECOVERY_POLICIES`: "warm" evacuation /
        "cold_restart" / "none") — the report's `fault_log` and
        `worst_lifetime_slowdown` quantify the outcome.  Faulted epochs
        may route segments through the reference machine: SEU- or
        flush-mutated caches are not interleaved-seedable until they
        re-warm, and degraded (masked) cores always take it.
        """
        from repro_torch.sched.online import OnlineConfig, OnlineReplacer
        from repro_torch.sched.placement import PlacementConfig

        if online_cfg is None:
            online_cfg = OnlineConfig(
                num_cores=num_cores,
                placement=PlacementConfig(
                    num_slots=self.ecfg.slots_per_shard))
        rep = OnlineReplacer(online_cfg, model=model, policy=policy,
                             faults=faults, recovery=recovery,
                             device=self.device).run(events, num_epochs)
        if apply_core is not None:
            if not 0 <= apply_core < len(rep.final_cores):
                raise ValueError(
                    f"core index {apply_core} out of range for "
                    f"{len(rep.final_cores)} cores")
            keep_names = set(rep.final_cores[apply_core])
            keep = [t for t in self.tenants if t.name in keep_names]
            self.deferred += [t for t in self.tenants
                              if t.name not in keep_names]
            self.tenants = keep
        return rep

    def apply_admission(self, decision, core: int = 0) -> list[Tenant]:
        """Keep only `core`'s admitted co-residents; park everything else.

        Deferred (and other-core) tenants move to `self.deferred` so the
        caller can serve them in a later round or on another replica.
        Returns the retained tenant list (in placement order).
        """
        keep_names: tuple[str, ...] = ()
        if decision.placement is not None:
            if not 0 <= core < len(decision.placement.cores):
                raise ValueError(
                    f"core index {core} out of range for a placement with "
                    f"{len(decision.placement.cores)} cores")
            keep_names = decision.placement.cores[core]
        by_name = {t.name: t for t in self.tenants}
        keep = [by_name[n] for n in keep_names if n in by_name]
        kept = {t.name for t in keep}
        self.deferred += [t for t in self.tenants if t.name not in kept]
        self.tenants = keep
        return keep

    # ------------------------------------------------------------------
    def run(self, total_steps: int) -> dict:
        if not self.tenants:
            raise ValueError(
                "engine has no resident tenants (all deferred by "
                "admission?) — nothing to serve")
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


def estimate_fleet_contention(benches: list[str], *, num_slots: int = 4,
                              miss_latency: int = 50,
                              quantum_cycles=20_000,
                              handler_cycles: int = 150,
                              priorities=None,
                              scenarios=None,
                              trace_len: int = 60_000,
                              total_steps: int = 160_000,
                              device="cuda") -> dict:
    """Multi-tenant slot-contention estimate from the core fleet simulator.

    Maps each tenant to an instruction-mix profile (an Embench name from
    `repro_torch.core.traces` or a model-zoo "<arch>:<phase>" workload,
    through `repro_torch.workloads.resolve_trace`) and runs the SAME
    `simulate_many` machinery that produces the paper's
    Fig. 7 numbers, on `device`: one reconfigurable core, round-robin
    quantum, slot state persisting across switches.  Per tenant it reports
    the fleet CPI, the solo (unpreempted) CPI, and their ratio — the
    contention slowdown a tenant should expect from co-residency — plus
    fleet-level switch/miss counters, equal to the reference's.

    `scenarios` may be one `SlotScenario` or a per-tenant list (tenants can
    disagree about which opcodes are slotted).  `quantum_cycles` may be a
    per-tenant vector and `priorities` a per-tenant weight tuple — the
    heterogeneous-quantum / weighted-round-robin axes of `SchedulerConfig`.
    """
    # resolve_trace: Embench names pass through to core traces bit for
    # bit; "<arch>:<phase>" names lower the model zoo (lazy import keeps
    # the serve layer importable without the model/configs stack)
    from repro_torch import workloads

    dev = resolve_device(device)
    if scenarios is None:
        scenarios = isa.SCENARIO_2
    cfg = simulator.ReconfigConfig(num_slots=num_slots,
                                   miss_latency=miss_latency)
    sched = simulator.SchedulerConfig(quantum_cycles=quantum_cycles,
                                      handler_cycles=handler_cycles,
                                      priorities=priorities)
    tr = np.stack([workloads.resolve_trace(n, trace_len) for n in benches])
    # one-shot preempted fleet with a warm bitstream cache: the dispatcher
    # serves this from the interleave-aware engine (the window kernel)
    fleet = simulator.simulate_many(tr, cfg, scenarios, sched, total_steps,
                                    device=dev)

    # solo reference: each tenant alone on the core, never preempted — both
    # branches route through `sweep_fleet`, whose dispatcher collapses these
    # warm-cache unpreempted runs into stack-distance passes (no scan)
    solo_sched = simulator.SchedulerConfig.no_preempt(handler_cycles)
    if isinstance(scenarios, (list, tuple)):
        # per-tenant taxonomies: one P=1 sweep cell per (bench, scenario)
        solo_cpis = [
            float(simulator.sweep_fleet(
                tr[i:i + 1, None, :], [miss_latency], s, solo_sched,
                slot_counts=[num_slots], total_steps=trace_len,
                device=dev).cpi.cpu().numpy()[0, 0, 0, 0])
            for i, s in enumerate(scenarios)]
    else:
        # shared taxonomy: all P solo runs as one batched sweep cell
        solo = simulator.sweep_fleet(
            tr[:, None, :], [miss_latency], scenarios, solo_sched,
            slot_counts=[num_slots], total_steps=trace_len, device=dev)
        solo_cpis = [float(c) for c in solo.cpi.cpu().numpy()[:, 0, 0, 0]]
    per_tenant = {}
    fleet_cpi = fleet.cpi.cpu().numpy()
    fleet_instrs = fleet.instructions.cpu().numpy()
    fleet_misses = fleet.slot_misses.cpu().numpy()
    for i, name in enumerate(benches):
        solo_cpi = solo_cpis[i]
        # a tenant the round-robin never reached (total_steps exhausted
        # inside earlier quanta) has no CPI — report NaN, not the
        # "zero slowdown" that a 0/instructions division would fake
        scheduled = int(fleet_instrs[i]) > 0
        cpi_i = float(fleet_cpi[i]) if scheduled else float("nan")
        per_tenant[f"{i}:{name}"] = {
            "fleet_cpi": cpi_i,
            "solo_cpi": solo_cpi,
            "contention_slowdown": cpi_i / solo_cpi,
            "slot_misses": int(fleet_misses[i]),
            "scheduled": scheduled,
        }
    return {
        "tenants": per_tenant,
        "switches": int(fleet.switches),
        "total_slot_misses": int(fleet_misses.sum()),
        "num_slots": num_slots,
        "miss_latency": miss_latency,
        "quantum_cycles": quantum_cycles,
    }
