"""Online re-placement: epoch-structured serving with warm-state-aware
tenant migration.  PyTorch port of `repro.sched.online`: the epoch loop,
the pricing, the logs and the snapshots are the reference's numpy and
Python; every simulation runs through the port's simulator on the
replacer's `device` (default "cuda"), where each core's slot and
bitstream caches stay between epochs, and results come back to the host
where the reference calls `np.asarray(...)`.  On the card every resumed
segment that can be seeded takes the interleaved engine and so the
window kernel (`window_cell`); fault-mutated and degraded cores take the
reference machine (`simulator._scan_lanes`), as in the reference.

The static placement layer (`repro_torch.sched.placement`) answers
"which tenants should co-reside" once, for a fixed roster.  Real serving
rosters churn: tenants arrive and leave mid-serve, and every
arrival/departure can turn a good placement into a bad one.  This module
serves a churn workload as a sequence of *epochs* over the resumable
fleet simulator (`repro_torch.core.simulator.FleetState`):

  * each reconfigurable core carries its disambiguator + bitstream cache
    across epochs AND across membership changes — warm state persists on
    the core, which is the paper's architectural point (§IV) and exactly
    what makes migration expensive: a tenant moved to another core leaves
    its resident slots behind;
  * each epoch the `OnlineReplacer` re-solves placement for the current
    roster through the `ContentionModel` (`place_tenants`), aligns the
    solution to the physical cores by membership overlap, and prices every
    implied move as

        net = predicted-contention-delta  -  warm-state migration penalty

    where the contention delta converts predicted slowdown changes of every
    affected tenant into cycles over the next epoch, and the migration
    penalty is *measured*, not modelled: the mover's state is resumed for a
    probe window twice — once on its current (warm) core and once on a cold
    core — and the penalty is the cycle difference (LUTstructions'
    re-loading cost as a first-class quantity);
  * policy "warm" applies only net-positive moves; the baselines are
    "never" (arrival placement is final) and "always" (apply every move the
    re-solve implies, blind to migration cost).

`repro_torch.bench.online_churn` shows warm-aware re-placement matching
or beating never-migrate on worst-tenant slowdown while migrating less
than always-rebalance; `repro_torch.serve.engine.SlotServeEngine.serve_online`
wires the loop into the serving layer.

Cost structure per epoch: every simulation the loop issues now rides the
interleave-aware stack-distance engine
(`repro_torch.core.stackdist_interleaved`).  The re-solve and every move's
contention-delta pricing go through the `ContentionModel`'s one-shot
preempted sweeps; the epoch *advance* and the migration-penalty probes
resume explicit `FleetState`s and ride the engine's *resumable* entry
(`simulate_many(..., state=S, return_state=True)` seeds the engine from S
and materialises S' back out, bit-for-bit equal to the scan).  The
cycle-by-cycle scan only returns for caches no scan could have produced
or cold bitstream caches — in a fault-free serve, neither occurs.

Topology & fleet scale (`repro_torch.sched.topology`): the fleet is a
`Topology` (cores within sockets within hosts, default
`Topology.flat(num_cores)` — the historical single-board pool).  Two
things tier by it:

  * **migration pricing** — `migration_penalty(name, dst)` adds the
    LUTstructions re-load surcharge on top of the measured warm-resume
    probe when the move crosses a socket or a host
    (`resident bitstreams x bs_miss_extra x tier multiplier`); within a
    socket the measured probe alone is the price, exactly as before;
  * **the per-epoch re-solve** — each *host* is a placement domain
    solved independently (`place_tenants` over the host's up cores), so
    the swap frontier is O(T_h^2) per host instead of O(T^2) over the
    fleet.  The re-solve is *incremental* by default: a domain's solved
    target assignment is cached, and only domains dirtied since the
    last epoch (arrivals, departures, applied moves, evacuations,
    faults, repairs) are re-solved — a quiet epoch at 1000 tenants
    re-prices nothing.  `resolve_mode="full"` re-solves every domain
    every epoch; both modes are bit-for-bit identical (the cache is
    pure memoisation of a deterministic solve — asserted across the
    churn/chaos streams by tests/test_fleet_scale.py and at fleet scale
    by `repro_torch.bench.fleet_scale_study`), and `resolve_log` records
    per-epoch solved/cached domain counts and wall time.

Fault tolerance (`repro_torch.sched.faults`): a seeded `FaultPlan` injects
epoch-aligned core losses, slot SEUs, bitstream flushes and reconfig
stalls.  The replacer detects each fault at its epoch, evacuates tenants
off lost cores as *mandatory* moves (priced for destination choice only,
never gated on net benefit; destinations under a reconfig stall are
retried with capped exponential backoff), prices degraded cores at their
reduced slot width through `ContentionModel.predict(num_slots=...)`, and
emits a structured fault log into the extended `OnlineReport`.  Cache
damage (SEU/flush) routes the next resumed segment through the scan
(the mutated state is not interleaved-seedable) until the caches
re-warm; degraded cores ride the scan with `num_active` masking until
repaired at full width.  `snapshot()`/`restore()` capture the complete
host-side serving state so a crashed serve restarts mid-trace
bit-for-bit (`run(checkpoint_every=..., save_fn=...)`).
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import simulator, slots
from repro_torch.device import resolve_device
from repro_torch.sched.faults import RECOVERY_POLICIES, FaultPlan
from repro_torch.sched.placement import (ContentionModel, PlacementConfig,
                                         place_tenants)
from repro_torch.sched.topology import Topology

__all__ = [
    "TenantEvent", "OnlineConfig", "OnlineReport", "OnlineReplacer",
    "POLICIES", "RESOLVE_MODES",
]

POLICIES = ("never", "always", "warm")
RESOLVE_MODES = ("incremental", "full")

# snapshot schema versions `OnlineReplacer.restore` understands: 1 is the
# pre-topology layout (implicitly flat), 2 adds the topology geometry
SUPPORTED_SNAPSHOT_VERSIONS = (1, 2)


@dataclass(frozen=True)
class TenantEvent:
    """One roster change: a tenant arriving (with its bench profile) or
    departing.  Within an epoch, departures apply before arrivals."""

    epoch: int
    kind: str                 # "arrive" | "depart"
    name: str
    bench: str | None = None  # required for "arrive"

    def __post_init__(self):
        if self.kind not in ("arrive", "depart"):
            raise ValueError(
                f"event kind must be 'arrive' or 'depart', got "
                f"{self.kind!r}")
        if self.kind == "arrive" and not self.bench:
            raise ValueError(
                f"arrival of {self.name!r} needs a bench profile")
        if self.epoch < 0:
            raise ValueError(f"event epoch must be >= 0, got {self.epoch}")


@dataclass(frozen=True)
class OnlineConfig:
    """Knobs of the epoch loop.

    `epoch_steps` is the scan budget every non-empty core advances per
    epoch (its round-robin shares it between residents); `probe_steps` the
    resume window of the migration-penalty measurement.  `placement`
    carries the simulator geometry (slots, miss latency, quantum) shared
    by the epoch scans, the contention model, and the probes.

    `topology` (a `repro_torch.sched.topology.Topology`) places the cores
    within sockets within hosts; when given, it *defines* `num_cores`.
    The default is `Topology.flat(num_cores)` — one host, one socket —
    which reproduces the pre-topology serve bit-for-bit.
    """

    num_cores: int = 2
    epoch_steps: int = 6_000
    probe_steps: int = 2_000
    # soft per-epoch migration bound: no new exchange unit starts once this
    # many tenants moved (an atomic cycle may overshoot by its length - 1)
    max_moves_per_epoch: int = 4
    bs_cache_entries: int = 64
    bs_miss_extra: int = 100
    placement: PlacementConfig = field(default_factory=PlacementConfig)
    topology: Topology | None = None

    def __post_init__(self):
        if self.topology is None:
            object.__setattr__(self, "topology",
                               Topology.flat(self.num_cores))
        elif not isinstance(self.topology, Topology):
            raise TypeError(
                f"topology must be a repro_torch.sched.topology.Topology, "
                f"got {type(self.topology).__name__}")
        else:
            object.__setattr__(self, "num_cores", self.topology.num_cores)
        if self.num_cores < 1:
            raise ValueError(f"num_cores must be >= 1, got {self.num_cores}")
        if self.epoch_steps < 1 or self.probe_steps < 1:
            raise ValueError("epoch_steps and probe_steps must be >= 1")

    def reconfig(self) -> simulator.ReconfigConfig:
        return simulator.ReconfigConfig(
            num_slots=self.placement.num_slots,
            miss_latency=self.placement.miss_latency,
            bs_cache_entries=self.bs_cache_entries,
            bs_miss_extra=self.bs_miss_extra)


class _TenantRun:
    """Mutable service record of one tenant (cursor + cumulative counters
    survive migrations; the slot caches do not — they belong to cores)."""

    def __init__(self, name: str, bench: str, core: int):
        self.name = name
        self.bench = bench
        self.core = core               # -1: stranded (no core assigned)
        self.cursor = 0
        self.cycles = 0
        self.instrs = 0
        self.slot_misses = 0
        self.migrations = 0
        self.evacuations = 0
        # cycles of service denied while stranded on a down core: each
        # stranded epoch charges the work the tenant should have completed
        # (epoch_steps x solo CPI) as pure delay with nothing retired
        self.stall_cycles = 0.0


class _Core:
    """A physical reconfigurable core: persistent slot/bitstream caches,
    plus its fault status (up/down, usable slot width, reconfig-port
    stall horizon)."""

    def __init__(self, cfg: OnlineConfig, device: torch.device):
        self.slot_st = slots.init(cfg.placement.num_slots, device)
        self.bs_st = slots.init(cfg.bs_cache_entries, device)
        self.up = True
        self.active_slots = cfg.placement.num_slots
        self.repair_at: int | None = None    # epoch a transient loss heals
        self.repair_degraded = 0             # slots lost after the repair
        self.stall_until = 0                 # reloads to here fail before it


@dataclass
class OnlineReport:
    """Outcome of one `OnlineReplacer.run`.

    `worst_slowdown` is the classic CPI-based contention metric (cycles
    actually spent / solo reference — blind to stranding, since a stalled
    tenant accrues no cycles); `worst_lifetime_slowdown` additionally
    charges every stranded epoch's denied service as delay, so a tenant
    parked on a dead core shows the outage it actually suffered.  In a
    fault-free serve the two coincide per tenant."""

    policy: str
    epochs: int
    migrations: int
    per_tenant: dict                   # name -> service metrics
    worst_slowdown: float
    mean_slowdown: float
    final_cores: tuple[tuple[str, ...], ...]
    moves: list                        # per-move log dicts
    epoch_log: list                    # per-epoch roster/migration rows
    recovery: str = "warm"
    evacuations: int = 0
    worst_lifetime_slowdown: float = 0.0
    fault_log: list = field(default_factory=list)


class OnlineReplacer:
    """Epoch-driven online placement over the resumable fleet simulator.

    `policy`:
      * "never"  — tenants stay where arrival placement put them;
      * "always" — apply every move the per-epoch re-solve implies;
      * "warm"   — apply a move only when its predicted contention saving
        over the next epoch exceeds its *measured* warm-state migration
        penalty (resume-on-cold-core probe).

    `faults` (a `repro_torch.sched.faults.FaultPlan`) injects epoch-aligned
    fault events; `recovery` picks how the replacer reacts
    (`RECOVERY_POLICIES`): "warm" evacuates stranded tenants onto the
    best surviving core (a mandatory move priced for destination choice
    only), "cold_restart" additionally flushes every surviving core's
    caches on a fault epoch (the restart-everything baseline), "none"
    leaves stranded tenants stalled until their core repairs.

    Every simulation and every core's caches live on `device` (default
    "cuda"); a given `model` must sweep on the same device.
    """

    def __init__(self, cfg: OnlineConfig | None = None,
                 model: ContentionModel | None = None,
                 policy: str = "warm", *,
                 faults: FaultPlan | None = None,
                 recovery: str = "warm",
                 backoff_cap: int = 8,
                 resolve_mode: str = "incremental", device="cuda"):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}, expected one of {POLICIES}")
        if resolve_mode not in RESOLVE_MODES:
            raise ValueError(
                f"unknown resolve_mode {resolve_mode!r}, expected one of "
                f"{RESOLVE_MODES}")
        if recovery not in RECOVERY_POLICIES:
            raise ValueError(
                f"unknown recovery policy {recovery!r}, expected one of "
                f"{RECOVERY_POLICIES}")
        if faults is not None and not isinstance(faults, FaultPlan):
            raise TypeError(
                f"faults must be a repro_torch.sched.faults.FaultPlan, got "
                f"{type(faults).__name__}")
        if backoff_cap < 1:
            raise ValueError(f"backoff_cap must be >= 1, got {backoff_cap}")
        self.device = resolve_device(device)
        self.cfg = cfg or OnlineConfig()
        self.model = model or ContentionModel(self.cfg.placement,
                                              device=self.device)
        if self.model.device != self.device:
            raise ValueError(
                f"contention model sweeps on {self.model.device} but the "
                f"replacer serves on {self.device}")
        if self.model.cfg.num_slots != self.cfg.placement.num_slots:
            raise ValueError(
                f"contention model simulates {self.model.cfg.num_slots} "
                f"slots but the online config serves "
                f"{self.cfg.placement.num_slots} — predictions would price "
                f"a different machine")
        self.policy = policy
        self.faults = faults
        self.recovery = recovery
        self.backoff_cap = backoff_cap
        self.resolve_mode = resolve_mode
        self.tenants: dict[str, _TenantRun] = {}
        self.departed: list[_TenantRun] = []
        self.cores = [_Core(self.cfg, self.device)
                      for _ in range(self.cfg.num_cores)]
        self.migrations = 0
        self.evacuations = 0
        self.moves: list[dict] = []
        self.fault_log: list[dict] = []
        self.epoch_log: list[dict] = []
        # per-tenant reconfig-retry ledger: attempts blocked by a stalled
        # destination back off exponentially (capped) before retrying
        self._retry: dict[str, dict] = {}
        self._epoch = 0                      # next epoch run() executes
        # incremental re-solve state: per-host cached target assignments
        # (the kept swap frontier) and the set of hosts dirtied since the
        # last re-solve.  Everything starts dirty; `resolve_log` records
        # per-epoch solved/cached domain counts + wall time (telemetry
        # only — never part of the report or a snapshot, so restored
        # serves stay bit-for-bit comparable)
        self._domain_target: dict[int, dict[str, int]] = {}
        self._dirty: set[int] = set(range(self.cfg.topology.num_hosts))
        self.resolve_log: list[dict] = []

    def _i32(self, x) -> torch.Tensor:
        """An int32 tensor on the replacer's device."""
        return torch.tensor(np.asarray(x, np.int32), device=self.device)

    # ------------------------------------------------------------------
    # roster bookkeeping
    # ------------------------------------------------------------------
    def _members(self, core: int) -> list[_TenantRun]:
        return sorted((t for t in self.tenants.values() if t.core == core),
                      key=lambda t: t.name)

    def _core_map(self) -> dict[int, list[_TenantRun]]:
        """core index -> name-sorted members, built in ONE O(T) pass.
        The fleet-scale hot paths (arrival candidate scoring, unit
        pricing, the per-domain re-solve) take this precomputed map
        instead of calling `_members` per core — a per-core scan made
        arrivals O(T x C) and unit pricing O(T x units), hopeless at
        1000 tenants."""
        cm: dict[int, list[_TenantRun]] = {}
        for name in sorted(self.tenants):
            t = self.tenants[name]
            cm.setdefault(t.core, []).append(t)
        return cm

    def _groups(self) -> list[tuple[str, ...]]:
        cm = self._core_map()
        return [tuple(sorted(t.bench for t in cm.get(c, [])))
                for c in range(self.cfg.num_cores)]

    def _up_cores(self) -> list[int]:
        return [ci for ci in range(self.cfg.num_cores) if self.cores[ci].up]

    def _mark_dirty(self, core: int) -> None:
        """Record that `core`'s host must be re-solved next epoch (its
        roster, up-set or current assignment changed).  Stranded tenants
        (core < 0) belong to no domain until recovery places them."""
        if core >= 0:
            self._dirty.add(self.cfg.topology.host_of(core))

    def _predict_on(self, pairs) -> list:
        """Predict each (core, group) pair's slowdowns at that core's
        usable slot width.  Full-width cores batch through one `predict`
        call (the fault-free fast path, bit-identical to the pre-fault
        code); degraded cores price at their reduced width, which is what
        down-weights them as destinations."""
        if all(self.cores[c].active_slots == self.cfg.placement.num_slots
               for c, _ in pairs):
            return self.model.predict([g for _, g in pairs])
        return [self.model.predict(
                    [g], num_slots=self.cores[c].active_slots)[0]
                for c, g in pairs]

    def _arrive(self, name: str, bench: str) -> None:
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} arrived twice")
        if any(t.name == name for t in self.departed):
            raise ValueError(
                f"tenant name {name!r} was already served and departed — "
                f"service records are keyed by name, so a returning "
                f"tenant needs a fresh name (e.g. {name!r}-2)")
        self.model.trace(bench)            # validates the bench name
        up = self._up_cores()
        if not up:
            # fully-dark fleet: the tenant strands until a core repairs
            self.tenants[name] = _TenantRun(name, bench, -1)
            return
        cm = self._core_map()
        counts = [len(cm.get(c, [])) for c in up]
        open_cores = [c for c, n in zip(up, counts) if n == min(counts)]
        # among least-loaded up cores, join the one whose resulting group
        # predicts the best (worst, mean) slowdown — greedy, no migration
        cand = [tuple(sorted([t.bench for t in cm.get(c, [])] + [bench]))
                for c in open_cores]
        preds = self._predict_on(list(zip(open_cores, cand)))
        best = min(range(len(open_cores)),
                   key=lambda i: (float(np.max(preds[i])),
                                  float(np.mean(preds[i])), i))
        self.tenants[name] = _TenantRun(name, bench, open_cores[best])
        self._mark_dirty(open_cores[best])

    def _depart(self, name: str) -> None:
        if name not in self.tenants:
            raise ValueError(f"departure of unknown tenant {name!r}")
        # the core keeps its caches — a departed tenant's residents decay
        # naturally under LRU as the survivors run; the service record is
        # archived so the final report scores every tenant ever served
        self._mark_dirty(self.tenants[name].core)
        self.departed.append(self.tenants.pop(name))

    # ------------------------------------------------------------------
    # fault injection, detection and recovery
    # ------------------------------------------------------------------
    def _apply_faults(self, epoch: int) -> bool:
        """Heal due repairs, then inject this epoch's scheduled faults.
        Returns True when any fault fired (cold_restart keys off it)."""
        for ci, core in enumerate(self.cores):
            if core.up or core.repair_at is None or epoch < core.repair_at:
                continue
            # the repaired region is rebuilt: caches come back cold, and
            # possibly narrower (masked via num_active in every later sim)
            core.up = True
            core.repair_at = None
            core.active_slots = max(
                1, self.cfg.placement.num_slots - core.repair_degraded)
            core.repair_degraded = 0
            core.slot_st = slots.init(self.cfg.placement.num_slots,
                                      self.device)
            core.bs_st = slots.init(self.cfg.bs_cache_entries, self.device)
            self._mark_dirty(ci)           # up-set changed: host re-solves
            self.fault_log.append({"epoch": epoch, "kind": "repair",
                                   "core": ci,
                                   "active_slots": core.active_slots})
        if self.faults is None:
            return False
        any_fault = False
        for ev in self.faults.at(epoch):
            core = self.cores[ev.core]
            if not core.up:
                continue        # a down core absorbs no further faults
            rec = {"epoch": epoch, "detected": epoch, "kind": ev.kind,
                   "core": ev.core}
            if ev.kind == "core_loss":
                core.up = False
                core.repair_at = (None if ev.permanent
                                  else epoch + ev.repair_epochs)
                core.repair_degraded = ev.degraded_slots
                rec["permanent"] = ev.permanent
                rec["repair_at"] = core.repair_at
                rec["stranded"] = tuple(t.name
                                        for t in self._members(ev.core))
            elif ev.kind == "slot_seu":
                tags = simulator._np(core.slot_st.tags)
                occupied = np.nonzero(tags >= 0)[0]
                hit = np.sort(self.faults.rng(ev).choice(
                    occupied, size=min(ev.num_hit, occupied.size),
                    replace=False)) if occupied.size else occupied
                rec["hit_entries"] = tuple(int(i) for i in hit)
                rec["hit_tags"] = tuple(int(tags[i]) for i in hit)
                if hit.size:
                    core.slot_st = simulator.canonical_slot_state(
                        slots.invalidate(core.slot_st, hit))
            elif ev.kind == "bitstream_flush":
                core.bs_st = slots.init(self.cfg.bs_cache_entries,
                                        self.device)
            else:                                   # reconfig_stall
                core.stall_until = max(core.stall_until,
                                       epoch + ev.stall_epochs)
                rec["stall_until"] = core.stall_until
            # conservative: any fault on the core dirties its host (a
            # core_loss changes the up-set; the rest are over-marking,
            # which only re-solves more — under-marking would break the
            # incremental == full guarantee)
            self._mark_dirty(ev.core)
            self.fault_log.append(rec)
            any_fault = True
        return any_fault

    def _attempt_move(self, name: str, dst: int, epoch: int, *,
                      why: str) -> bool:
        """Gate a reload/migration attempt on the destination's reconfig
        port.  A stalled destination fails the attempt and schedules a
        retry with capped exponential backoff; a pending backoff defers
        silently until its epoch comes up."""
        r = self._retry.get(name)
        if r is not None and epoch < r["next"]:
            return False
        if epoch < self.cores[dst].stall_until:
            retries = (r["retries"] if r is not None else 0) + 1
            delay = min(1 << (retries - 1), self.backoff_cap)
            self._retry[name] = {"retries": retries, "next": epoch + delay}
            self.fault_log.append({
                "epoch": epoch, "kind": "reconfig_retry", "tenant": name,
                "dst": dst, "why": why, "retries": retries,
                "next_attempt": epoch + delay})
            return False
        return True

    def _cold_resume_cycles(self, t: _TenantRun, dst: int) -> float:
        """Cycles of re-warming the evacuee pays on its destination,
        measured by a solo probe resumed from the destination's actual
        caches (usually cold for this tenant's tags) against the solo
        reference — the fault log's 'what did this evacuation cost'."""
        pcfg = self.cfg.placement
        core = self.cores[dst]
        st = simulator.init_fleet_state(
            1, pcfg.num_slots, self.cfg.bs_cache_entries,
            self.device)._replace(
                slot_st=core.slot_st, bs_st=core.bs_st,
                cursors=self._i32([t.cursor]))
        na = (core.active_slots
              if core.active_slots < pcfg.num_slots else None)
        res = simulator.simulate_many(
            np.asarray(self.model.trace(t.bench))[None, :],
            self.cfg.reconfig(), self.model.scenario_of(t.bench),
            simulator.SchedulerConfig.no_preempt(pcfg.handler_cycles),
            total_steps=self.cfg.probe_steps, state=st, num_active=na,
            device=self.device)
        return max(0.0, float(int(res.cycles[0]))
                   - self.cfg.probe_steps * self.model.solo_cpi(t.bench))

    def _recover(self, epoch: int) -> None:
        """Evacuate stranded tenants (core lost, or never placed) onto the
        best surviving core.  Evacuations are *mandatory* moves: the
        contention model prices only the destination choice — there is no
        net-benefit gate, because the alternative is not-running."""
        if self.recovery == "none":
            return
        stranded = sorted(
            (t for t in self.tenants.values()
             if t.core < 0 or not self.cores[t.core].up),
            key=lambda t: t.name)
        up = self._up_cores()
        if not stranded or not up:
            return
        # prefer destinations whose reconfig port is not stalled; if every
        # up core is stalled, attempts go through backoff and retry later
        avail = [c for c in up
                 if epoch >= self.cores[c].stall_until] or up
        topo = self.cfg.topology
        cm = self._core_map()
        for t in stranded:
            cand = [tuple(sorted([m.bench for m in cm.get(c, [])]
                                 + [t.bench])) for c in avail]
            preds = self._predict_on(list(zip(avail, cand)))
            best = min(range(len(avail)),
                       key=lambda i: (float(np.max(preds[i])),
                                      float(np.mean(preds[i])), i))
            dst = avail[best]
            src = t.core
            if not self._attempt_move(t.name, dst, epoch,
                                      why="evacuation"):
                continue
            cold = self._cold_resume_cycles(t, dst)
            # a cross-socket/host evacuation additionally re-loads every
            # warm bitstream the tenant leaves behind (LUTstructions tier
            # surcharge); the move is mandatory so the cost lands as
            # denied-service stall, not as a gate
            reload = self.reload_cycles(t.name, dst) if src >= 0 else 0.0
            retries = self._retry.pop(t.name, {"retries": 0})["retries"]
            if src in cm:
                cm[src] = [m for m in cm[src] if m.name != t.name]
            t.core = dst
            cm.setdefault(dst, []).append(t)
            t.evacuations += 1
            t.stall_cycles += reload
            self.evacuations += 1
            self._mark_dirty(src)
            self._mark_dirty(dst)
            rec = {"epoch": epoch, "kind": "evacuation", "tenant": t.name,
                   "src": src, "dst": dst, "retries": retries,
                   "cold_resume_cycles": cold}
            if src >= 0:
                rec["distance"] = topo.distance(src, dst)
                rec["reload_cycles"] = reload
            self.fault_log.append(rec)

    # ------------------------------------------------------------------
    # epoch advance over resumable fleet state
    # ------------------------------------------------------------------
    def _advance_epoch(self) -> None:
        pcfg = self.cfg.placement
        sched = pcfg.scheduler()
        rcfg = self.cfg.reconfig()
        core_map = self._core_map()
        for ci in range(self.cfg.num_cores):
            core = self.cores[ci]
            if not core.up:
                continue                   # stranded tenants accrue stall
            members = core_map.get(ci, [])
            if not members:
                continue
            tr = np.stack([np.asarray(self.model.trace(t.bench))
                           for t in members])
            st = simulator.init_fleet_state(
                len(members), pcfg.num_slots, self.cfg.bs_cache_entries,
                self.device)
            # resume: the core's caches are warm from every prior epoch
            # (and from prior residents); cursors continue each tenant's
            # own stream; counters start at zero -> per-epoch deltas
            st = st._replace(
                slot_st=core.slot_st, bs_st=core.bs_st,
                cursors=self._i32([t.cursor for t in members]))
            na = (core.active_slots
                  if core.active_slots < pcfg.num_slots else None)
            res, st = simulator.simulate_many(
                tr, rcfg,
                [self.model.scenario_of(t.bench) for t in members],
                sched, total_steps=self.cfg.epoch_steps,
                state=st, return_state=True, num_active=na,
                device=self.device)
            core.slot_st, core.bs_st = st.slot_st, st.bs_st
            cursors = simulator._np(st.cursors)
            cycles = simulator._np(res.cycles)
            instrs = simulator._np(res.instructions)
            misses = simulator._np(res.slot_misses)
            for p, t in enumerate(members):
                t.cursor = int(cursors[p])
                t.cycles += int(cycles[p])
                t.instrs += int(instrs[p])
                t.slot_misses += int(misses[p])

    # ------------------------------------------------------------------
    # warm-state migration pricing
    # ------------------------------------------------------------------
    def reload_cycles(self, name: str, dst: int) -> float:
        """LUTstructions re-load surcharge of moving `name` to `dst`:
        every one of the tenant's bitstreams warm on its *current* core
        must be re-loaded across the interconnect, at `bs_miss_extra`
        cycles each scaled by the topology's distance-tier multiplier.
        Zero within a socket (the measured probe already prices that
        tier) — so a flat topology prices every move exactly as before.
        """
        t = self.tenants[name]
        topo = self.cfg.topology
        if t.core < 0:
            return 0.0          # stranded: no warm state to leave behind
        mult = topo.reload_multiplier(topo.distance(t.core, dst))
        if mult == 0.0:
            return 0.0
        tag_row = np.asarray(self.model.scenario_of(t.bench).instr_tag)
        tags = np.unique(tag_row[np.asarray(self.model.trace(t.bench))])
        tags = tags[tags >= 0]
        if tags.size == 0:
            return 0.0
        res = slots.resident_many(self.cores[t.core].bs_st, self._i32(tags))
        resident = int(np.sum(simulator._np(res)))
        return float(resident * self.cfg.bs_miss_extra * mult)

    def migration_penalty(self, name: str, dst: int | None = None) -> float:
        """Cost (cycles) of restarting `name` on another core.

        The base is *measured*: the tenant's state is resumed solo for
        `probe_steps` twice — from its current core's warm caches and
        from a cold `init_fleet_state` — and the penalty is the cycle
        difference.  This is the LUTstructions quantity: how many cycles
        of reconfiguration/bitstream re-loading the destination core
        charges before the tenant is warm again.

        With a destination, the move's distance tier adds the modelled
        `reload_cycles` surcharge on top: cross-socket and cross-host
        moves must re-load the mover's resident bitstreams over the
        interconnect, which the local probe cannot see.  `dst=None` (or
        any intra-socket destination) is the bare probe, bit-identical
        to the pre-topology pricing.
        """
        t = self.tenants[name]
        pcfg = self.cfg.placement
        rcfg = self.cfg.reconfig()
        scen = self.model.scenario_of(t.bench)
        tr = np.asarray(self.model.trace(t.bench))[None, :]
        cold = simulator.init_fleet_state(
            1, pcfg.num_slots, self.cfg.bs_cache_entries,
            self.device)._replace(cursors=self._i32([t.cursor]))
        core = self.cores[t.core]
        warm = cold._replace(slot_st=core.slot_st, bs_st=core.bs_st)
        sched = simulator.SchedulerConfig.no_preempt(pcfg.handler_cycles)
        kw = dict(total_steps=self.cfg.probe_steps, return_state=False,
                  device=self.device)
        # the warm probe replays the tenant's current (possibly degraded)
        # core; the cold probe is the full-width destination baseline
        na = (core.active_slots
              if core.active_slots < pcfg.num_slots else None)
        res_c = simulator.simulate_many(tr, rcfg, scen, sched,
                                        state=cold, **kw)
        res_w = simulator.simulate_many(tr, rcfg, scen, sched,
                                        state=warm, num_active=na, **kw)
        probe = float(int(res_c.cycles[0]) - int(res_w.cycles[0]))
        if dst is None:
            return probe
        return probe + self.reload_cycles(name, dst)

    def warm_fraction(self, name: str) -> float:
        """Fraction of the tenant's slotted tag set resident on its core's
        disambiguator right now (observability for the move log)."""
        t = self.tenants[name]
        tag_row = np.asarray(self.model.scenario_of(t.bench).instr_tag)
        tags = np.unique(tag_row[np.asarray(self.model.trace(t.bench))])
        tags = tags[tags >= 0]
        if tags.size == 0:
            return 1.0
        res = slots.resident_many(self.cores[t.core].slot_st,
                                  self._i32(tags))
        return float(np.mean(simulator._np(res)))

    def _group_cycles(self, group: tuple[str, ...],
                      core: int | None = None) -> float:
        """Predicted cycles one epoch spends serving `group` on one core:
        per-member slowdown x solo CPI x the member's round-robin share of
        the epoch's step budget.  Pass `core` to price at that core's
        usable slot width (degraded cores predict worse, so the re-solve
        naturally steers load off them)."""
        if not group:
            return 0.0
        ns = None
        if (core is not None and self.cores[core].active_slots
                < self.cfg.placement.num_slots):
            ns = self.cores[core].active_slots
        pred = self.model.predict([group], num_slots=ns)[0]
        share = self.cfg.epoch_steps / len(group)
        solo = np.array([self.model.solo_cpi(b) for b in sorted(group)])
        return float(np.sum(pred * solo * share))

    def move_benefit(self, moves: dict[str, int],
                     core_map: dict[int, list] | None = None) -> float:
        """Predicted contention delta (cycles/epoch) of applying `moves`
        (tenant name -> destination core) atomically: old-cost minus
        new-cost summed over every affected core.  A cross-core swap must
        be priced as one unit — each leg alone transits through a
        lopsided group and would misprice the exchange.  Pass `core_map`
        (a `_core_map()` snapshot of the current membership) to avoid the
        O(tenants) rebuild per call on the rebalance hot path."""
        if core_map is None:
            core_map = self._core_map()
        affected = {self.tenants[n].core for n in moves} | set(moves.values())
        old = new = 0.0
        # ascending core order keeps the float summation order identical
        # to the historical full scan over range(num_cores)
        for ci in sorted(affected):
            if ci < 0:
                continue
            members = core_map.get(ci, [])
            cur = [t.bench for t in members]
            nxt = [t.bench for t in members
                   if t.name not in moves or moves[t.name] == ci]
            nxt += [self.tenants[n].bench for n, dst in moves.items()
                    if dst == ci and self.tenants[n].core != ci]
            old += self._group_cycles(tuple(sorted(cur)), core=ci)
            new += self._group_cycles(tuple(sorted(nxt)), core=ci)
        return old - new

    # ------------------------------------------------------------------
    # per-epoch re-solve
    # ------------------------------------------------------------------
    def _solve_domain(self, host: int,
                      core_map: dict[int, list]) -> dict[str, int]:
        """Re-solve placement for one host's roster and align the solved
        cores to the host's physical cores by membership overlap (a
        re-solve that merely permutes core labels must imply zero moves).
        Only tenants on *up* cores are re-solved: stranded tenants come
        back through the recovery path (`_recover`), never through
        rebalancing — the separation keeps the recovery-policy comparison
        honest.  Deterministic given the host's roster and up-set, which
        is what makes the incremental cache pure memoisation."""
        up = [c for c in self.cfg.topology.cores_of_host(host)
              if self.cores[c].up]
        roster = {t.name: t.bench
                  for c in up for t in core_map.get(c, [])}
        if len(roster) < 2 or not up:
            return {}
        pl = place_tenants(roster, min(len(up), len(roster)), self.model)
        solved = [set(core) for core in pl.cores]
        unassigned = set(up)
        target: dict[str, int] = {}
        current = {t.name: t.core
                   for c in up for t in core_map.get(c, [])}
        order = sorted(
            range(len(solved)),
            key=lambda si: -len(solved[si]))
        for si in order:
            best = max(unassigned, key=lambda ci: (
                sum(1 for n in solved[si] if current.get(n) == ci), -ci))
            unassigned.discard(best)
            for n in solved[si]:
                target[n] = best
        return target

    def _target_assignment(self, epoch: int | None = None) -> dict[str, int]:
        """Per-epoch re-solve: each host is an independent placement
        domain (`_solve_domain`).  In the default incremental mode only
        domains dirtied since the last re-solve run the greedy + swap
        search; clean domains reuse their cached target — bit-for-bit
        the same answer, because the domain solve is a deterministic
        function of the host's roster/up-set and every mutation of
        either marks the host dirty.  `resolve_mode="full"` re-solves
        every domain every epoch (the parity baseline)."""
        topo = self.cfg.topology
        core_map = self._core_map()
        t0 = time.perf_counter()
        dirty = (set(range(topo.num_hosts))
                 if self.resolve_mode == "full" else set(self._dirty))
        solved = 0
        target: dict[str, int] = {}
        for host in range(topo.num_hosts):
            if host in dirty:
                self._domain_target[host] = self._solve_domain(
                    host, core_map)
                solved += 1
            target.update(self._domain_target.get(host, {}))
        self._dirty.clear()
        self.resolve_log.append({
            "epoch": self._epoch if epoch is None else epoch,
            "mode": self.resolve_mode,
            "solved": solved,
            "cached": topo.num_hosts - solved,
            "seconds": time.perf_counter() - t0,
        })
        return target

    def _exchange_units(self, target: dict[str, int]) -> list[tuple]:
        """Group the target's pending moves into minimal exchange units.

        The pending moves form a permutation-like flow between cores; it
        decomposes into *chains* (a tenant moves into spare capacity) and
        *cycles* (tenants trade places — a swap is the 2-cycle).  A cycle
        must be priced and applied atomically: each leg alone transits
        through a lopsided group and would misprice the exchange."""
        pending = [(n, self.tenants[n].core, c)
                   for n, c in sorted(target.items())
                   if c != self.tenants[n].core]
        units: list[tuple] = []
        while pending:
            chain = [pending.pop(0)]
            while True:
                end = chain[-1][2]
                if end == chain[0][1]:
                    break                      # closed cycle
                nxt = next((m for m in pending if m[1] == end), None)
                if nxt is None:
                    break                      # open chain (spare capacity)
                pending.remove(nxt)
                chain.append(nxt)
            units.append(tuple(n for n, _, _ in chain))
        return units

    def rebalance(self, epoch: int) -> int:
        """One re-placement round; returns how many tenants moved."""
        if self.policy == "never":
            return 0
        target = self._target_assignment(epoch)
        if not target:
            return 0
        topo = self.cfg.topology
        units = self._exchange_units(target)
        moved = 0
        # most beneficial unit first; re-price against the *current*
        # membership before each apply (an earlier unit changes groups)
        while units and moved < self.cfg.max_moves_per_epoch:
            core_map = self._core_map()
            scored = [(self.move_benefit({n: target[n] for n in u},
                                         core_map), u)
                      for u in units]
            scored.sort(key=lambda x: (-x[0], x[1]))
            benefit, unit = scored[0]
            units.remove(unit)
            # tiered penalty: measured warm-resume probe plus the
            # distance-dependent re-load surcharge of each leg
            penalty = sum(self.migration_penalty(n, target[n])
                          for n in unit)
            net = benefit - penalty
            take = self.policy == "always" or net > 0.0
            blocked = False
            if take:
                # every leg's destination port must accept the reload;
                # stalled legs enter backoff and the unit stays put
                oks = [self._attempt_move(n, target[n], epoch,
                                          why="rebalance") for n in unit]
                if not all(oks):
                    take, blocked = False, True
            move = {
                "epoch": epoch, "tenants": unit,
                "src": tuple(self.tenants[n].core for n in unit),
                "dst": tuple(target[n] for n in unit),
                "distance": tuple(
                    topo.distance(self.tenants[n].core, target[n])
                    for n in unit),
                "benefit_cycles": benefit, "penalty_cycles": penalty,
                "net_cycles": net,
                "warm_fraction": tuple(self.warm_fraction(n)
                                       for n in unit),
                "applied": take,
            }
            if blocked:
                move["blocked"] = True
            self.moves.append(move)
            if take:
                for n in unit:
                    self._retry.pop(n, None)
                    self._mark_dirty(self.tenants[n].core)
                    self.tenants[n].core = target[n]
                    self._mark_dirty(target[n])
                    self.tenants[n].migrations += 1
                    self.migrations += 1
                    moved += 1
        return moved

    # ------------------------------------------------------------------
    def run(self, events, num_epochs: int | None = None, *,
            checkpoint_every: int = 0, save_fn=None) -> OnlineReport:
        """Serve an event stream for `num_epochs` epochs (default: last
        event epoch + 4 drain epochs).

        `checkpoint_every=k` calls ``save_fn(snapshot, epoch)`` after
        every k-th completed epoch; a replacer `restore`d from such a
        snapshot and `run` with the same arguments resumes at the next
        epoch and finishes bit-for-bit identical to the uninterrupted
        serve (the fault plan's randomness is counter-based, so the
        replayed suffix sees the identical storm)."""
        events = list(events)
        if num_epochs is None:
            num_epochs = (max((e.epoch for e in events), default=0) + 5)
        if checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if checkpoint_every and save_fn is None:
            raise ValueError("checkpoint_every needs a save_fn")
        by_epoch: dict[int, list[TenantEvent]] = {}
        for e in events:
            if e.epoch >= num_epochs:
                raise ValueError(
                    f"event at epoch {e.epoch} outside the horizon "
                    f"{num_epochs}")
            by_epoch.setdefault(e.epoch, []).append(e)
        if self.faults is not None \
                and self.faults.max_core() >= self.cfg.num_cores:
            raise ValueError(
                f"fault plan targets core {self.faults.max_core()} but "
                f"the fleet has {self.cfg.num_cores} cores")
        for epoch in range(self._epoch, num_epochs):
            any_fault = self._apply_faults(epoch)
            if any_fault and self.recovery == "cold_restart":
                # restart-everything baseline: every surviving core's
                # caches are flushed, the whole fleet re-pays warm-up
                for core in self.cores:
                    if core.up:
                        core.slot_st = slots.init(
                            self.cfg.placement.num_slots, self.device)
                        core.bs_st = slots.init(self.cfg.bs_cache_entries,
                                                self.device)
                self.fault_log.append({"epoch": epoch,
                                       "kind": "cold_restart"})
            todays = by_epoch.get(epoch, [])
            for e in todays:                      # departures first
                if e.kind == "depart":
                    self._depart(e.name)
            for e in todays:
                if e.kind == "arrive":
                    self._arrive(e.name, e.bench)
            self._recover(epoch)
            moved = self.rebalance(epoch)
            self._advance_epoch()
            # denied service: a stranded tenant should have retired
            # epoch_steps instructions at its solo CPI — charge that as
            # pure stall so lifetime slowdown reflects the outage
            for t in self.tenants.values():
                if t.core < 0 or not self.cores[t.core].up:
                    t.stall_cycles += (self.cfg.epoch_steps
                                       * self.model.solo_cpi(t.bench))
            cm = self._core_map()
            row = {
                "epoch": epoch,
                "tenants": len(self.tenants),
                "moved": moved,
                "cores": tuple(tuple(t.name for t in cm.get(c, []))
                               for c in range(self.cfg.num_cores)),
            }
            if self.faults is not None:
                row["down"] = tuple(ci for ci in range(self.cfg.num_cores)
                                    if not self.cores[ci].up)
            self.epoch_log.append(row)
            self._epoch = epoch + 1
            if checkpoint_every and (epoch + 1) % checkpoint_every == 0:
                save_fn(self.snapshot(), epoch)
        return self._report(num_epochs)

    # ------------------------------------------------------------------
    # checkpoint / restore (crash-restartable serving)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Complete host-side serving state as a plain dict of numpy
        arrays and python scalars, the reference's schema, so a snapshot
        of either package restores into the other: tenants with
        cursors and counters, per-core caches and fault status, retry
        ledger, and every log.  No RNG state — the fault plan's
        randomness is counter-based and replays from the plan itself."""
        def _core(c):
            return {
                "tags": simulator._np(c.slot_st.tags).copy(),
                "last_use": simulator._np(c.slot_st.last_use).copy(),
                "clock": int(c.slot_st.clock),
                "bs_tags": simulator._np(c.bs_st.tags).copy(),
                "bs_last_use": simulator._np(c.bs_st.last_use).copy(),
                "bs_clock": int(c.bs_st.clock),
                "up": c.up, "active_slots": c.active_slots,
                "repair_at": c.repair_at,
                "repair_degraded": c.repair_degraded,
                "stall_until": c.stall_until,
            }

        def _tenant(t):
            return {"name": t.name, "bench": t.bench, "core": t.core,
                    "cursor": t.cursor, "cycles": t.cycles,
                    "instrs": t.instrs, "slot_misses": t.slot_misses,
                    "migrations": t.migrations,
                    "evacuations": t.evacuations,
                    "stall_cycles": t.stall_cycles}

        return {
            "version": 2,
            "epoch": self._epoch,
            "policy": self.policy,
            "recovery": self.recovery,
            "topology": self.cfg.topology.geometry(),
            "num_cores": self.cfg.num_cores,
            "num_slots": self.cfg.placement.num_slots,
            "bs_entries": self.cfg.bs_cache_entries,
            "migrations": self.migrations,
            "evacuations": self.evacuations,
            "tenants": [_tenant(self.tenants[n])
                        for n in sorted(self.tenants)],
            "departed": [_tenant(t) for t in self.departed],
            "cores": [_core(c) for c in self.cores],
            "retry": copy.deepcopy(self._retry),
            "moves": copy.deepcopy(self.moves),
            "fault_log": copy.deepcopy(self.fault_log),
            "epoch_log": copy.deepcopy(self.epoch_log),
        }

    def restore(self, snap: dict) -> None:
        """Load a `snapshot` into this replacer; the next `run` resumes
        at the snapshot's epoch.  The replacer must be constructed with
        the same config/policy/recovery/fault plan as the one that saved
        the snapshot.  Version 1 snapshots (pre-topology) carry no
        geometry and load only onto a flat topology."""
        version = snap.get("version")
        if version not in SUPPORTED_SNAPSHOT_VERSIONS:
            raise ValueError(
                f"unknown snapshot version {version!r}; this replacer "
                f"supports versions {SUPPORTED_SNAPSHOT_VERSIONS} — a "
                f"newer writer's snapshot cannot be silently misread")
        geo = tuple(snap.get("topology", (1, 1, snap["num_cores"])))
        if geo != self.cfg.topology.geometry():
            raise ValueError(
                f"snapshot topology {geo} (hosts, sockets/host, "
                f"cores/socket) does not match this replacer's "
                f"{self.cfg.topology.geometry()}")
        for key, mine in (("policy", self.policy),
                          ("recovery", self.recovery),
                          ("num_cores", self.cfg.num_cores),
                          ("num_slots", self.cfg.placement.num_slots),
                          ("bs_entries", self.cfg.bs_cache_entries)):
            if snap[key] != mine:
                raise ValueError(
                    f"snapshot {key}={snap[key]!r} does not match this "
                    f"replacer's {mine!r}")

        def _tenant(d):
            t = _TenantRun(d["name"], d["bench"], d["core"])
            t.cursor = d["cursor"]
            t.cycles = d["cycles"]
            t.instrs = d["instrs"]
            t.slot_misses = d["slot_misses"]
            t.migrations = d["migrations"]
            t.evacuations = d["evacuations"]
            t.stall_cycles = d["stall_cycles"]
            return t

        self.tenants = {d["name"]: _tenant(d) for d in snap["tenants"]}
        self.departed = [_tenant(d) for d in snap["departed"]]
        self.cores = [_Core(self.cfg, self.device)
                      for _ in range(self.cfg.num_cores)]
        for core, d in zip(self.cores, snap["cores"]):
            core.slot_st = slots.SlotState(
                tags=self._i32(d["tags"]), last_use=self._i32(d["last_use"]),
                clock=self._i32(d["clock"]))
            core.bs_st = slots.SlotState(
                tags=self._i32(d["bs_tags"]),
                last_use=self._i32(d["bs_last_use"]),
                clock=self._i32(d["bs_clock"]))
            core.up = d["up"]
            core.active_slots = d["active_slots"]
            core.repair_at = d["repair_at"]
            core.repair_degraded = d["repair_degraded"]
            core.stall_until = d["stall_until"]
        self.migrations = snap["migrations"]
        self.evacuations = snap["evacuations"]
        self._retry = copy.deepcopy(snap["retry"])
        self.moves = copy.deepcopy(snap["moves"])
        self.fault_log = copy.deepcopy(snap["fault_log"])
        self.epoch_log = copy.deepcopy(snap["epoch_log"])
        self._epoch = snap["epoch"]
        # the incremental cache never travels in a snapshot: everything
        # starts dirty, so the first resumed epoch re-solves every domain
        # — pure memoisation of a deterministic solve, so the resumed
        # serve stays bit-for-bit identical to the uninterrupted one
        self._domain_target = {}
        self._dirty = set(range(self.cfg.topology.num_hosts))

    # ------------------------------------------------------------------
    def _report(self, num_epochs: int) -> OnlineReport:
        per_tenant: dict[str, dict] = {}
        slowdowns = []
        lifetimes = []
        records = {t.name: t for t in self.departed}
        records.update(self.tenants)
        for name in sorted(records):
            t = records[name]
            if t.instrs == 0:
                per_tenant[name] = {"bench": t.bench, "instrs": 0,
                                    "scheduled": False}
                if t.stall_cycles > 0:
                    # served nothing while stranded: unbounded slowdown
                    per_tenant[name]["stall_cycles"] = t.stall_cycles
                    per_tenant[name]["lifetime_slowdown"] = float("inf")
                    lifetimes.append(float("inf"))
                continue
            cpi = t.cycles / t.instrs
            solo = self.model.solo_cpi(t.bench)
            slow = cpi / solo
            lifetime = (t.cycles + t.stall_cycles) / (t.instrs * solo)
            slowdowns.append(slow)
            lifetimes.append(lifetime)
            per_tenant[name] = {
                "bench": t.bench, "instrs": t.instrs, "cycles": t.cycles,
                "slot_misses": t.slot_misses, "cpi": cpi,
                "solo_cpi": solo,
                "slowdown": slow, "migrations": t.migrations,
                "evacuations": t.evacuations,
                "stall_cycles": t.stall_cycles,
                "lifetime_slowdown": lifetime,
                "scheduled": True,
            }
        return OnlineReport(
            policy=self.policy,
            epochs=num_epochs,
            migrations=self.migrations,
            per_tenant=per_tenant,
            worst_slowdown=float(max(slowdowns)) if slowdowns else 0.0,
            mean_slowdown=float(np.mean(slowdowns)) if slowdowns else 0.0,
            final_cores=tuple(tuple(t.name for t in self._members(c))
                              for c in range(self.cfg.num_cores)),
            moves=self.moves,
            epoch_log=self.epoch_log,
            recovery=self.recovery,
            evacuations=self.evacuations,
            worst_lifetime_slowdown=(max(lifetimes) if lifetimes else 0.0),
            fault_log=self.fault_log,
        )
