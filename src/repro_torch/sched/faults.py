"""Deterministic fault injection for the online serving loop.  PyTorch
port of `repro.sched.faults` (numpy; the counter-based generator keyed on
``(seed, epoch, core, kind)`` is the reference's, so both packages draw
the same storm and the same SEU victims).

The paper's architectural bet is that per-core FPGA state — disambiguator
residents plus the bitstream cache — persists across context switches.
That state is also exactly what a fault *destroys*: an SEU in a slot, a
failed partial reconfiguration, or a lost core each forces the re-loading
cost LUTstructions quantifies.  This module schedules those faults as
epoch-aligned events the `OnlineReplacer` detects and recovers from:

  * ``core_loss``       — a core goes down (permanent, or transient with a
                          repair delay; a repaired core may come back
                          *degraded*, with fewer usable slots — modelled by
                          `slots.lookup`'s `num_active` masking, bit-for-bit
                          an LRU cache of the smaller size);
  * ``slot_seu``        — a single-event upset corrupts chosen disambiguator
                          residents (`simulator.seu_fleet_state` surgery:
                          the implementations must be re-loaded on next
                          use);
  * ``bitstream_flush`` — the bitstream cache colds
                          (`simulator.flush_bitstream`): every future slot
                          miss re-pays the full re-load penalty;
  * ``reconfig_stall``  — the core's reconfiguration port wedges for a few
                          epochs: migration/reload attempts *to* it fail
                          transiently and retry with capped exponential
                          backoff.

Everything is deterministic: a `FaultPlan` is an explicit event tuple plus
a seed, and any randomness inside an event (which residents an SEU hits)
derives from a counter-based generator keyed on ``(seed, epoch, core)`` —
stateless, so a crash-restarted serve replays the identical storm without
carrying RNG state in its checkpoints.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["FAULT_KINDS", "RECOVERY_POLICIES", "FaultEvent", "FaultPlan"]

FAULT_KINDS = ("core_loss", "slot_seu", "bitstream_flush", "reconfig_stall")

# how the OnlineReplacer reacts to a fault storm:
#   * "none"         — no recovery: tenants on a lost core stall until it
#                      repairs (never, if the loss is permanent);
#   * "cold_restart" — restart everything: stranded tenants are evacuated,
#                      but every core's caches are flushed on any fault
#                      epoch, so the whole fleet re-pays warm-up;
#   * "warm"         — warm-state-aware: only stranded tenants move
#                      (destination chosen through the contention model,
#                      degraded cores down-weighted), surviving cores keep
#                      their warm caches.
RECOVERY_POLICIES = ("none", "cold_restart", "warm")


@dataclass(frozen=True)
class FaultEvent:
    """One epoch-aligned fault.  Only the fields of the event's `kind`
    are meaningful; the rest keep their defaults.

    core_loss:       `permanent` (never repairs) or transient with
                     `repair_epochs` delay; a transient core may come back
                     with `degraded_slots` fewer usable disambiguator
                     slots (its caches come back cold either way — the
                     region was rebuilt).
    slot_seu:        `num_hit` residents corrupted (chosen by the plan's
                     counter-based rng over the occupied entries).
    bitstream_flush: no parameters — the bs cache colds.
    reconfig_stall:  reload/migration attempts targeting the core fail
                     for `stall_epochs` epochs.
    """

    epoch: int
    kind: str
    core: int
    # core_loss
    permanent: bool = False
    repair_epochs: int = 2
    degraded_slots: int = 0
    # slot_seu
    num_hit: int = 1
    # reconfig_stall
    stall_epochs: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}, expected one of "
                f"{FAULT_KINDS}")
        if self.epoch < 0:
            raise ValueError(f"fault epoch must be >= 0, got {self.epoch}")
        if self.core < 0:
            raise ValueError(f"fault core must be >= 0, got {self.core}")
        if self.kind == "core_loss" and not self.permanent \
                and self.repair_epochs < 1:
            raise ValueError(
                f"a transient core_loss needs repair_epochs >= 1, got "
                f"{self.repair_epochs}")
        if self.degraded_slots < 0:
            raise ValueError(
                f"degraded_slots must be >= 0, got {self.degraded_slots}")
        if self.kind == "slot_seu" and self.num_hit < 1:
            raise ValueError(f"slot_seu needs num_hit >= 1, got "
                             f"{self.num_hit}")
        if self.kind == "reconfig_stall" and self.stall_epochs < 1:
            raise ValueError(
                f"reconfig_stall needs stall_epochs >= 1, got "
                f"{self.stall_epochs}")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule: explicit events plus the seed that
    drives every in-event random choice (SEU victim selection).

    `rng(event)` returns a generator keyed on ``(seed, epoch, core)`` —
    counter-based, never carried — so replaying any suffix of the plan
    (e.g. after a checkpoint restore) reproduces the identical storm.
    """

    events: tuple = ()
    seed: int = 0

    def __post_init__(self):
        evs = tuple(self.events)
        for ev in evs:
            if not isinstance(ev, FaultEvent):
                raise TypeError(
                    f"FaultPlan events must be FaultEvent, got {ev!r}")
        # deterministic application order: epoch, then core, then kind
        object.__setattr__(self, "events", tuple(sorted(
            evs, key=lambda e: (e.epoch, e.core, FAULT_KINDS.index(e.kind)))))

    def at(self, epoch: int) -> list[FaultEvent]:
        """The events injected (and detected) at `epoch`, in application
        order."""
        return [e for e in self.events if e.epoch == epoch]

    def horizon(self) -> int:
        """First epoch with no scheduled events after it."""
        return max((e.epoch for e in self.events), default=-1) + 1

    def max_core(self) -> int:
        return max((e.core for e in self.events), default=-1)

    def rng(self, event: FaultEvent) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, event.epoch, event.core,
             FAULT_KINDS.index(event.kind)])

    @classmethod
    def storm(cls, seed: int, num_epochs: int, num_cores: int, *,
              p_core_loss: float = 0.05, p_permanent: float = 0.2,
              repair_epochs: int = 2, p_degrade: float = 0.5,
              p_seu: float = 0.1, max_hit: int = 2,
              p_flush: float = 0.08, p_stall: float = 0.08,
              stall_epochs: int = 2, start_epoch: int = 1) -> "FaultPlan":
        """A seeded random storm over ``[start_epoch, num_epochs)``.

        Per (epoch, core) each fault kind fires independently with its
        probability; core losses are throttled so at least one core stays
        up at every epoch (a fully-dark fleet serves nothing, which makes
        recovery comparisons vacuous).  Same seed -> same storm.
        """
        if num_cores < 1:
            raise ValueError(f"num_cores must be >= 1, got {num_cores}")
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        down_until: dict[int, float] = {}   # core -> epoch it repairs (inf)
        for epoch in range(start_epoch, num_epochs):
            down = {c for c, until in down_until.items() if epoch < until}
            for core in range(num_cores):
                if core in down:
                    continue
                if rng.random() < p_core_loss and len(down) < num_cores - 1:
                    permanent = bool(rng.random() < p_permanent)
                    degraded = (int(rng.integers(1, 3))
                                if (not permanent
                                    and rng.random() < p_degrade) else 0)
                    events.append(FaultEvent(
                        epoch, "core_loss", core, permanent=permanent,
                        repair_epochs=repair_epochs,
                        degraded_slots=degraded))
                    down.add(core)
                    down_until[core] = (np.inf if permanent
                                        else epoch + repair_epochs)
                    continue
                if rng.random() < p_seu:
                    events.append(FaultEvent(
                        epoch, "slot_seu", core,
                        num_hit=int(rng.integers(1, max_hit + 1))))
                if rng.random() < p_flush:
                    events.append(FaultEvent(epoch, "bitstream_flush", core))
                if rng.random() < p_stall:
                    events.append(FaultEvent(
                        epoch, "reconfig_stall", core,
                        stall_epochs=stall_epochs))
        return cls(events=tuple(events), seed=seed)
