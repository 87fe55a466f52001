"""Admission control at a contention SLO.  PyTorch port of
`repro.sched.admission` (host logic as the reference's; predictions from
the port's `ContentionModel` on its device).

The placement layer finds the least-contended assignment of tenants to
cores; admission control decides whether even that best assignment is good
enough.  `AdmissionController` places the offered tenant set, compares the
predicted worst-tenant slowdown against a service-level objective, and —
when the SLO is violated — defers the most contended tenant and re-places
the rest, iterating until the remaining set fits (or nothing does).
Deferred tenants are reported so the serve layer can queue them for a later
round instead of letting one bad co-residency blow every tenant's latency.
Per-tenant SLO weights (`decide(..., slo_weights=...)`) bias the deferral
order so foreground tenants are protected and batch tenants absorb the
contention.

This is the serving-level realisation of the ROADMAP item "wire
`estimate_fleet_contention` into serve admission control": predictions come
from the same fleet machinery, batched through
`repro_torch.sched.placement.ContentionModel`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.sched.placement import (ContentionModel, Placement,
                                         place_tenants)

__all__ = ["AdmissionController", "AdmissionDecision"]


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one admission round."""

    admitted: tuple[str, ...]          # tenant names, placement order
    deferred: tuple[str, ...]          # names deferred, worst-first
    placement: Placement | None        # placement of the admitted set
    predicted_worst: float             # nan when nothing was admitted
    slo: float
    slo_weights: dict | None = None    # per-tenant weights used (if any)

    @property
    def admitted_all(self) -> bool:
        return not self.deferred

    def core_of(self, name: str) -> int:
        """Core index an admitted tenant landed on (-1 if deferred)."""
        if self.placement is not None:
            for ci, core in enumerate(self.placement.cores):
                if name in core:
                    return ci
        return -1


class AdmissionController:
    """Admit/defer tenants so predicted worst-tenant slowdown meets an SLO.

    `slo` is the largest acceptable contention slowdown (fleet CPI over
    unpreempted solo CPI) for ANY admitted tenant — e.g. 1.5 means "no
    tenant runs more than 50% slower than it would alone on a core".
    Without a `model`, one is made on `device` (default "cuda").
    """

    def __init__(self, *, slo: float = 1.5, num_cores: int = 2,
                 model: ContentionModel | None = None,
                 max_rounds: int = 8, device="cuda"):
        if slo <= 0:
            raise ValueError(f"slo must be positive, got {slo}")
        if num_cores < 1:
            raise ValueError(f"num_cores must be >= 1, got {num_cores}")
        self.slo = float(slo)
        self.num_cores = num_cores
        self.model = model or ContentionModel(device=device)
        self.max_rounds = max_rounds

    def decide(self, tenants: dict[str, str],
               slo_weights: dict[str, float] | None = None
               ) -> AdmissionDecision:
        """tenants: name -> benchmark profile.  Defers greedily: while the
        best placement still violates the SLO, a victim is deferred and the
        rest are re-placed.

        `slo_weights` (optional, name -> positive weight, default 1.0)
        makes the deferral priority-aware: the victim maximises the
        *weighted violation* `predicted_slowdown / weight`, so a heavy
        foreground tenant (weight 4) tolerates 4x the contention of a unit
        batch tenant before it becomes the deferral candidate — foreground
        tenants are protected while batch tenants absorb the contention.
        The admit condition itself stays the unweighted worst-slowdown SLO
        (an admitted set must be good for everyone it serves).
        """
        weights = dict(slo_weights or {})
        for n, w in weights.items():
            if n not in tenants:
                raise ValueError(
                    f"slo_weights names unknown tenant {n!r} (offered: "
                    f"{sorted(tenants)})")
            if not w > 0:
                raise ValueError(
                    f"slo_weights must be positive, got {w!r} for {n!r}")
        work = dict(tenants)
        deferred: list[str] = []
        while work:
            pl = place_tenants(work, min(self.num_cores, len(work)),
                               self.model, max_rounds=self.max_rounds)
            if pl.worst_slowdown <= self.slo:
                admitted = tuple(n for core in pl.cores for n in core)
                return AdmissionDecision(
                    admitted=admitted, deferred=tuple(deferred),
                    placement=pl, predicted_worst=pl.worst_slowdown,
                    slo=self.slo, slo_weights=slo_weights)
            victim = max(work, key=lambda n: (
                pl.tenant_slowdown[n] / weights.get(n, 1.0), n))
            deferred.append(victim)
            del work[victim]
        return AdmissionDecision(admitted=(), deferred=tuple(deferred),
                                 placement=None,
                                 predicted_worst=math.nan, slo=self.slo,
                                 slo_weights=slo_weights)
