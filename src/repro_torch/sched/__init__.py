"""repro_torch.sched — scheduling policy, contention-aware placement &
admission: the PyTorch port of `repro.sched`, with the same public names.

Layer 2 of the multi-program scheduling subsystem.  Layer 1 (the simulator)
models *how* co-resident programs share one reconfigurable core —
heterogeneous quanta and weighted round-robin priorities, swept as grid
axes by `repro_torch.core.simulator.sweep_fleet`.  This package decides *which*
programs should share a core in the first place:

  * `policy`    — named scheduling policies (uniform / weighted /
                  foreground-background) that compile down to
                  `SchedulerConfig`s, plus quantum-grid builders for the
                  sweep's quanta axis;
  * `placement` — `ContentionModel` batch-predicts per-tenant slowdowns for
                  candidate co-residency groups through `sweep_fleet`, and
                  `place_tenants` assigns T tenants to C cores with greedy
                  seeding + swap local search minimising predicted
                  worst-tenant (then mean) contention;
  * `admission` — `AdmissionController` wraps placement with an
                  admit/defer decision at a slowdown SLO (per-tenant SLO
                  weights bias the deferral order so foreground tenants
                  are protected); the serve layer
                  (`repro_torch.serve.engine.SlotServeEngine.plan_coresidency`)
                  uses it to pick co-residents instead of taking tenant
                  order as given;
  * `online`    — `OnlineReplacer` serves an arrival/departure event
                  stream in epochs over the resumable fleet state
                  (`simulator.FleetState`), re-solving placement each
                  epoch and pricing each move as predicted contention
                  delta minus a *measured* warm-state migration penalty
                  (resume-on-cold-core probe);
                  `SlotServeEngine.serve_online` is the serving entry;
  * `topology`  — `Topology` places the cores within sockets within
                  hosts: each host is an independently (and
                  incrementally) re-solved placement domain, and moves
                  crossing a socket or host pay a LUTstructions-style
                  bitstream re-load surcharge on top of the measured
                  probe (`place_fleet` is the static per-host entry);
  * `faults`    — deterministic fault injection for the online loop: a
                  seeded `FaultPlan` schedules epoch-aligned core losses,
                  slot SEUs, bitstream flushes and reconfig stalls, which
                  the `OnlineReplacer` detects and recovers from
                  (warm-state-aware evacuation vs cold-restart vs none).

The host logic (search, logs, reports, snapshots) is the reference's numpy
and Python, so its float64 arithmetic is the same; the simulations run
through the port's simulator on the caller's `device` (default "cuda").
"""
from repro_torch.sched.admission import AdmissionController, AdmissionDecision
from repro_torch.sched.faults import (FAULT_KINDS, RECOVERY_POLICIES,
                                      FaultEvent, FaultPlan)
from repro_torch.sched.online import (RESOLVE_MODES, OnlineConfig,
                                      OnlineReplacer, OnlineReport,
                                      TenantEvent)
from repro_torch.sched.placement import (ContentionModel, Placement,
                                         PlacementConfig, fifo_placement,
                                         place_fleet, place_tenants,
                                         random_placement, score_placement)
from repro_torch.sched.policy import PriorityPolicy, quantum_grid
from repro_torch.sched.topology import DISTANCES, Topology

__all__ = [
    "AdmissionController", "AdmissionDecision",
    "ContentionModel", "Placement", "PlacementConfig",
    "fifo_placement", "place_fleet", "place_tenants", "random_placement",
    "score_placement",
    "OnlineConfig", "OnlineReplacer", "OnlineReport", "TenantEvent",
    "RESOLVE_MODES",
    "FAULT_KINDS", "RECOVERY_POLICIES", "FaultEvent", "FaultPlan",
    "DISTANCES", "Topology",
    "PriorityPolicy", "quantum_grid",
]
