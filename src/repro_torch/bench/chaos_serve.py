"""§Faults — online serving under a fault storm: recovery-policy study.

PyTorch port of `benchmarks/chaos_serve.py`, on `device`: seedable
segments resume through the interleaved engine (`window_cell` on the
card); segments after an SEU or a flush, and every segment of the
degraded core, take the reference machine (`simulator._scan_lanes`), as
in the reference.  The rows equal the reference's as text.

The online_churn scenario (FM-class tenants forced apart by arrival
order, light M-class churn around them) is re-served under a curated
fault storm (`repro_torch.sched.faults.FaultPlan`): a transient core loss that
repairs *degraded* (one fewer usable slot), a double slot-SEU, a
bitstream-cache flush, and a reconfiguration-port stall.  Three recovery
policies face the identical storm (same seed, same events, same shared
`ContentionModel`):

  * `none`         — stranded tenants stall until their core repairs;
  * `cold_restart` — stranded tenants evacuate, but every surviving
    core's caches are flushed on each fault epoch (restart-everything);
  * `warm`         — only stranded tenants move (destination picked
    through the contention model, degraded cores priced at their reduced
    width); surviving cores keep their warm slot/bitstream state.

Scored on *lifetime* slowdown: stranded epochs charge the denied service
(epoch_steps x solo CPI) as stall, so "park the tenant and wait" is
visible instead of free.  Acceptance (asserted): warm recovery's
worst-tenant lifetime slowdown <= cold_restart's and <= none's, with
bounded migrations; and a serve crash-restarted from a mid-run
`FleetState` checkpoint reproduces the uninterrupted serve bit-for-bit.

    PYTHONPATH=src python -m repro_torch.bench --only chaos_serve
"""
from __future__ import annotations

import time

from repro_torch.sched import (ContentionModel, FaultEvent, FaultPlan,
                               OnlineConfig, OnlineReplacer, PlacementConfig,
                               TenantEvent)

PCFG = PlacementConfig(num_slots=4, miss_latency=50, quantum_cycles=2_000,
                       trace_len=4_000, steps_per_program=4_000)
CFG = OnlineConfig(num_cores=3, epoch_steps=8_000, probe_steps=2_000,
                   placement=PCFG)
NUM_EPOCHS = 12

EVENTS = [
    TenantEvent(0, "arrive", "fgA", "minver"),
    TenantEvent(0, "arrive", "fgB", "cubic"),
    TenantEvent(0, "arrive", "m1", "qrduino"),
    TenantEvent(1, "arrive", "m2", "edn"),
    TenantEvent(1, "arrive", "m3", "crc32"),
    TenantEvent(2, "arrive", "m4", "tarfind"),
    TenantEvent(5, "depart", "m3"),
    TenantEvent(5, "arrive", "m5", "tarfind"),
]

# the storm: every fault kind fires once, after the roster settles.  The
# core loss is transient but repairs degraded (3 of 4 slots usable), so
# the masked-slot path and the width-aware contention pricing are both on
# the measured path.
FAULTS = FaultPlan(events=(
    FaultEvent(3, "core_loss", 1, repair_epochs=3, degraded_slots=1),
    FaultEvent(4, "slot_seu", 0, num_hit=2),
    FaultEvent(5, "bitstream_flush", 2),
    FaultEvent(6, "reconfig_stall", 0, stall_epochs=2),
), seed=7)

CHECKPOINT_EPOCH = 6      # crash-restart parity is checked from here


def _serve(model, recovery, *, snap_box=None):
    rep = OnlineReplacer(CFG, model=model, policy="warm", faults=FAULTS,
                         recovery=recovery, device=model.device)
    if snap_box is None:
        return rep.run(EVENTS, NUM_EPOCHS)
    return rep.run(EVENTS, NUM_EPOCHS,
                   checkpoint_every=CHECKPOINT_EPOCH,
                   save_fn=lambda s, e: snap_box.setdefault(e, s))


def _report_key(rep):
    """Everything the serve produced, as a comparable value."""
    return (rep.migrations, rep.evacuations, rep.per_tenant,
            rep.final_cores, rep.moves, rep.epoch_log, rep.fault_log,
            rep.worst_slowdown, rep.worst_lifetime_slowdown)


def run(device="cuda") -> tuple[list[str], dict]:
    model = ContentionModel(PCFG, device=device)
    rows = ["recovery,worst_lifetime_slowdown,worst_slowdown,"
            "migrations,evacuations,faults,retries"]
    out: dict = {}
    snaps: dict = {}
    for recovery in ("none", "cold_restart", "warm"):
        rep = _serve(model, recovery,
                     snap_box=snaps if recovery == "warm" else None)
        out[recovery] = rep
        retries = sum(1 for f in rep.fault_log
                      if f["kind"] == "reconfig_retry")
        wl = rep.worst_lifetime_slowdown
        rows.append(f"{recovery},{wl:.4f},{rep.worst_slowdown:.4f},"
                    f"{rep.migrations},{rep.evacuations},"
                    f"{len(FAULTS.events)},{retries}")
    warm = out["warm"]
    cold = out["cold_restart"]
    none = out["none"]
    # acceptance: warm-state-aware recovery beats both baselines on
    # worst-tenant lifetime slowdown under the identical storm, with
    # bounded migrations (evacuations are mandatory, not counted)
    assert warm.worst_lifetime_slowdown <= cold.worst_lifetime_slowdown \
        + 1e-9, (warm.worst_lifetime_slowdown,
                 cold.worst_lifetime_slowdown)
    assert warm.worst_lifetime_slowdown <= none.worst_lifetime_slowdown \
        + 1e-9, (warm.worst_lifetime_slowdown,
                 none.worst_lifetime_slowdown)
    assert warm.migrations <= CFG.max_moves_per_epoch * NUM_EPOCHS
    assert warm.evacuations >= 1, "the core loss must force an evacuation"

    # crash-restart: restore the mid-run checkpoint into a *fresh*
    # replacer (fresh ContentionModel too — nothing carries over) and
    # finish the serve; every report field must match bit-for-bit
    assert snaps, "the warm serve must have checkpointed"
    epoch, snap = sorted(snaps.items())[0]
    rep2 = OnlineReplacer(CFG, model=ContentionModel(PCFG, device=device),
                          policy="warm", faults=FAULTS, recovery="warm",
                          device=device)
    rep2.restore(snap)
    resumed = rep2.run(EVENTS, NUM_EPOCHS)
    assert _report_key(resumed) == _report_key(warm), (
        "crash-restart diverged from the uninterrupted serve")
    rows.append(f"# crash-restart from epoch {epoch} checkpoint: "
                f"bit-for-bit match")

    evac = [f for f in warm.fault_log if f["kind"] == "evacuation"]
    rows.append(
        f"# finding warm-aware recovery: worst lifetime slowdown "
        f"{warm.worst_lifetime_slowdown:.4f} vs cold_restart "
        f"{cold.worst_lifetime_slowdown:.4f} and none "
        f"{none.worst_lifetime_slowdown:.4f} under the same "
        f"{len(FAULTS.events)}-event storm; {warm.evacuations} "
        f"evacuation(s) (max cold-resume "
        f"{max((f['cold_resume_cycles'] for f in evac), default=0):.0f} "
        f"cycles), {warm.migrations} migration(s); crash-restart from "
        f"epoch {epoch} reproduced the serve bit-for-bit")
    return rows, out


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    rows, _ = run(device)
    for r in rows:
        print_fn(r)
    print_fn(f"# chaos_serve done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
