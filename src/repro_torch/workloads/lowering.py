"""Deterministic trace lowering: instruction-mix tables -> tag/cost streams.

PyTorch port of `repro.workloads.lowering`, line for line: the painter
is `repro_torch.core.traces.paint_trace` (numpy, crc32-seeded), so given
the same `OpCount` a spec and its traces are the reference's bit for
bit.

A `WorkloadSpec` pairs an `OpCount`-derived stationary mix with the
loop-structure knobs `core.traces.paint_trace` needs to lay that mix out
in time.  The knobs are *phase-derived*, mirroring how the two serving
phases actually execute:

  * **prefill** — dense GEMM bursts: long contiguous F runs
    (`f_run_len=8`), tight cold-event spacing, no sporadic spreading.
    Prefill tenants lower F-hot and slot-hungry.
  * **decode** — memory-bound single-token steps: short F runs
    (`f_run_len=2`), wider cold-event spacing, sporadic spreading (op
    clusters separated by base/load-store tails).  Decode tenants lower
    base-heavy and co-reside cheaply.

The painter is the *same code path* Embench traces use, so lowered
traces inherit the whole contract for free: crc32-seeded process
determinism (bit-for-bit across machines and PYTHONHASHSEED values),
the `repro_torch.core.isa` alphabet (29 tags < `bs_cache_entries=64`, so the
stackdist warm path stays eligible), and scenario compatibility — the
fast-path engines (`stackdist`, `stackdist_interleaved`) dispatch on
these traces exactly as they do on Embench ones.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import isa, traces as core_traces
from repro_torch.workloads.opcounts import OpCount

# phase -> paint_trace loop-structure knobs
PHASE_KNOBS = {
    "prefill": {"f_run_len": 8, "cold_event_period": 64, "sporadic": False},
    "decode": {"f_run_len": 2, "cold_event_period": 96, "sporadic": True},
}


@dataclass(frozen=True)
class WorkloadSpec:
    """A lowered model-zoo workload: registry entry + trace factory.

    Frozen so specs can key caches (the `ContentionModel` caches traces
    and solo CPIs per tenant name; a spec must never mutate under it).
    """

    name: str            # "<arch>:<phase>", e.g. "qwen1.5-4b:prefill"
    arch: str
    phase: str
    frac: tuple          # (NUM_GROUPS,) stationary mix, as a hashable tuple
    opcount: OpCount
    hot_f_groups: tuple
    cold_event_period: int
    f_run_len: int
    sporadic: bool

    def mix(self) -> np.ndarray:
        return np.asarray(self.frac, dtype=np.float64)

    def build_trace(self, length: int = 200_000, seed: int = 0) -> np.ndarray:
        """Instruction-id trace realising this spec's mix.

        Same signature and determinism contract as
        `core.traces.build_trace`; the seed key is namespaced with "wl:"
        so a workload can never collide with an Embench bench stream.
        """
        return core_traces.paint_trace(
            self.mix(), length=length, seed_key=f"wl:{self.name}:{seed}",
            hot_f_groups=self.hot_f_groups,
            cold_event_period=self.cold_event_period,
            f_run_len=self.f_run_len, sporadic=self.sporadic)


def spec_from_opcount(arch: str, phase: str, oc: OpCount) -> WorkloadSpec:
    """Derive the full spec: mix from accounting, knobs from the phase."""
    if phase not in PHASE_KNOBS:
        raise ValueError(
            f"phase must be one of {tuple(PHASE_KNOBS)}, got {phase!r}")
    frac = oc.frac()
    # hottest two F groups carry the inner loop (the painter rotates the
    # rest as spaced cold events); ties break lexicographically so the
    # spec — and hence the trace — is deterministic
    by_weight = sorted(
        ((float(frac[isa.GROUP_ID[g]]), g) for g in isa.F_GROUPS
         if frac[isa.GROUP_ID[g]] > 0),
        key=lambda t: (-t[0], t[1]))
    hot = tuple(g for _, g in by_weight[:2])
    knobs = PHASE_KNOBS[phase]
    return WorkloadSpec(
        name=f"{arch}:{phase}", arch=arch, phase=phase,
        frac=tuple(float(x) for x in frac), opcount=oc,
        hot_f_groups=hot, cold_event_period=knobs["cold_event_period"],
        f_run_len=knobs["f_run_len"], sporadic=knobs["sporadic"])
