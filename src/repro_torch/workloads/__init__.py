"""Model-zoo workloads: configs -> instruction mixes -> servable traces.

PyTorch port of `repro.workloads`, with the reference's names, rules and
error texts.  The pipeline:

    repro_torch.configs arch ──count smoke prefill/decode (CPU)──▶
        aten ops (`opcounts.opcount_from_torch`)
        ──opcounts.model_opcount──▶ OpCount mix table
        ──lowering.spec_from_opcount──▶ WorkloadSpec
        ──spec.build_trace──▶ isa-alphabet tag stream

Workload names are ``"<arch>:<phase>"`` (phase in {prefill, decode}),
disjoint from Embench bench names by construction (no Embench name
contains a colon).  `resolve_trace` is the single entry point the sched
and serve layers use to turn *either* kind of tenant name into a trace;
`ContentionModel.trace` and `serve.engine.estimate_fleet_contention`
route through it, which is what lets `place_tenants`, `OnlineReplacer`,
and `FaultPlan.storm` chaos serves take a model-zoo fleet unchanged.

Registry entries are built lazily and cached: constructing a spec
counts the arch's smoke config (~0.1-3 s), so nothing runs until a
workload name is actually used.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import traces as core_traces
from repro_torch.workloads import opcounts
from repro_torch.workloads.lowering import (PHASE_KNOBS, WorkloadSpec,
                                           spec_from_opcount)
from repro_torch.workloads.opcounts import OpCount, model_opcount

__all__ = [
    "OpCount", "WorkloadSpec", "model_opcount", "spec_from_opcount",
    "workload_name", "is_workload_name", "get_workload", "list_workloads",
    "build_trace", "resolve_trace", "mix_table_rows", "PHASES",
]

PHASES = opcounts.PHASES

_SPECS: dict[str, WorkloadSpec] = {}


def workload_name(arch: str, phase: str) -> str:
    return f"{arch}:{phase}"


def _known_archs() -> tuple:
    from repro_torch.configs import base as cb

    cb.load_all()
    return tuple(cb.ARCH_IDS)


def is_workload_name(name: str) -> bool:
    """Syntactic check only — does not count anything."""
    if ":" not in name:
        return False
    arch, _, phase = name.rpartition(":")
    return phase in PHASES and arch in _known_archs()


def get_workload(name: str) -> WorkloadSpec:
    """Resolve (lazily building + caching) a workload spec by name."""
    if name not in _SPECS:
        if not is_workload_name(name):
            raise ValueError(
                f"unknown workload {name!r}: expected '<arch>:<phase>' with "
                f"arch in {_known_archs()} and phase in {PHASES}")
        arch, _, phase = name.rpartition(":")
        _SPECS[name] = spec_from_opcount(
            arch, phase, model_opcount(arch, phase))
    return _SPECS[name]


def list_workloads(phases=PHASES) -> list:
    """All registry names for the full zoo (nothing is counted)."""
    return [workload_name(a, p) for a in _known_archs() for p in phases]


def build_trace(name: str, length: int = 200_000, seed: int = 0) -> np.ndarray:
    return get_workload(name).build_trace(length=length, seed=seed)


def resolve_trace(name: str, length: int = 200_000,
                  seed: int = 0) -> np.ndarray:
    """Name -> trace for Embench benches *and* model-zoo workloads.

    The single resolution point the sched/serve layers call: Embench
    names pass through to `core.traces.build_trace` bit-for-bit
    unchanged; '<arch>:<phase>' names lower through the workloads
    registry; anything else raises a ValueError naming both valid sets.
    """
    if name in core_traces.BENCHES:
        return core_traces.build_trace(name, length=length, seed=seed)
    if is_workload_name(name):
        return build_trace(name, length=length, seed=seed)
    raise ValueError(
        f"unknown tenant name {name!r}: expected an Embench bench "
        f"({sorted(core_traces.BENCHES)}) or a model-zoo workload "
        f"'<arch>:<phase>' with arch in {_known_archs()} and phase in "
        f"{PHASES}")


def mix_table_rows(names=None) -> tuple:
    """(header, rows) for the workload_mix.csv serialization.

    One row per workload: raw accounting (flops / bytes / transcendental
    elements) plus the per-isa-group stationary fractions.  Building a
    row counts that workload's phase step if it is not cached yet.
    """
    from repro_torch.core import isa

    if names is None:
        names = list_workloads()
    header = (["workload", "arch", "phase", "flops", "bytes",
               "transcendental_elems"]
              + [f"frac_{g}" for g in isa.GROUP_NAMES])
    rows = []
    for name in names:
        spec = get_workload(name)
        oc = spec.opcount
        rows.append([name, spec.arch, spec.phase,
                     f"{oc.flops:.0f}", f"{oc.bytes:.0f}",
                     f"{oc.transcendental_elems:.0f}"]
                    + [f"{x:.6f}" for x in spec.frac])
    return header, rows
