"""RISC-V RV32IMF instruction taxonomy used by the paper's evaluation.

The paper (§V-D) partitions the "M" and "F" extension instructions into
reconfigurable-slot *groups* by logic similarity:

  M: {mul, mulh, mulhsu, mulhu} | {div, divu} | {rem, remu}          (3 groups)
  F: {fadd.s, fsub.s} | {fmul.s} | {fdiv.s} |
     {fsgnj.s, fsgnjn.s, fsgnjx.s, fmin.s, fmax.s, fle.s, flt.s, feq.s} |
     {fsqrt.s} | {fcvt.w.s, fcvt.wu.s, fcvt.s.w, fcvt.s.wu} |
     {fmadd.s, fmsub.s, fnmsub.s, fnmadd.s}                           (7 groups)

Three granularity scenarios map instructions onto disambiguator tags:

  scenario 1: tag = instruction id   (8 slots)
  scenario 2: tag = group id         (4 slots)   <- the paper's main scenario
  scenario 3: tag = extension id     (1 slot)

Base RV32I instructions are hardwired and never occupy a slot (tag = -1).

Cycle costs follow §V-A of the paper: base/simple-F ops are 1 cycle, "M" ops
are 4 cycles, F arithmetic units are 6-stage pipelines, and fused
multiply-add chains two of them (12 cycles).

When an extension is absent from a binary's compile target, its instructions
are replaced by ABI soft routines (libgcc/libgcc-soft-float equivalents).
Soft-float cost depends on whether "M" is available in hardware, because
soft-float multiplies dominate; this is exactly why the paper observes
RV32IF ~ RV32IMF for `minver` while RV32IM still beats RV32I on float-heavy
code.  The expansion constants below are calibrated, documented estimates of
dynamic instruction counts of the corresponding libgcc routines.

This module is a verbatim copy of the JAX package's `repro.core.isa` (numpy
only), kept in the port so that the port never imports the JAX package.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Extensions
# ---------------------------------------------------------------------------


class Ext(enum.IntEnum):
    BASE = 0  # RV32I — hardwired, never slotted
    M = 1
    F = 2


# ---------------------------------------------------------------------------
# Instructions (dynamic-trace alphabet)
# ---------------------------------------------------------------------------

# name -> (extension, group name, hardware cycles)
_INSTRUCTION_TABLE = [
    # --- base marker (represents *any* RV32I instruction in traces) ---
    ("base", Ext.BASE, "base", 1),
    # --- M ---
    ("mul", Ext.M, "mul", 4),
    ("mulh", Ext.M, "mul", 4),
    ("mulhsu", Ext.M, "mul", 4),
    ("mulhu", Ext.M, "mul", 4),
    ("div", Ext.M, "div", 4),
    ("divu", Ext.M, "div", 4),
    ("rem", Ext.M, "rem", 4),
    ("remu", Ext.M, "rem", 4),
    # --- F ---
    ("fadd.s", Ext.F, "fadd", 6),
    ("fsub.s", Ext.F, "fadd", 6),
    ("fmul.s", Ext.F, "fmul", 6),
    ("fdiv.s", Ext.F, "fdiv", 6),
    ("fsqrt.s", Ext.F, "fsqrt", 6),
    ("fsgnj.s", Ext.F, "fcmp", 1),
    ("fsgnjn.s", Ext.F, "fcmp", 1),
    ("fsgnjx.s", Ext.F, "fcmp", 1),
    ("fmin.s", Ext.F, "fcmp", 1),
    ("fmax.s", Ext.F, "fcmp", 1),
    ("fle.s", Ext.F, "fcmp", 1),
    ("flt.s", Ext.F, "fcmp", 1),
    ("feq.s", Ext.F, "fcmp", 1),
    ("fcvt.w.s", Ext.F, "fcvt", 6),
    ("fcvt.wu.s", Ext.F, "fcvt", 6),
    ("fcvt.s.w", Ext.F, "fcvt", 6),
    ("fcvt.s.wu", Ext.F, "fcvt", 6),
    ("fmadd.s", Ext.F, "fma", 12),
    ("fmsub.s", Ext.F, "fma", 12),
    ("fnmsub.s", Ext.F, "fma", 12),
    ("fnmadd.s", Ext.F, "fma", 12),
]

NAMES = [t[0] for t in _INSTRUCTION_TABLE]
NUM_INSTRUCTIONS = len(_INSTRUCTION_TABLE)
INSTR_ID = {name: i for i, name in enumerate(NAMES)}

# group taxonomy (paper §V-D scenario 2) — "base" is group 0 and unslotted
GROUP_NAMES = [
    "base",
    "mul", "div", "rem",
    "fadd", "fmul", "fdiv", "fcmp", "fsqrt", "fcvt", "fma",
]
GROUP_ID = {g: i for i, g in enumerate(GROUP_NAMES)}
NUM_GROUPS = len(GROUP_NAMES)
M_GROUPS = ("mul", "div", "rem")
F_GROUPS = ("fadd", "fmul", "fdiv", "fcmp", "fsqrt", "fcvt", "fma")

# per-instruction static arrays (indexed by instruction id)
INSTR_EXT = np.array([int(t[1]) for t in _INSTRUCTION_TABLE], dtype=np.int32)
INSTR_GROUP = np.array(
    [GROUP_ID[t[2]] for t in _INSTRUCTION_TABLE], dtype=np.int32
)
INSTR_HW_CYCLES = np.array([t[3] for t in _INSTRUCTION_TABLE], dtype=np.int32)

GROUP_EXT = np.zeros(NUM_GROUPS, dtype=np.int32)
for _n, _e, _g, _c in _INSTRUCTION_TABLE:
    GROUP_EXT[GROUP_ID[_g]] = int(_e)

# representative hardware cost per *group* (used by the analytic fig-4 model)
GROUP_HW_CYCLES = np.zeros(NUM_GROUPS, dtype=np.float64)
for _g in GROUP_NAMES:
    _ids = [i for i in range(NUM_INSTRUCTIONS) if INSTR_GROUP[i] == GROUP_ID[_g]]
    GROUP_HW_CYCLES[GROUP_ID[_g]] = float(np.mean(INSTR_HW_CYCLES[_ids]))


# ---------------------------------------------------------------------------
# ABI soft-routine expansion model
# ---------------------------------------------------------------------------
# Dynamic cycles consumed when the instruction's extension is NOT in the
# compile target.  Two columns: the soft routine running on an RV32I machine
# (integer mul/div themselves emulated) and on an RV32IM machine (hardware
# integer mul/div available to the float emulation).  Base instructions are
# never expanded.  Values are calibrated dynamic-instruction estimates for
# libgcc's __mulsi3/__divsi3 and the RV32 soft-float routines; see
# EXPERIMENTS.md §Fig4 for the calibration against the paper's numbers.

# group -> cycles of the soft routine on RV32I
SOFT_COST_ON_I = {
    "mul": 38.0,    # __mulsi3: shift-add loop with early exit — index/address
                    # math has small operands, so the dynamic average is far
                    # below the 32-iteration worst case
    "div": 80.0,    # __udivsi3/__divsi3 restoring division
    "rem": 80.0,
    "fadd": 100.0,  # unpack, align, add, normalise, round, pack
    "fmul": 250.0,  # mantissa 32x32->64 via soft mul dominates
    "fdiv": 600.0,  # iterative mantissa divide (soft mul per step)
    "fcmp": 30.0,
    "fsqrt": 900.0, # newton iterations, each with soft mul
    "fcvt": 40.0,
    "fma": 360.0,   # soft fmul + soft fadd (+rounding glue)
}
# group -> cycles of the soft routine on RV32IM (hardware mul/div available)
SOFT_COST_ON_M = {
    "mul": 4.0,     # not expanded — hardware
    "div": 4.0,
    "rem": 4.0,
    "fadd": 60.0,   # alignment/normalisation logic unchanged
    "fmul": 58.0,   # one hardware mulhu + glue
    "fdiv": 150.0,
    "fcmp": 22.0,
    "fsqrt": 320.0,
    "fcvt": 28.0,
    "fma": 125.0,
}

SOFT_ON_I = np.ones(NUM_GROUPS, dtype=np.float64)
SOFT_ON_M = np.ones(NUM_GROUPS, dtype=np.float64)
for _g, _v in SOFT_COST_ON_I.items():
    SOFT_ON_I[GROUP_ID[_g]] = _v
for _g, _v in SOFT_COST_ON_M.items():
    SOFT_ON_M[GROUP_ID[_g]] = _v


# ---------------------------------------------------------------------------
# Compile targets ("specs")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Spec:
    """A compile target / hardware capability set (e.g. RV32IMF)."""

    name: str
    has_m: bool
    has_f: bool

    def group_cost(self) -> np.ndarray:
        """Per-group dynamic cycles under this spec (hardwired machine).

        Used for the fixed-ISA baselines of Fig. 4: no slots, no
        reconfiguration — extension present => hardware cycles, absent =>
        ABI soft-routine cycles.
        """
        cost = GROUP_HW_CYCLES.copy()
        for g in M_GROUPS:
            if not self.has_m:
                cost[GROUP_ID[g]] = SOFT_ON_I[GROUP_ID[g]]
        for g in F_GROUPS:
            if not self.has_f:
                src = SOFT_ON_M if self.has_m else SOFT_ON_I
                cost[GROUP_ID[g]] = src[GROUP_ID[g]]
        return cost


RV32I = Spec("RV32I", has_m=False, has_f=False)
RV32IM = Spec("RV32IM", has_m=True, has_f=False)
RV32IF = Spec("RV32IF", has_m=False, has_f=True)
RV32IMF = Spec("RV32IMF", has_m=True, has_f=True)
SPECS = {s.name: s for s in (RV32I, RV32IM, RV32IF, RV32IMF)}


# ---------------------------------------------------------------------------
# Slot-granularity scenarios (paper §V-D)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SlotScenario:
    """Maps every instruction id to a disambiguator tag; -1 = unslotted."""

    name: str
    num_slots: int
    instr_tag: np.ndarray = field(repr=False)  # (NUM_INSTRUCTIONS,) int32

    @property
    def num_tags(self) -> int:
        return int(self.instr_tag.max()) + 1


def _scenario_tags(level: str) -> np.ndarray:
    tags = np.full(NUM_INSTRUCTIONS, -1, dtype=np.int32)
    if level == "instruction":
        nxt = 0
        for i in range(NUM_INSTRUCTIONS):
            if INSTR_EXT[i] != Ext.BASE:
                tags[i] = nxt
                nxt += 1
    elif level == "group":
        # group ids start at 1 ("base" is 0); shift to dense 0..9
        for i in range(NUM_INSTRUCTIONS):
            if INSTR_EXT[i] != Ext.BASE:
                tags[i] = INSTR_GROUP[i] - 1
    elif level == "extension":
        for i in range(NUM_INSTRUCTIONS):
            if INSTR_EXT[i] == Ext.M:
                tags[i] = 0
            elif INSTR_EXT[i] == Ext.F:
                tags[i] = 1
    else:
        raise ValueError(level)
    return tags


def make_scenario(level: str, num_slots: int, name: str | None = None) -> SlotScenario:
    return SlotScenario(
        name=name or f"{num_slots}slot/{level}",
        num_slots=num_slots,
        instr_tag=_scenario_tags(level),
    )


# the three scenarios of §V-D
SCENARIO_1 = make_scenario("instruction", 8, "S1: 8 slots, 1/instr")
SCENARIO_2 = make_scenario("group", 4, "S2: 4 slots, 1/group")
SCENARIO_3 = make_scenario("extension", 1, "S3: 1 slot, 1/ext")

# fig-7 slot-count variations of scenario 2
SCENARIO_2_2SLOT = make_scenario("group", 2, "S2v: 2 slots, 1/group")
SCENARIO_2_8SLOT = make_scenario("group", 8, "S2v: 8 slots, 1/group")

SCENARIOS = {
    "s1": SCENARIO_1,
    "s2": SCENARIO_2,
    "s3": SCENARIO_3,
    "s2_2slot": SCENARIO_2_2SLOT,
    "s2_8slot": SCENARIO_2_8SLOT,
}
