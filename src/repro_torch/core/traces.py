"""Embench-calibrated workload model and dynamic-trace synthesis.

The paper evaluates an adapted Embench 1.0 suite (22 benchmarks, §V-C) on a
RISC-V softcore.  Embench itself cannot execute in this environment, so we
model each benchmark as

  * a *dynamic instruction mix*: fractions of M-class / F-class operations
    (with per-group weights), solved so the analytic fixed-ISA model
    (`repro_torch.core.simulator.analytic_cpi`) reproduces the paper's published
    speedups (Fig. 4/5) exactly where stated and plausible class-consistent
    values elsewhere — every number of the latter kind is marked
    `synthesized=True` below and called out in EXPERIMENTS.md;
  * a *loop structure* used to synthesise instruction-level traces for the
    slot simulator: a repeating superblock with (a) hot F-group runs, (b)
    interleaved index/address `mul` events inside the hot loop, and (c)
    periodic "cold" group events (pivot divisions, conversions, compares),
    which is what produces the three miss regimes the paper measures across
    its slot-granularity scenarios (§V-D, Fig. 6).

Traces are synthesised with a seeded numpy Generator at *instruction*
granularity over the `repro_torch.core.isa` alphabet, then consumed by the
simulator's engines.  This module is a copy of the JAX package's
`repro.core.traces` (numpy only): the port keeps its own so that it never
imports the JAX package, and its traces are array-equal to the reference's.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core import isa

# ---------------------------------------------------------------------------
# Benchmark catalogue
# ---------------------------------------------------------------------------

FM_CLASS = "improved_by_F_and_M"
M_CLASS = "improved_by_M"
INSENSITIVE = "insensitive"


@dataclass(frozen=True)
class BenchSpec:
    name: str
    cls: str
    # calibration targets: speedup of RV32IM / RV32IF over RV32I.
    target_speedup_m: float
    target_speedup_f: float
    # nominal RV32IMF runtime in Mcycles (Fig. 4 bar magnitude)
    imf_mcycles: float
    # per-extension group weight vectors (normalised inside solve_mix)
    w_m: dict = field(default_factory=lambda: {"mul": 1.0})
    w_f: dict = field(default_factory=dict)
    # loop-structure knobs for trace synthesis
    hot_f_groups: tuple = ()       # groups kept hot in the inner loop
    cold_event_period: int = 64    # instrs between cold-group events
    f_run_len: int = 4             # contiguous F ops per burst
    mul_period: int = 12           # instrs between index-mul events (FM cls)
    sporadic: bool = False         # F usage is spread out (st, wikisort)
    # if set, pin the M-op dynamic fraction (index/RNG integer mul rate seen
    # in the compiled loop) and let the RV32IM speedup emerge from the model
    x_m_fixed: float | None = None
    # whether targets are invented (not stated in the paper text)
    synthesized: bool = True


def _b(*args, **kw) -> BenchSpec:
    return BenchSpec(*args, **kw)


# The five FM-class benchmarks (paper Fig. 5).  minver's 27.5x "F" speedup and
# wikisort's 2.9x collective RV32IMF speedup are stated in the text; the rest
# are class-consistent synthesized targets.
_FM = [
    _b("minver", FM_CLASS, 0.0, 27.5, 77.0,
       w_m={"mul": 0.9, "div": 0.1},
       w_f={"fadd": 0.28, "fmul": 0.33, "fdiv": 0.20, "fcmp": 0.09,
            "fcvt": 0.04, "fma": 0.06},
       hot_f_groups=("fadd", "fmul"), cold_event_period=56,
       f_run_len=4, mul_period=11, x_m_fixed=0.006, synthesized=False),
    _b("wikisort", FM_CLASS, 2.0, 1.55, 180.0,
       w_m={"mul": 0.85, "div": 0.15},
       w_f={"fcmp": 0.55, "fadd": 0.27, "fmul": 0.18},
       hot_f_groups=("fcmp", "fadd"), cold_event_period=90,
       f_run_len=1, mul_period=14, sporadic=True, synthesized=False),
    _b("st", FM_CLASS, 0.0, 4.0, 120.0,
       w_m={"mul": 1.0},
       w_f={"fadd": 0.45, "fmul": 0.35, "fdiv": 0.05, "fsqrt": 0.02,
            "fcmp": 0.05, "fcvt": 0.08},
       hot_f_groups=("fadd", "fmul"), cold_event_period=70,
       f_run_len=1, mul_period=13, sporadic=True, x_m_fixed=0.090),
    _b("nbody", FM_CLASS, 0.0, 4.5, 310.0,
       w_m={"mul": 1.0},
       w_f={"fadd": 0.35, "fmul": 0.38, "fdiv": 0.08, "fsqrt": 0.05,
            "fma": 0.14},
       hot_f_groups=("fadd", "fmul"), cold_event_period=60,
       f_run_len=1, mul_period=12, x_m_fixed=0.085),
    _b("cubic", FM_CLASS, 0.0, 5.0, 90.0,
       w_m={"mul": 0.95, "div": 0.05},
       w_f={"fadd": 0.30, "fmul": 0.33, "fdiv": 0.15, "fcvt": 0.05,
            "fma": 0.10, "fsqrt": 0.07},
       hot_f_groups=("fadd", "fmul"), cold_event_period=80,
       f_run_len=1, mul_period=12, x_m_fixed=0.090),
]

# Eight M-only benchmarks; matmult-int's 4.6x is stated in the text.
_M = [
    _b("matmult-int", M_CLASS, 4.6, 1.0, 150.0,
       w_m={"mul": 1.0}, f_run_len=1, mul_period=8, synthesized=False),
    _b("crc32", M_CLASS, 1.35, 1.0, 30.0, w_m={"mul": 1.0}, mul_period=24),
    _b("qrduino", M_CLASS, 1.8, 1.0, 70.0,
       w_m={"mul": 0.8, "rem": 0.2}, mul_period=16),
    _b("primecount", M_CLASS, 2.1, 1.0, 250.0,
       w_m={"div": 0.45, "rem": 0.45, "mul": 0.10}, mul_period=14),
    _b("ud", M_CLASS, 2.4, 1.0, 45.0,
       w_m={"mul": 0.75, "div": 0.25}, mul_period=12),
    _b("aha-mont64", M_CLASS, 3.0, 1.0, 160.0,
       w_m={"mul": 1.0}, mul_period=9),
    _b("tarfind", M_CLASS, 1.5, 1.0, 60.0, w_m={"mul": 1.0}, mul_period=22),
    _b("edn", M_CLASS, 3.4, 1.0, 110.0, w_m={"mul": 1.0}, mul_period=9),
]

# Nine insensitive benchmarks (control-heavy; negligible M/F usage).
_INS = [
    _b(n, INSENSITIVE, 1.0, 1.0, mc, w_m={"mul": 1.0}, mul_period=400)
    for n, mc in [
        ("md5sum", 25.0), ("huffbench", 95.0), ("nettle-aes", 140.0),
        ("nettle-sha256", 85.0), ("nsichneu", 55.0), ("picojpeg", 210.0),
        ("sglib-combined", 130.0), ("slre", 75.0), ("statemate", 20.0),
    ]
]

BENCHES: dict[str, BenchSpec] = {b.name: b for b in _FM + _M + _INS}
FM_BENCHES = [b.name for b in _FM]
M_BENCHES = [b.name for b in _M]
INSENSITIVE_BENCHES = [b.name for b in _INS]

assert len(BENCHES) == 22


# ---------------------------------------------------------------------------
# Mix solving (fixed-ISA analytic model -> paper Fig. 4 targets)
# ---------------------------------------------------------------------------


def _group_vec(weights: dict) -> np.ndarray:
    v = np.zeros(isa.NUM_GROUPS)
    total = sum(weights.values())
    for g, w in weights.items():
        v[isa.GROUP_ID[g]] = w / total
    return v


@dataclass(frozen=True)
class Mix:
    """Solved dynamic instruction mix: fraction per isa group (sums to 1)."""

    bench: str
    frac: np.ndarray  # (NUM_GROUPS,) fractions over groups; [0] is base

    @property
    def x_m(self) -> float:
        return float(sum(self.frac[isa.GROUP_ID[g]] for g in isa.M_GROUPS))

    @property
    def x_f(self) -> float:
        return float(sum(self.frac[isa.GROUP_ID[g]] for g in isa.F_GROUPS))


def analytic_cpi(mix: Mix, spec: isa.Spec) -> float:
    """Cycles per (original RV32IMF) instruction under a fixed-ISA machine."""
    return float(mix.frac @ spec.group_cost())


def solve_mix(bench: BenchSpec) -> Mix:
    """Solve (x_m, x_f) so RV32IM/RV32IF speedups over RV32I hit the targets.

    Linear system: with per-extension aggregate costs a_* (M groups) and b_*
    (F groups) under each spec,
        T_I  = 1 + x_m (a_I - 1) + x_f (b_I - 1)
        T_IM = 1 + x_m (a_M - 1) + x_f (b_M - 1)
        T_IF = 1 + x_m (a_I - 1) + x_f (b_F - 1)
    and s_m T_IM = T_I,  s_f T_IF = T_I.
    """
    wm = _group_vec(bench.w_m)
    wf = _group_vec(bench.w_f) if bench.w_f else np.zeros(isa.NUM_GROUPS)

    def agg(vec, cost):
        s = vec.sum()
        return float(vec @ cost) / s if s else 1.0

    a_i = agg(wm, isa.SOFT_ON_I)
    a_m = agg(wm, isa.GROUP_HW_CYCLES)
    b_i = agg(wf, isa.SOFT_ON_I)
    b_m = agg(wf, isa.SOFT_ON_M)
    b_f = agg(wf, isa.GROUP_HW_CYCLES)

    s_m, s_f = bench.target_speedup_m, bench.target_speedup_f
    if not bench.w_f:  # M-only / insensitive: x_f = 0, closed form
        if s_m <= 1.0:
            x_m = 0.003 if bench.cls == INSENSITIVE else 0.0
        else:
            x_m = (s_m - 1.0) / ((a_i - 1.0) - s_m * (a_m - 1.0))
        x_f = 0.0
    elif bench.x_m_fixed is not None:
        # pin x_m to the compiled loop's integer-mul rate; solve x_f so the
        # RV32IF speedup hits s_f; the RV32IM speedup then *emerges*
        x_m = bench.x_m_fixed
        x_f = ((s_f - 1.0) * (1.0 + x_m * (a_i - 1.0))
               / ((b_i - 1.0) - s_f * (b_f - 1.0)))
    else:
        # rows: [T_I - s_m T_IM = 0], [T_I - s_f T_IF = 0]
        mat = np.array([
            [(a_i - 1.0) - s_m * (a_m - 1.0), (b_i - 1.0) - s_m * (b_m - 1.0)],
            [(a_i - 1.0) * (1.0 - s_f), (b_i - 1.0) - s_f * (b_f - 1.0)],
        ])
        rhs = np.array([s_m - 1.0, s_f - 1.0])
        x_m, x_f = np.linalg.solve(mat, rhs)
    x_m = float(np.clip(x_m, 0.0, 0.45))
    x_f = float(np.clip(x_f, 0.0, 0.45))

    frac = wm * x_m + wf * x_f
    frac[isa.GROUP_ID["base"]] = 1.0 - x_m - x_f
    return Mix(bench=bench.name, frac=frac)


MIXES: dict[str, Mix] = {}


def mix_of(name: str) -> Mix:
    if name not in MIXES:
        MIXES[name] = solve_mix(BENCHES[name])
    return MIXES[name]


# ---------------------------------------------------------------------------
# Trace synthesis
# ---------------------------------------------------------------------------

# instruction alternatives per group, cycled to create instruction-level
# (scenario-1) tag variety matching shared-logic reality (§V-D)
_GROUP_MEMBERS = {
    "mul": ["mul", "mulhu"],
    "div": ["div", "divu"],
    "rem": ["rem", "remu"],
    "fadd": ["fadd.s", "fsub.s"],
    "fmul": ["fmul.s"],
    "fdiv": ["fdiv.s"],
    "fcmp": ["flt.s", "fle.s"],
    "fsqrt": ["fsqrt.s"],
    "fcvt": ["fcvt.s.w"],
    "fma": ["fmadd.s", "fmsub.s"],
}


def build_trace(name: str, length: int = 200_000, seed: int = 0) -> np.ndarray:
    """Synthesise an instruction-id trace (int32, values in isa alphabet).

    Structure per superblock (~cold_event_period instrs):
      base filler | hot-F runs (f_run_len) | interleaved mul events
      (every mul_period) | one cold-group event.
    Counts are scaled so the stationary mix matches `mix_of(name)`.
    """
    bench = BENCHES[name]
    mix = mix_of(name)
    return paint_trace(
        mix.frac, length=length, seed_key=f"{name}:{seed}",
        hot_f_groups=bench.hot_f_groups,
        cold_event_period=bench.cold_event_period,
        f_run_len=bench.f_run_len, sporadic=bench.sporadic)


def paint_trace(frac: np.ndarray, *, length: int, seed_key: str,
                hot_f_groups: tuple = (), cold_event_period: int = 64,
                f_run_len: int = 4, sporadic: bool = False) -> np.ndarray:
    """Paint a (NUM_GROUPS,) stationary mix onto an instruction-id trace.

    This is the loop-structure painter behind `build_trace`, exposed so
    other mix sources (the model-zoo lowering in `repro.workloads`) share
    the exact same process-deterministic contract: the numpy Generator is
    seeded from ``crc32(seed_key)`` — crc32, not ``hash()``, because str
    hashing is PYTHONHASHSEED-randomised and traces must be identical
    across processes (golden pins, PR-over-PR benchmarks).
    """
    rng = np.random.default_rng(zlib.crc32(seed_key.encode()))

    sb_len = max(int(cold_event_period), 24)
    hot = [g for g in hot_f_groups if frac[isa.GROUP_ID[g]] > 0]
    cold = [g for g in isa.F_GROUPS
            if g not in hot and frac[isa.GROUP_ID[g]] > 0]
    m_present = [g for g in isa.M_GROUPS if frac[isa.GROUP_ID[g]] > 0]

    member_cycler = {g: 0 for g in _GROUP_MEMBERS}

    def run_of(g: str, count: int) -> list[int]:
        # one member per *event* (a compiled loop body reuses the same
        # instruction); the member rotates between events, which is what
        # gives scenario 1 its instruction-level tag variety
        members = _GROUP_MEMBERS[g]
        m = members[member_cycler[g] % len(members)]
        member_cycler[g] += 1
        return [isa.INSTR_ID[m]] * count

    base_id = isa.INSTR_ID["base"]
    # fractional-count accumulators preserve the exact stationary mix even
    # when per-superblock counts round to zero
    acc = {g: 0.0 for g in hot + cold + m_present}

    trace: list[int] = []
    cold_idx = 0
    while len(trace) < length:
        # hot/M groups drain their accumulator every superblock; cold groups
        # accumulate and drain only when they are the rotor (below), which
        # both preserves the exact per-group mix and produces the paper's
        # spaced capacity-miss events
        for g in acc:
            acc[g] += frac[isa.GROUP_ID[g]] * sb_len
        counts = {}
        for g in hot + m_present:
            counts[g] = int(acc[g])
            acc[g] -= counts[g]

        # --- assemble op runs: hot-F bursts, index-mul singles, cold event ---
        items: list[list[int]] = []
        run = max(1, f_run_len)
        hot_runs: list[list[int]] = []
        for g in hot:
            c = counts[g]
            while c > 0:
                take = min(run, c)
                hot_runs.append(run_of(g, take))
                c -= take
        rng.shuffle(hot_runs)
        m_singles = []
        for g in m_present:
            m_singles.extend(run_of(g, 1) for _ in range(counts[g]))
        # interleave: each mul event lands between two F bursts, maximising
        # the M<->F alternation the paper's scenario-3 numbers imply
        hi, mi = 0, 0
        while hi < len(hot_runs) or mi < len(m_singles):
            if hi < len(hot_runs):
                items.append(hot_runs[hi]); hi += 1
            if mi < len(m_singles):
                items.append(m_singles[mi]); mi += 1
        # one rotating cold group per superblock keeps distinct cold tags
        # spaced in time (the paper's capacity misses)
        if cold:
            g = cold[cold_idx % len(cold)]
            cold_idx += 1
            pending = int(acc[g])
            if pending:
                acc[g] -= pending
                items.append(run_of(g, pending))

        # --- paint onto a fixed-length canvas: base filler fills the gaps ---
        n_ops = sum(len(it) for it in items)
        body_len = max(sb_len, n_ops + len(items) + 1)
        n_base = body_len - n_ops
        n_gaps = len(items) + 1
        if sporadic:
            # ops cluster at the head; a long base tail separates clusters
            tail = int(n_base * 0.6)
            inner = n_base - tail
        else:
            tail = 0
            inner = n_base
        gaps = np.full(n_gaps, inner // n_gaps, dtype=np.int64)
        gaps[: inner % n_gaps] += 1
        if n_gaps > 2:  # jitter, keeping the total exact
            j = rng.integers(0, 2, size=n_gaps - 1)
            gaps[:-1] += j - np.roll(j, 1) * 0  # +0/1 then rebalance below
            excess = gaps.sum() - inner
            gaps[-1] -= excess
            if gaps[-1] < 0:
                gaps[0] += gaps[-1]
                gaps[-1] = 0
        body: list[int] = []
        for i, it in enumerate(items):
            body.extend([base_id] * int(gaps[i]))
            body.extend(it)
        body.extend([base_id] * int(gaps[-1]))
        body.extend([base_id] * tail)
        trace.extend(body)

    return np.asarray(trace[:length], dtype=np.int32)


def trace_mix(trace: np.ndarray) -> np.ndarray:
    """Empirical per-group fraction of a trace (for validation)."""
    groups = isa.INSTR_GROUP[trace]
    return np.bincount(groups, minlength=isa.NUM_GROUPS) / len(trace)


def rescale_bench(name: str, **overrides) -> BenchSpec:
    """Utility for calibration sweeps."""
    return replace(BENCHES[name], **overrides)
