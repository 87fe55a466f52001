"""Cycle-approximate simulator of the FPGA-extended reconfigurable core.

PyTorch port of `repro.core.simulator`.  It mirrors the paper's
methodology (§V): the disambiguator acts as an L0 cache over reconfigurable
slots and adds a configurable miss latency; fixed-ISA machines are
analytic; the reconfigurable core steps a synthesised instruction trace
through exact-LRU disambiguator + bitstream-cache state, and a round-robin
scheduler with per-program quanta and priority weights multiplexes fleets
of P programs on it.

Four execution paths serve the sweep entry points (`sweep_fleet`,
`simulate_many`, `simulate_single`, `simulate_single_batch`), picked by the
same dispatcher and the same eligibility rules as the reference:

  * **stack-distance path** (`repro_torch.core.stackdist`): unpreempted
    runs with a warm bitstream cache collapse the {slot count x latency}
    grid into one Mattson pass per trace;
  * **interleaved path** (`repro_torch.core.stackdist_interleaved`):
    preempted runs with a fleet-warm bitstream cache replay each cell's
    interleaving at scheduler-window granularity through the window pass
    — the hand-written CUDA kernel on the card — one-shot or resumed from
    a `FleetState`;
  * **stacked cold-bitstream path** (`repro_torch.core.stackdist_cold`):
    unpreempted runs with an undersized bitstream cache;
  * **scan path**: the reference machine, one access per step.  torch has
    no `lax.scan`, so this is a Python step loop vectorised over every
    lane of the grid: the semantics, not the speed (on the card the loop
    replays CUDA graphs of `SCAN_GRAPH_STEPS` steps).

Every public entry point takes `device=` (default "cuda") and returns
torch tensors on that device; nothing falls back to the CPU on its own.
Results are int32 like the reference with x64 off, and `FleetResult.cpi`
is float32, so every anchor derived from the port prints the reference's
digits.  `scan_unroll` stays in the signatures for parity with the
reference and is inert (there is no compiled scan to unroll).

The reference's mesh code (`_fleet_mesh`, `_mesh_sweep_preempted`) shards
the interleaved sweep's fleet axis across devices; it has no meaning on
one card, so `fleet_mesh_size()` is 1 and the sweep never shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import (isa, slots, stackdist, stackdist_cold,
                              stackdist_interleaved)
from repro_torch.core.traces import Mix, analytic_cpi  # re-export
from repro_torch.device import resolve_device as _device

__all__ = [
    "ReconfigConfig", "SchedulerConfig", "SimResult", "PairResult",
    "FleetResult", "FleetState", "init_fleet_state",
    "fleet_state_from_numpy", "fleet_state_to_numpy",
    "fleet_tag_table", "stackdist_eligible", "stackdist_cold_eligible",
    "interleaved_eligible",
    "quanta_vector", "priority_schedule",
    "simulate_single", "simulate_single_batch",
    "simulate_many", "sweep_fleet", "sweep_bitstream",
    "simulate_pair", "simulate_pair_batch",
    "analytic_cpi", "fixed_pair_cpi", "fixed_fleet_cpi", "fleet_mesh_size",
    "seu_fleet_state", "flush_bitstream", "degrade_fleet_state",
]

# inert: kept so call sites written against the reference still work
SCAN_UNROLL = 1

# default scheduler-window size of the interleaved path, keyed by device
# type — a pure performance knob (results are identical for any window).
# The CPU keeps the reference's CPU value; CUDA takes the reference's
# accelerator value.
INTERLEAVE_WINDOW = {"cpu": 256, "cuda": 512}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


@dataclass(frozen=True)
class ReconfigConfig:
    """Reconfigurable-core parameters (paper §V-A, §V-D)."""

    num_slots: int
    miss_latency: int          # disambiguator-miss cycles (reconfig incl.)
    bs_cache_entries: int = 64  # bitstream-cache entries (>= tags: warm mode)
    bs_miss_extra: int = 100    # added cycles when the bitstream cache misses


# quantum no run can reach (see the reference)
NO_PREEMPT_QUANTUM = 1 << 30


@dataclass(frozen=True)
class SchedulerConfig:
    """Round-robin OS scheduler model (paper §V-B, §VI-C), with optional
    per-program quanta and integer priority weights (weighted round-robin:
    program p takes `priorities[p]` consecutive quanta per rotation).  A
    scalar `quantum_cycles` with `priorities=None` is the paper's uniform
    round-robin."""

    quantum_cycles: int | tuple[int, ...] = 20_000
    handler_cycles: int = 150
    priorities: tuple[int, ...] | None = None

    @classmethod
    def no_preempt(cls, handler_cycles: int = 150) -> "SchedulerConfig":
        """A scheduler that never fires — for solo-program references."""
        return cls(quantum_cycles=NO_PREEMPT_QUANTUM,
                   handler_cycles=handler_cycles)

    def quanta(self, num_programs: int) -> np.ndarray:
        """(P,) int32 per-program quantum vector (scalars broadcast)."""
        return quanta_vector(self.quantum_cycles, num_programs)

    def schedule(self, num_programs: int) -> np.ndarray:
        """The weighted round-robin turn order (see `priority_schedule`)."""
        return priority_schedule(self.priorities, num_programs)


def quanta_vector(quantum_cycles, num_programs: int) -> np.ndarray:
    """Normalise a scalar-or-vector quantum spec to a (P,) int32 vector."""
    q = np.asarray(quantum_cycles, dtype=np.int64)
    if q.ndim == 0:
        q = np.full((num_programs,), int(q), np.int64)
    if q.shape != (num_programs,):
        raise ValueError(
            f"quantum_cycles vector has shape {q.shape}, expected "
            f"({num_programs},) for a fleet of P={num_programs} programs")
    if np.any(q <= 0):
        raise ValueError(f"quantum_cycles must be positive, got {q.tolist()}")
    return q.astype(np.int32)


def priority_schedule(priorities, num_programs: int) -> np.ndarray:
    """Weighted round-robin turn order as a flat program-index sequence:
    None -> [0, 1, .., P-1]; weights (2, 1) -> [0, 0, 1]."""
    if priorities is None:
        return np.arange(num_programs, dtype=np.int32)
    pr = np.asarray(priorities, dtype=np.int64)
    if pr.shape != (num_programs,):
        raise ValueError(
            f"priorities vector has shape {pr.shape}, expected "
            f"({num_programs},) for a fleet of P={num_programs} programs")
    if np.any(pr <= 0):
        raise ValueError(f"priorities must be positive ints, got "
                         f"{pr.tolist()}")
    return np.repeat(np.arange(num_programs, dtype=np.int32),
                     pr).astype(np.int32)


def _cpi(cycles: torch.Tensor, instructions: torch.Tensor) -> torch.Tensor:
    # int32 / int32 true division is float32, like jnp with x64 off
    return cycles / torch.clamp(instructions, min=1)


class SimResult(NamedTuple):
    cycles: torch.Tensor
    instructions: torch.Tensor
    slot_misses: torch.Tensor
    bs_misses: torch.Tensor

    @property
    def cpi(self):
        return _cpi(self.cycles, self.instructions)


class PairResult(NamedTuple):
    cycles: torch.Tensor        # (P,) attributed cycles (incl. handler)
    instructions: torch.Tensor  # (P,)
    slot_misses: torch.Tensor   # (P,)
    switches: torch.Tensor      # () context switches

    @property
    def cpi(self):
        return _cpi(self.cycles, self.instructions)


# ---------------------------------------------------------------------------
# eligibility predicates and the dispatcher's heuristics
# ---------------------------------------------------------------------------


def stackdist_eligible(tag_row, *, quantum_cycles, bs_entries: int,
                       max_miss_latency: int, bs_miss_extra: int,
                       total_steps: int) -> bool:
    """True iff the *unpreempted* stack-distance path is exact: warm
    bitstream cache over program 0's tags, every quantum unreachable, and
    the worst-case cycle sum below the minimum quantum."""
    num_tags = int(np.max(_np(tag_row))) + 1
    warm = bs_entries >= num_tags
    worst_step = (int(np.max(isa.INSTR_HW_CYCLES)) + int(max_miss_latency)
                  + int(bs_miss_extra))
    min_quantum = int(np.min(_np(quantum_cycles)))
    unpreempted = (min_quantum >= NO_PREEMPT_QUANTUM
                   and total_steps * worst_step < min_quantum)
    return warm and unpreempted


def stackdist_cold_eligible(*, quantum_cycles, max_miss_latency: int,
                            bs_miss_extra: int, total_steps: int) -> bool:
    """True iff the stacked cold-bitstream pass is exact: the unpreempted
    and no-overflow conditions of `stackdist_eligible`, any bitstream
    capacity."""
    worst_step = (int(np.max(isa.INSTR_HW_CYCLES)) + int(max_miss_latency)
                  + int(bs_miss_extra))
    min_quantum = int(np.min(_np(quantum_cycles)))
    return (min_quantum >= NO_PREEMPT_QUANTUM
            and total_steps * worst_step < min_quantum)


def interleaved_eligible(tag_table, *, bs_entries: int, miss_latencies,
                         bs_miss_extra: int, handler_cycles: int,
                         total_steps: int) -> bool:
    """True iff the interleave-aware path is exact: warm bitstream cache
    over the fleet's merged tag alphabet, non-negative costs, and no int32
    accumulator able to overflow (worst-case access plus a handler every
    access, summed over `total_steps`)."""
    num_tags = int(np.max(_np(tag_table))) + 1
    warm = bs_entries >= num_tags
    lats = _np(miss_latencies)
    nonneg = (int(np.min(lats)) >= 0 and int(bs_miss_extra) >= 0
              and int(handler_cycles) >= 0)
    worst_step = (int(np.max(isa.INSTR_HW_CYCLES)) + int(np.max(lats))
                  + int(bs_miss_extra) + int(handler_cycles))
    no_overflow = total_steps * worst_step < np.iinfo(np.int32).max
    return warm and nonneg and no_overflow


# below this minimum quantum the window engine degenerates toward one trip
# per scheduler run; `auto` leaves such grids on the scan
_INTERLEAVED_AUTO_MIN_QUANTUM = 256
# per-trip transient footprint bound of the plain body: window x num_tags x
# grid cells per fleet (the fleet axis is chunked, see
# _sweep_fleet_interleaved)
_INTERLEAVED_CHUNK_ELEMS = 16_000_000
# fleet batches are padded up to a multiple of this; padded rows replay
# fleet 0 and are sliced off the result
_INTERLEAVED_BATCH_BUCKET = 4


def _interleaved_window(quanta_grid, total_steps: int, window: int | None,
                        device: torch.device) -> int:
    """Window size: the device's default, shrunk to the next power of two
    covering the largest quantum and never beyond the run length."""
    if window is None:
        q = int(np.max(_np(quanta_grid)))
        window = min(INTERLEAVE_WINDOW.get(torch.device(device).type, 512),
                     1 << max(0, (q - 1)).bit_length())
    return max(1, min(int(window), total_steps))


def _interleaved_auto_ok(quanta_grid, grid_cells: int, num_tags: int,
                         total_steps: int, window: int | None,
                         device: torch.device) -> bool:
    w = _interleaved_window(quanta_grid, total_steps, window, device)
    return (int(np.min(_np(quanta_grid))) >= _INTERLEAVED_AUTO_MIN_QUANTUM
            and w * max(num_tags, 1) * grid_cells
            <= _INTERLEAVED_CHUNK_ELEMS)


def _check_single_path(path: str, eligible: bool,
                       cold_ok: bool = False) -> str:
    if path == "interleaved":
        raise ValueError(
            "interleaved path is not served by the single-program entry "
            "points (a solo run is never preempted; the unpreempted "
            "stack-distance engine already collapses its grid) — use "
            "simulate_many or sweep_fleet to force it")
    return _check_path(path, eligible, cold_ok=cold_ok)


def _check_path(path: str, stackdist_ok: bool, interleaved_ok: bool = False,
                interleaved_auto: bool = False,
                cold_ok: bool = False) -> str:
    if path not in ("auto", "stackdist", "stackdist_cold", "interleaved",
                    "scan"):
        raise ValueError(f"unknown path {path!r}")
    if path == "stackdist" and not stackdist_ok:
        raise ValueError(
            "stack-distance path requires an unpreempted run with a warm "
            "bitstream cache (see simulator.stackdist_eligible)")
    if path == "stackdist_cold" and not cold_ok:
        raise ValueError(
            "stacked cold-bitstream path requires an unpreempted run with "
            "int32-safe costs (see simulator.stackdist_cold_eligible)")
    if path == "interleaved" and not interleaved_ok:
        raise ValueError(
            "interleaved path requires a one-shot run with a warm "
            "bitstream cache over the fleet's merged tag set and "
            "non-negative int32-safe costs (see "
            "simulator.interleaved_eligible)")
    if path == "auto":
        path = ("stackdist" if stackdist_ok
                else "stackdist_cold" if cold_ok
                else "interleaved" if interleaved_ok and interleaved_auto
                else "scan")
    return path


# ---------------------------------------------------------------------------
# fleet state
# ---------------------------------------------------------------------------


class FleetResult(NamedTuple):
    """Per-program counters of an N-program fleet run: leading axes are the
    swept grid, the trailing axis the program index."""

    cycles: torch.Tensor        # (..., P) attributed cycles (incl. handler)
    instructions: torch.Tensor  # (..., P)
    slot_misses: torch.Tensor   # (..., P)
    bs_misses: torch.Tensor     # (..., P)
    switches: torch.Tensor      # (...)  context switches

    @property
    def cpi(self):
        return _cpi(self.cycles, self.instructions)


class FleetState(NamedTuple):
    """The fleet machine's carry as an explicit, resumable value:
    `simulate_many(..., state=S, return_state=True)` runs N steps from S
    and returns (results, S'); a run split at any step equals the unsplit
    run bit for bit.  Counters are cumulative since initialisation."""

    slot_st: slots.SlotState   # disambiguator (shared by the fleet)
    bs_st: slots.SlotState     # bitstream cache
    cursors: torch.Tensor      # (P,) per-program trace cursor
    sched_idx: torch.Tensor    # () cursor into the priority schedule
    q_cycles: torch.Tensor     # () cycles burnt in the current quantum
    cycles: torch.Tensor       # (P,) attributed cycles (incl. handler)
    instrs: torch.Tensor       # (P,)
    misses: torch.Tensor       # (P,) disambiguator misses
    bs_misses: torch.Tensor    # (P,) bitstream-cache misses
    switches: torch.Tensor     # () context switches

    @property
    def num_programs(self) -> int:
        return self.cursors.shape[0]

    def result(self) -> "FleetResult":
        """The cumulative counters viewed as a FleetResult."""
        return FleetResult(self.cycles, self.instrs, self.misses,
                           self.bs_misses, self.switches)

    def reset_counters(self) -> "FleetState":
        """Zero the counters, keeping caches/cursors."""
        z = torch.zeros_like
        return self._replace(cycles=z(self.cycles), instrs=z(self.instrs),
                             misses=z(self.misses),
                             bs_misses=z(self.bs_misses),
                             switches=z(self.switches))


def init_fleet_state(num_programs: int, num_slots: int,
                     bs_entries: int = 64, device="cuda") -> FleetState:
    """Cold-start state for a fleet of P programs (empty caches, step 0)."""
    if num_programs < 1:
        raise ValueError(f"num_programs must be >= 1, got {num_programs}")
    dev = _device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    return FleetState(
        slot_st=slots.init(num_slots, dev),
        bs_st=slots.init(bs_entries, dev),
        cursors=z(num_programs), sched_idx=z(), q_cycles=z(),
        cycles=z(num_programs), instrs=z(num_programs),
        misses=z(num_programs), bs_misses=z(num_programs), switches=z(),
    )


def fleet_state_from_numpy(obj, device="cuda") -> FleetState:
    """Build a `FleetState` on `device` from any object with its fields
    (nested `slot_st`/`bs_st` with `tags`, `last_use`, `clock`) holding
    numpy arrays or scalars — e.g. the JAX package's state passed through
    `jax.tree_util.tree_map(np.asarray, state)` — so both packages can be
    seeded from one state."""
    dev = _device(device)
    t = lambda x: torch.as_tensor(np.array(x, dtype=np.int32), device=dev)
    cache = lambda st: slots.SlotState(tags=t(st.tags),
                                       last_use=t(st.last_use),
                                       clock=t(st.clock))
    return FleetState(
        slot_st=cache(obj.slot_st), bs_st=cache(obj.bs_st),
        cursors=t(obj.cursors), sched_idx=t(obj.sched_idx),
        q_cycles=t(obj.q_cycles), cycles=t(obj.cycles),
        instrs=t(obj.instrs), misses=t(obj.misses),
        bs_misses=t(obj.bs_misses), switches=t(obj.switches))


def fleet_state_to_numpy(state: FleetState) -> FleetState:
    """The same `FleetState` with every leaf as an int32 numpy array."""
    cache = lambda st: slots.SlotState(*(_np(x) for x in st))
    return FleetState(cache(state.slot_st), cache(state.bs_st),
                      *(_np(x) for x in state[2:]))


def _check_fleet_state(state: FleetState, num_programs: int,
                       num_slots: int, bs_entries: int) -> None:
    if tuple(state.cursors.shape) != (num_programs,):
        raise ValueError(
            f"FleetState carries {state.cursors.shape[0]} program cursors, "
            f"but the traces describe a fleet of P={num_programs} programs")
    if state.slot_st.tags.shape[0] != num_slots:
        raise ValueError(
            f"FleetState disambiguator has {state.slot_st.tags.shape[0]} "
            f"slots, but the config allocates num_slots={num_slots} — "
            f"resume must use the same slot geometry it was initialised "
            f"with")
    if state.bs_st.tags.shape[0] != bs_entries:
        raise ValueError(
            f"FleetState bitstream cache has {state.bs_st.tags.shape[0]} "
            f"entries, but the config allocates "
            f"bs_cache_entries={bs_entries}")


def fleet_tag_table(scenarios, num_programs: int) -> np.ndarray:
    """(P, NUM_INSTRUCTIONS) per-program disambiguator-tag table from one
    shared `SlotScenario` or one per program."""
    if isinstance(scenarios, isa.SlotScenario):
        scenarios = [scenarios] * num_programs
    else:
        scenarios = list(scenarios)
    if len(scenarios) != num_programs:
        raise ValueError(
            f"got {len(scenarios)} slot scenarios for a fleet of "
            f"P={num_programs} programs — pass one SlotScenario to share, "
            f"or exactly one per program")
    for i, s in enumerate(scenarios):
        tag = np.asarray(s.instr_tag)
        if tag.shape != (isa.NUM_INSTRUCTIONS,):
            raise ValueError(
                f"scenario {i} ({getattr(s, 'name', s)!r}) has instr_tag "
                f"shape {tag.shape}, expected ({isa.NUM_INSTRUCTIONS},)")
    return np.stack([s.instr_tag for s in scenarios])


def fleet_mesh_size() -> int:
    """Devices the interleaved sweep shards its fleet axis over: always 1
    (the reference's device mesh has no counterpart on one card)."""
    return 1


# ---------------------------------------------------------------------------
# FleetState <-> interleaved-engine translation (numpy, as the reference)
# ---------------------------------------------------------------------------


def canonical_slot_state(st: slots.SlotState) -> slots.SlotState:
    """Behaviour-preserving canonical arrangement of one cache: residents
    sorted by LRU clock ascending into a prefix (stable), empties as the
    suffix, clock untouched."""
    dev = st.tags.device
    tags = _np(st.tags)
    lu = _np(st.last_use)
    filled = tags >= 0
    k = int(filled.sum())
    order = np.argsort(lu[filled], kind="stable")
    t = np.full(tags.shape, -1, np.int32)
    u = np.zeros(lu.shape, np.int32)
    t[:k] = tags[filled][order]
    u[:k] = lu[filled][order]
    return slots.SlotState(tags=_i32(t, dev), last_use=_i32(u, dev),
                           clock=st.clock)


def _canonical_state(state: FleetState) -> FleetState:
    """Canonical cache arrangement of a whole `FleetState`, which makes
    states comparable across engines."""
    return state._replace(slot_st=canonical_slot_state(state.slot_st),
                          bs_st=canonical_slot_state(state.bs_st))


# ---------------------------------------------------------------------------
# fault surgery: the state mutations a fleet's fault events inflict
# ---------------------------------------------------------------------------


def seu_fleet_state(state: FleetState, slot_indices) -> FleetState:
    """A single-event upset invalidates the disambiguator entries at
    `slot_indices` and re-canonicalises the cache so survivors pack a
    prefix.  The result is usually not seedable by the interleaved resume
    (`_seedable_fleet_state`), so the next resumed segment takes the
    reference machine until the disambiguator refills."""
    idx = np.asarray(slot_indices, np.int64).reshape(-1)
    n = state.slot_st.tags.shape[0]
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(
            f"SEU slot indices {idx.tolist()} out of range for a "
            f"{n}-slot disambiguator")
    return state._replace(slot_st=canonical_slot_state(
        slots.invalidate(state.slot_st, idx)))


def flush_bitstream(state: FleetState) -> FleetState:
    """A failed partial reconfiguration colds the bitstream cache: every
    later disambiguator miss re-pays `bs_miss_extra`.  Slot residents no
    longer covered by the bitstream cache make the state unseedable, so
    the next resumed segment takes the reference machine."""
    return state._replace(bs_st=slots.init(state.bs_st.tags.shape[0],
                                           state.bs_st.tags.device))


def degrade_fleet_state(state: FleetState, num_active: int) -> FleetState:
    """Shrink a state to a core that came back with `num_active` usable
    disambiguator slots: the `num_active` most recently used residents
    survive, packed canonically into the active prefix.  A masked run
    (`simulate_many(..., num_active=k)`) over such a state is bit for bit
    an LRU cache of k slots."""
    n = state.slot_st.tags.shape[0]
    if not 1 <= num_active <= n:
        raise ValueError(
            f"num_active must be in [1, {n}], got {num_active}")
    st = canonical_slot_state(state.slot_st)
    filled = int((_np(st.tags) >= 0).sum())
    if filled > num_active:
        # canonical order is LRU-ascending: the dead slots take the
        # least-recently-used residents (prefix entries)
        st = canonical_slot_state(
            slots.invalidate(st, np.arange(filled - num_active)))
    return state._replace(slot_st=st)


def _seedable_fleet_state(state: FleetState, num_tags: int,
                          worst_step: int, total_steps: int) -> bool:
    """True iff the interleaved engine can seed from this `FleetState`:
    prefix-packed caches with distinct residents and clocks, slot
    residents bitstream-resident (a non-full disambiguator with identical
    resident sets), and int32 headroom for the segment."""
    def cache(st: slots.SlotState):
        tags = _np(st.tags)
        lu = _np(st.last_use).astype(np.int64)
        filled = tags >= 0
        k = int(filled.sum())
        if not (np.all(tags[:k] >= 0) and np.all(tags[k:] < 0)):
            return None
        res = tags[:k]
        if k and (int(res.max()) >= num_tags
                  or len(np.unique(res)) != k
                  or len(np.unique(lu[:k])) != k
                  or int(lu[:k].max()) > int(st.clock)
                  or int(lu[:k].min()) < 0):
            return None
        return res

    slot_res = cache(state.slot_st)
    bs_res = cache(state.bs_st)
    if slot_res is None or bs_res is None:
        return False
    if not np.isin(slot_res, bs_res).all():
        return False
    full = slot_res.size == _np(state.slot_st.tags).size
    if not full and slot_res.size != bs_res.size:
        return False
    lim = np.iinfo(np.int32).max
    top = max(int(state.q_cycles), int(state.switches),
              *(int(np.max(_np(x))) for x in
                (state.cycles, state.instrs, state.misses, state.bs_misses)))
    return (top + total_steps * worst_step < lim
            and int(np.max(_np(state.cursors))) + total_steps < lim
            and int(state.slot_st.clock) + total_steps < lim
            and int(state.bs_st.clock) + total_steps < lim)


def _seed_carry(state: FleetState,
                num_tags: int) -> stackdist_interleaved.CellCarry:
    """Translate a (seedable) `FleetState` into engine coordinates:
    evicted-but-bitstream-resident tags at the bottom of the virtual block
    `[0, num_tags)`, disambiguator residents above them by LRU clock,
    untouched tags -1; scheduler state and counters verbatim."""
    dev = state.cursors.device
    slot_tags = _np(state.slot_st.tags)
    slot_lu = _np(state.slot_st.last_use).astype(np.int64)
    bs_tags = _np(state.bs_st.tags)
    filled = slot_tags >= 0
    residents = slot_tags[filled][np.argsort(slot_lu[filled])]
    evicted = np.setdiff1d(bs_tags[bs_tags >= 0], residents)
    last_pos = np.full((num_tags,), -1, np.int32)
    last_pos[evicted] = np.arange(evicted.size, dtype=np.int32)
    last_pos[residents] = evicted.size + np.arange(residents.size,
                                                   dtype=np.int32)
    return stackdist_interleaved.CellCarry(
        last_pos=_i32(last_pos, dev),
        last_miss_pos=torch.full((num_tags,), -1, dtype=torch.int32,
                                 device=dev),
        cursors=state.cursors, sched_idx=state.sched_idx,
        steps_done=torch.zeros((), dtype=torch.int32, device=dev),
        q_cycles=state.q_cycles, cycles=state.cycles, instrs=state.instrs,
        misses=state.misses, bs_misses=state.bs_misses,
        switches=state.switches)


def _state_from_final(final: stackdist_interleaved.CellCarry,
                      seed_state: FleetState, num_slots: int,
                      bs_entries: int, num_tags: int,
                      total_steps: int) -> FleetState:
    """Rebuild the canonical `FleetState` from the engine's final carry:
    both cache clocks advance one per access, a touched tag's LRU clock is
    the scan clock of its last access (`last_pos - num_tags + 1` past the
    seed clock), the bitstream cache's from `last_miss_pos`; the
    disambiguator holds the `num_slots` most recent distinct tags, the
    warm bitstream cache every tag ever present."""
    dev = seed_state.cursors.device
    offset = num_tags
    last_pos = _np(final.last_pos).astype(np.int64)
    last_miss = _np(final.last_miss_pos).astype(np.int64)
    seed_slot_clock = int(seed_state.slot_st.clock)
    seed_bs_clock = int(seed_state.bs_st.clock)

    def lu_map(st: slots.SlotState) -> np.ndarray:
        m = np.zeros((num_tags,), np.int64)
        tags = _np(st.tags)
        f = tags >= 0
        m[tags[f]] = _np(st.last_use).astype(np.int64)[f]
        return m

    slot_lu = np.where(last_pos >= offset,
                       seed_slot_clock + (last_pos - offset) + 1,
                       lu_map(seed_state.slot_st))
    bs_lu = np.where(last_miss >= 0,
                     seed_bs_clock + (last_miss - offset) + 1,
                     lu_map(seed_state.bs_st))
    present = np.nonzero(last_pos >= 0)[0]
    by_recency = present[np.argsort(last_pos[present])]
    slot_res = by_recency[-num_slots:]   # ascending position = ascending lu
    bs_res = present[np.argsort(bs_lu[present])]

    def pack(res: np.ndarray, lu: np.ndarray, size: int,
             clock: int) -> slots.SlotState:
        t = np.full((size,), -1, np.int32)
        u = np.zeros((size,), np.int32)
        t[:res.size] = res
        u[:res.size] = lu[res].astype(np.int32)
        return slots.SlotState(tags=_i32(t, dev), last_use=_i32(u, dev),
                               clock=_i32(clock, dev))

    return FleetState(
        slot_st=pack(slot_res, slot_lu, num_slots,
                     seed_slot_clock + total_steps),
        bs_st=pack(bs_res, bs_lu, bs_entries, seed_bs_clock + total_steps),
        cursors=final.cursors, sched_idx=final.sched_idx,
        q_cycles=final.q_cycles, cycles=final.cycles, instrs=final.instrs,
        misses=final.misses, bs_misses=final.bs_misses,
        switches=final.switches)


def _engine_num_tags(table: np.ndarray, state: FleetState | None) -> int:
    """Tag-alphabet size for the interleaved engine: the fleet's table plus
    any stale resident tags a carried state may hold."""
    nt = int(np.max(table)) + 1
    if state is not None:
        for st in (state.slot_st, state.bs_st):
            t = _np(st.tags)
            if t.size and int(t.max()) >= 0:
                nt = max(nt, int(t.max()) + 1)
    return max(nt, 1)


def _resume_fleet_interleaved(traces, table, cfg: ReconfigConfig, quanta,
                              schedule, handler, seed_state: FleetState,
                              total_steps: int, num_tags: int,
                              use_kernel=None):
    """Run one resumable interleaved cell from a `FleetState` seed ->
    (FleetResult, final CellCarry)."""
    dev = traces.device
    w = _interleaved_window(quanta, total_steps, None, dev)
    final = stackdist_interleaved.resume_preempted(
        traces, table, isa.INSTR_HW_CYCLES, cfg.num_slots, cfg.miss_latency,
        _i32(quanta, dev), _i32(schedule, dev), int(handler),
        cfg.bs_miss_extra, _seed_carry(seed_state, num_tags),
        num_tags=num_tags, total_steps=total_steps, window=w,
        use_kernel=use_kernel)
    res = FleetResult(final.cycles, final.instrs, final.misses,
                      final.bs_misses, final.switches)
    return res, final


# ---------------------------------------------------------------------------
# the reference machine: one access per step, every grid lane at once
# ---------------------------------------------------------------------------


def _batch_state(state: FleetState) -> FleetState:
    """Add a leading lane axis of size 1 to every leaf."""
    cache = lambda st: slots.SlotState(*(x.unsqueeze(0) for x in st))
    return FleetState(cache(state.slot_st), cache(state.bs_st),
                      *(x.unsqueeze(0) for x in state[2:]))


def _lane_state(state: FleetState, lane: int) -> FleetState:
    cache = lambda st: slots.SlotState(*(x[lane] for x in st))
    return FleetState(cache(state.slot_st), cache(state.bs_st),
                      *(x[lane] for x in state[2:]))


def _scan_lanes(ptags: torch.Tensor, pcosts: torch.Tensor,
                lane_fleet: torch.Tensor, miss_latency: torch.Tensor,
                active_slots: torch.Tensor, quanta: torch.Tensor,
                schedule: torch.Tensor, handler: int, bs_miss_extra: int,
                state: FleetState, total_steps: int) -> FleetState:
    """Step every lane's round-robin machine `total_steps` accesses.

    `ptags`/`pcosts` are the (B, P, N) pre-gathered streams, `lane_fleet`
    (lanes,) picks each lane's fleet, `miss_latency`/`active_slots`
    (lanes,) and `quanta` (lanes, P) are the lanes' coordinates, `state` a
    FleetState with a leading lane axis.  Mirrors the reference's
    `_fleet_step_fn` (the access pays its hw cost, a slot miss its latency,
    a bitstream miss its penalty; the expiring access's program pays the
    handler; caches persist across switches).  On the card the steps run
    as CUDA graphs (`_replay_steps`)."""
    dev = ptags.device
    _, num_progs, trace_len = ptags.shape
    sched_len = schedule.shape[0]
    flat_tags = ptags.reshape(-1)
    flat_costs = pcosts.reshape(-1)
    row_base = lane_fleet.long() * num_progs
    parange = torch.arange(num_progs, device=dev)

    def step(c: FleetState) -> FleetState:
        p = schedule[c.sched_idx.long()].long()
        i = torch.remainder(c.cursors.gather(1, p[:, None])[:, 0], trace_len)
        flat = (row_base + p) * trace_len + i.long()
        tag = flat_tags[flat]
        slot_st, bs_st, hit, bs_hit = slots.lookup_fused(
            c.slot_st, c.bs_st, tag, active_slots)
        miss = ~hit
        bs_miss = ~(hit | bs_hit)
        cost = (flat_costs[flat] + miss.to(torch.int32) * miss_latency
                + bs_miss.to(torch.int32) * bs_miss_extra)
        q = c.q_cycles + cost
        do_switch = q >= quanta.gather(1, p[:, None])[:, 0]
        cost_p = cost + do_switch.to(torch.int32) * handler
        onehot = (parange == p[:, None]).to(torch.int32)
        return FleetState(
            slot_st=slot_st, bs_st=bs_st,
            cursors=c.cursors + onehot,
            sched_idx=torch.where(do_switch, (c.sched_idx + 1) % sched_len,
                                  c.sched_idx),
            q_cycles=torch.where(do_switch, 0, q),
            cycles=c.cycles + onehot * cost_p[:, None],
            instrs=c.instrs + onehot,
            misses=c.misses + onehot * miss.to(torch.int32)[:, None],
            bs_misses=c.bs_misses + onehot * bs_miss.to(torch.int32)[:, None],
            switches=c.switches + do_switch.to(torch.int32),
        )

    if dev.type == "cuda" and total_steps >= SCAN_GRAPH_STEPS:
        return _replay_steps(step, state, total_steps)
    c = state
    for _ in range(total_steps):
        c = step(c)
    return c


# A step of the reference machine is ~85 tiny ops.  Eagerly on the card
# each is a kernel launch and the loop is bound by the host's dispatch
# (1.1-1.6 ms a step on an H100, PERF.md), so there it runs as a
# CUDA graph of this many steps, captured once a call and replayed: the
# same ops on the same tensors, so the same results.
SCAN_GRAPH_STEPS = 32


def _state_leaves(state: FleetState) -> list:
    return list(state.slot_st) + list(state.bs_st) + list(state[2:])


def _state_of(leaves: list) -> FleetState:
    return FleetState(slots.SlotState(*leaves[:3]),
                      slots.SlotState(*leaves[3:6]), *leaves[6:])


def _replay_steps(step, state: FleetState, total_steps: int) -> FleetState:
    """`total_steps` applications of `step` to `state` on the card: one
    eager step first (it loads every kernel the capture records), then a
    graph of `SCAN_GRAPH_STEPS` steps that writes its result back into
    its own input, replayed, and the remainder eagerly."""
    static = _state_of([x.clone() for x in _state_leaves(state)])
    step(static)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = static
        for _ in range(SCAN_GRAPH_STEPS):
            c = step(c)
        for dst, src in zip(_state_leaves(static), _state_leaves(c)):
            dst.copy_(src)
    for _ in range(total_steps // SCAN_GRAPH_STEPS):
        graph.replay()
    c = _state_of([x.clone() for x in _state_leaves(static)])
    for _ in range(total_steps % SCAN_GRAPH_STEPS):
        c = step(c)
    return c


def _gather(traces: torch.Tensor, tag_table):
    """(..., P, N) instruction ids -> (..., P, N) tag and hw-cost streams."""
    return stackdist_interleaved._gather_streams(
        traces, tag_table, isa.INSTR_HW_CYCLES)


def _init_lanes(lanes: int, num_progs: int, num_slots: int,
                bs_entries: int, device) -> FleetState:
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return FleetState(
        slot_st=slots.init(num_slots, device, (lanes,)),
        bs_st=slots.init(bs_entries, device, (lanes,)),
        cursors=z(lanes, num_progs), sched_idx=z(lanes), q_cycles=z(lanes),
        cycles=z(lanes, num_progs), instrs=z(lanes, num_progs),
        misses=z(lanes, num_progs), bs_misses=z(lanes, num_progs),
        switches=z(lanes))


def _simulate_fleet_impl(traces, tag_table, miss_latency, active_slots,
                         quanta, schedule, handler, num_slots: int,
                         bs_entries: int, bs_miss_extra, total_steps: int,
                         scan_unroll: int = SCAN_UNROLL,
                         state: FleetState | None = None
                         ) -> tuple[FleetResult, FleetState]:
    """(P, N) traces + (P, num_opcodes) tags -> (FleetResult, FleetState)
    through the reference machine.  `num_slots` is the allocated
    disambiguator size and `active_slots` masks it down; `state` resumes a
    prior carry (None = cold init).  `scan_unroll` is inert."""
    dev = traces.device
    ptags, pcosts = _gather(traces, tag_table)
    init = (_init_lanes(1, traces.shape[0], num_slots, bs_entries, dev)
            if state is None else _batch_state(state))
    final = _scan_lanes(
        ptags[None], pcosts[None], torch.zeros(1, dtype=torch.long,
                                               device=dev),
        _i32(miss_latency, dev).reshape(1), _i32(active_slots, dev).reshape(1),
        _i32(quanta, dev).reshape(1, -1), _i32(schedule, dev).reshape(-1),
        int(handler), int(bs_miss_extra), init, int(total_steps))
    final = _lane_state(final, 0)
    return final.result(), final


# ---------------------------------------------------------------------------
# single-program entry points
# ---------------------------------------------------------------------------


def _single_eligible(cfg: ReconfigConfig, scenario: isa.SlotScenario,
                     max_miss_latency: int, total_steps: int) -> bool:
    return stackdist_eligible(
        scenario.instr_tag, quantum_cycles=NO_PREEMPT_QUANTUM,
        bs_entries=cfg.bs_cache_entries, max_miss_latency=max_miss_latency,
        bs_miss_extra=cfg.bs_miss_extra, total_steps=total_steps)


def _single_cold_eligible(cfg: ReconfigConfig, max_miss_latency: int,
                          total_steps: int) -> bool:
    return stackdist_cold_eligible(
        quantum_cycles=NO_PREEMPT_QUANTUM, max_miss_latency=max_miss_latency,
        bs_miss_extra=cfg.bs_miss_extra, total_steps=total_steps)


def simulate_single(trace, cfg: ReconfigConfig, scenario: isa.SlotScenario,
                    path: str = "auto", device="cuda") -> SimResult:
    """One program alone on the core (never preempted): (N,) trace ->
    SimResult of () int32 counters."""
    dev = _device(device)
    trace = _i32(trace, dev)
    n = trace.shape[0]
    eligible = _single_eligible(cfg, scenario, cfg.miss_latency, n)
    cold_ok = _single_cold_eligible(cfg, cfg.miss_latency, n)
    chosen = _check_single_path(path, eligible, cold_ok)
    steps = torch.tensor(n, dtype=torch.int32, device=dev)
    if chosen == "stackdist":
        cycles, misses, bs = stackdist.lanes_unpreempted(
            trace[None, :], scenario.instr_tag, isa.INSTR_HW_CYCLES,
            cfg.num_slots, [cfg.miss_latency], cfg.bs_miss_extra,
            num_tags=max(scenario.num_tags, 1), total_steps=n)
        return SimResult(cycles[0], steps, misses[0], bs[0])
    if chosen == "stackdist_cold":
        cycles, misses, bs = stackdist_cold.lanes_cold(
            trace[None, :], scenario.instr_tag, isa.INSTR_HW_CYCLES,
            cfg.num_slots, [cfg.miss_latency], cfg.bs_cache_entries,
            cfg.bs_miss_extra, num_tags=max(scenario.num_tags, 1),
            total_steps=n)
        return SimResult(cycles[0], steps, misses[0], bs[0])
    r, _ = _simulate_fleet_impl(
        trace[None, :], scenario.instr_tag[None, :], cfg.miss_latency,
        cfg.num_slots, [NO_PREEMPT_QUANTUM], [0], 0, cfg.num_slots,
        cfg.bs_cache_entries, cfg.bs_miss_extra, n)
    return SimResult(r.cycles[0], r.instructions[0], r.slot_misses[0],
                     r.bs_misses[0])


def simulate_single_batch(traces, miss_latencies, cfg: ReconfigConfig,
                          scenario: isa.SlotScenario, path: str = "auto",
                          device="cuda") -> SimResult:
    """Paired (trace, miss latency) lanes with a shared scenario: (B, N)
    traces + (B,) latencies -> SimResult of (B,) counters."""
    dev = _device(device)
    traces = _i32(traces, dev)
    lats = _i32(miss_latencies, dev).reshape(-1)
    n = traces.shape[-1]
    max_lat = int(np.max(_np(miss_latencies)))
    eligible = _single_eligible(cfg, scenario, max_lat, n)
    cold_ok = _single_cold_eligible(cfg, max_lat, n)
    chosen = _check_single_path(path, eligible, cold_ok)
    if chosen in ("stackdist", "stackdist_cold"):
        chunk = _stackdist_chunk(n, max(scenario.num_tags, 1))
        if chosen == "stackdist":
            def lanes(tr, la):
                return stackdist.lanes_unpreempted(
                    tr, scenario.instr_tag, isa.INSTR_HW_CYCLES,
                    cfg.num_slots, la, cfg.bs_miss_extra,
                    num_tags=max(scenario.num_tags, 1), total_steps=n)
        else:
            def lanes(tr, la):
                return stackdist_cold.lanes_cold(
                    tr, scenario.instr_tag, isa.INSTR_HW_CYCLES,
                    cfg.num_slots, la, cfg.bs_cache_entries,
                    cfg.bs_miss_extra, num_tags=max(scenario.num_tags, 1),
                    total_steps=n)
        outs = [lanes(traces[i:i + chunk], lats[i:i + chunk])
                for i in range(0, traces.shape[0], chunk)]
        cycles, misses, bs = (torch.cat(x) for x in zip(*outs))
        instrs = torch.full(cycles.shape, n, dtype=torch.int32, device=dev)
        return SimResult(cycles, instrs, misses, bs)
    b = traces.shape[0]
    ptags, pcosts = _gather(traces[:, None, :], scenario.instr_tag[None, :])
    final = _scan_lanes(
        ptags, pcosts, torch.arange(b, device=dev), lats,
        torch.full((b,), cfg.num_slots, dtype=torch.int32, device=dev),
        torch.full((b, 1), NO_PREEMPT_QUANTUM, dtype=torch.int32,
                   device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev), 0, cfg.bs_miss_extra,
        _init_lanes(b, 1, cfg.num_slots, cfg.bs_cache_entries, dev), n)
    return SimResult(final.cycles[:, 0], final.instrs[:, 0],
                     final.misses[:, 0], final.bs_misses[:, 0])


# ---------------------------------------------------------------------------
# multi-program entry points
# ---------------------------------------------------------------------------


def simulate_many(traces, cfg: ReconfigConfig, scenarios,
                  sched: SchedulerConfig, total_steps: int = 400_000,
                  scan_unroll: int = SCAN_UNROLL, *,
                  state: FleetState | None = None,
                  return_state: bool = False,
                  num_active: int | None = None,
                  path: str = "auto", use_kernel=None, device="cuda"):
    """Round-robin fleet of P programs sharing one reconfigurable core:
    (P, N) traces -> FleetResult (and the final `FleetState` with
    `return_state=True`).

    `state` resumes a prior run's `FleetState` (on `device`); counters are
    cumulative, so a split run equals the one-shot run bit for bit.
    Dispatch follows the reference: runs with a warm bitstream cache ride
    the interleaved engine — one-shot, or seeded from the state and
    materialised back out in canonical form — and everything else
    (unseedable states, cold bitstream caches, sub-threshold quanta,
    masked slots) the reference machine, whose states are canonicalised
    too.  `path="scan"|"interleaved"` forces an engine; `use_kernel` picks
    the window pass ('auto' | 'kernel' | 'plain').  `num_active` masks the
    disambiguator down to its first `num_active` slots."""
    dev = _device(device)
    traces = _i32(traces, dev)
    if traces.dim() != 2:
        raise ValueError(
            f"simulate_many expects (P, N) traces, got shape "
            f"{tuple(traces.shape)}")
    num_progs = traces.shape[0]
    table = fleet_tag_table(scenarios, num_progs)
    schedule = sched.schedule(num_progs)
    if path not in ("auto", "scan", "interleaved"):
        raise ValueError(
            f"unknown path {path!r} — simulate_many accepts "
            f"'auto'|'scan'|'interleaved' (solo unpreempted runs take the "
            f"stack-distance engine through simulate_single/sweep_fleet)")
    quanta = sched.quanta(num_progs)
    active = cfg.num_slots if num_active is None else int(num_active)
    if not 1 <= active <= cfg.num_slots:
        raise ValueError(
            f"num_active must be in [1, {cfg.num_slots}] "
            f"(the allocated slot count), got {num_active}")
    masked = active < cfg.num_slots
    if masked and path == "interleaved":
        raise ValueError(
            "a masked (degraded) disambiguator rides the scan — the "
            "interleaved engine seeds full-geometry caches only; use "
            "path='auto' or 'scan'")
    if state is not None:
        _check_fleet_state(state, num_progs, cfg.num_slots,
                           cfg.bs_cache_entries)
        if masked and bool(np.any(_np(state.slot_st.tags)[active:] >= 0)):
            raise ValueError(
                f"num_active={active} masks slots the state still "
                f"populates — apply simulator.degrade_fleet_state first "
                f"so the dead slots hold no residents")
        if int(state.sched_idx) >= schedule.shape[0]:
            raise ValueError(
                f"FleetState scheduler cursor {int(state.sched_idx)} is "
                f"out of range for a priority schedule of length "
                f"{schedule.shape[0]} — resume must use a SchedulerConfig "
                f"whose priority weights produce a schedule at least as "
                f"long as the one the state was built under")
    eligible = interleaved_eligible(
        table, bs_entries=cfg.bs_cache_entries,
        miss_latencies=[cfg.miss_latency], bs_miss_extra=cfg.bs_miss_extra,
        handler_cycles=sched.handler_cycles, total_steps=total_steps)
    if state is None and not return_state:
        # one-shot result-only: no state to seed or materialise
        if path == "interleaved" and not eligible:
            raise ValueError(
                "interleaved path requires a warm bitstream cache over the "
                "fleet's merged tag set and non-negative int32-safe costs "
                "(see simulator.interleaved_eligible)")
        if path == "interleaved" or (
                path == "auto" and not masked and eligible
                and _interleaved_auto_ok(
                    quanta[None, :], 1, int(np.max(table)) + 1, total_steps,
                    None, dev)):
            res = _sweep_fleet_interleaved(
                traces[None], table, _i32([cfg.miss_latency], dev),
                _i32([cfg.num_slots], dev), quanta[None, :], schedule,
                sched.handler_cycles, cfg.bs_miss_extra, total_steps, None,
                use_kernel)
            return FleetResult(*(x[0, 0, 0, 0] for x in res))
    else:
        # state-carrying: seed the resumable engine from the given state
        # (or the cold init state for one-shot return_state runs)
        seed_state = state if state is not None else init_fleet_state(
            num_progs, cfg.num_slots, cfg.bs_cache_entries, dev)
        num_tags = _engine_num_tags(table, seed_state)
        worst_step = (int(np.max(isa.INSTR_HW_CYCLES))
                      + int(cfg.miss_latency) + int(cfg.bs_miss_extra)
                      + int(sched.handler_cycles))
        resumable = (not masked and eligible
                     and cfg.bs_cache_entries >= num_tags
                     and _seedable_fleet_state(seed_state, num_tags,
                                               worst_step, total_steps))
        if path == "interleaved" and not resumable:
            raise ValueError(
                "interleaved path requires a warm bitstream cache over the "
                "fleet's merged tag set, non-negative int32-safe costs, "
                "and a scan-shaped FleetState seed with int32 headroom "
                "(see simulator.interleaved_eligible and "
                "simulator._seedable_fleet_state)")
        if path == "interleaved" or (
                path == "auto" and resumable and _interleaved_auto_ok(
                    quanta[None, :], 1, num_tags, total_steps, None, dev)):
            res, final = _resume_fleet_interleaved(
                traces, table, cfg, quanta, schedule, sched.handler_cycles,
                seed_state, total_steps, num_tags, use_kernel)
            if not return_state:
                return res
            return res, _state_from_final(final, seed_state, cfg.num_slots,
                                          cfg.bs_cache_entries, num_tags,
                                          total_steps)
    res, final = _simulate_fleet_impl(
        traces, table, cfg.miss_latency, active, quanta, schedule,
        sched.handler_cycles, cfg.num_slots, cfg.bs_cache_entries,
        cfg.bs_miss_extra, total_steps, scan_unroll, state)
    return (res, _canonical_state(final)) if return_state else res


def _sweep_fleet(fleets, tag_table, miss_latencies, slot_counts, quanta,
                 schedule, handler, num_slots: int, bs_entries: int,
                 bs_miss_extra, total_steps: int,
                 scan_unroll: int) -> FleetResult:
    """The reference machine over the whole (Q, B, K, L) grid, every cell
    one lane of one batched step loop (slot counts by masking a
    `num_slots`-entry disambiguator)."""
    dev = fleets.device
    nb, num_progs, _ = fleets.shape
    ptags, pcosts = _gather(fleets, tag_table)
    counts = _i32(slot_counts, dev).reshape(-1)
    lats = _i32(miss_latencies, dev).reshape(-1)
    quanta = _i32(quanta, dev)
    shape = (quanta.shape[0], nb, counts.shape[0], lats.shape[0])
    q, b, k, l = (x.reshape(-1) for x in torch.meshgrid(
        *(torch.arange(n, device=dev) for n in shape), indexing="ij"))
    lanes = q.shape[0]
    final = _scan_lanes(
        ptags, pcosts, b, lats[l], counts[k], quanta[q],
        _i32(schedule, dev).reshape(-1), int(handler), int(bs_miss_extra),
        _init_lanes(lanes, num_progs, num_slots, bs_entries, dev),
        total_steps)
    pshape = shape + (num_progs,)
    return FleetResult(final.cycles.reshape(pshape),
                       final.instrs.reshape(pshape),
                       final.misses.reshape(pshape),
                       final.bs_misses.reshape(pshape),
                       final.switches.reshape(shape))


# the distance profile materialises (total_steps, num_tags)-shaped int32
# temporaries per batched lane; cap chunk * total_steps * num_tags
_STACKDIST_CHUNK_ELEMS = 16_000_000


def _stackdist_chunk(total_steps: int, num_tags: int) -> int:
    return max(1, _STACKDIST_CHUNK_ELEMS
               // max(total_steps * max(num_tags, 1), 1))


def _unpreempted_result(cycles, slot_misses, bs_misses, num_progs: int,
                        total_steps: int) -> FleetResult:
    """Scan-shaped FleetResult of an unpreempted (B, K, L) grid: program 0
    ran every step, the others never, no switch fired."""
    b, k, l = cycles.shape
    dev = cycles.device
    zeros = torch.zeros((b, k, l, num_progs), dtype=torch.int32, device=dev)
    out = [zeros.clone() for _ in range(4)]
    out[0][..., 0] = cycles
    out[1][..., 0] = total_steps
    out[2][..., 0] = slot_misses
    out[3][..., 0] = bs_misses
    return FleetResult(*out, switches=torch.zeros((b, k, l),
                                                  dtype=torch.int32,
                                                  device=dev))


def _sweep_fleet_stackdist(fleets, table, lats, counts, bs_miss_extra,
                           total_steps: int) -> FleetResult:
    """The scan-shaped FleetResult from one stack-distance pass per fleet
    (program 0 only), the fleet axis in memory-bounded chunks."""
    num_progs = fleets.shape[1]
    num_tags = max(int(np.max(table[0])) + 1, 1)
    chunk = _stackdist_chunk(total_steps, num_tags)
    grids = [
        stackdist.sweep_unpreempted(
            fleets[i:i + chunk, 0, :], table[0], isa.INSTR_HW_CYCLES,
            counts, lats, bs_miss_extra, num_tags=num_tags,
            total_steps=total_steps)
        for i in range(0, fleets.shape[0], chunk)]
    cycles = torch.cat([g.cycles for g in grids])
    slot_misses = torch.cat([g.slot_misses for g in grids])
    bs_misses = torch.cat([g.bs_misses for g in grids])
    return _unpreempted_result(cycles, slot_misses[:, :, None],
                               bs_misses[:, None, None], num_progs,
                               total_steps)


def _sweep_fleet_stackdist_cold(fleets, table, lats, counts, bs_entries,
                                bs_miss_extra,
                                total_steps: int) -> FleetResult:
    """The scan-shaped FleetResult from the stacked cold pass (program 0
    only); the bitstream-miss count varies with the slot count."""
    num_progs = fleets.shape[1]
    num_tags = max(int(np.max(table[0])) + 1, 1)
    chunk = max(1, _stackdist_chunk(total_steps, num_tags)
                // max(int(counts.shape[0]), 1))
    grids = [
        stackdist_cold.sweep_cold(
            fleets[i:i + chunk, 0, :], table[0], isa.INSTR_HW_CYCLES,
            counts, lats, [bs_entries], [bs_miss_extra], num_tags=num_tags,
            total_steps=total_steps)
        for i in range(0, fleets.shape[0], chunk)]
    cycles = torch.cat([g.cycles[:, :, :, 0, 0] for g in grids])
    slot_misses = torch.cat([g.slot_misses for g in grids])
    bs_misses = torch.cat([g.bs_misses[:, :, 0] for g in grids])
    return _unpreempted_result(cycles, slot_misses[:, :, None],
                               bs_misses[:, :, None], num_progs,
                               total_steps)


def _sweep_fleet_interleaved(fleets, table, lats, counts, quanta_grid,
                             schedule, handler, bs_miss_extra,
                             total_steps: int, window: int | None,
                             use_kernel=None) -> FleetResult:
    """Serve the full (Q, B, K, L) grid from the interleave-aware engine.

    The fleet axis goes in memory-bounded chunks, each padded up to a
    multiple of `_INTERLEAVED_BATCH_BUCKET` fleets (replays of the chunk's
    first fleet, sliced off the result), as in the reference."""
    dev = fleets.device
    num_tags = max(int(np.max(table)) + 1, 1)
    w = _interleaved_window(quanta_grid, total_steps, window, dev)
    cells = quanta_grid.shape[0] * counts.shape[0] * lats.shape[0]
    chunk = max(1, _INTERLEAVED_CHUNK_ELEMS // max(w * num_tags * cells, 1))
    b_total = fleets.shape[0]
    grids = []
    for i in range(0, b_total, chunk):
        part = fleets[i:i + chunk]
        if b_total > chunk:
            target = chunk          # tail rides the full-chunk shape
        else:
            target = min(-(-b_total // _INTERLEAVED_BATCH_BUCKET)
                         * _INTERLEAVED_BATCH_BUCKET, chunk)
        pad = target - part.shape[0]
        if pad > 0:
            part = torch.cat([part, part[:1].expand(
                (pad,) + tuple(part.shape[1:]))], dim=0)
        grids.append(stackdist_interleaved.sweep_preempted(
            part, table, isa.INSTR_HW_CYCLES, counts, lats,
            _i32(quanta_grid, dev), _i32(schedule, dev), int(handler),
            int(bs_miss_extra), num_tags=num_tags, total_steps=total_steps,
            window=w, use_kernel=use_kernel))
    return FleetResult(*(torch.cat([g[f] for g in grids], dim=1)[:, :b_total]
                         for f in range(5)))


def sweep_fleet(fleets, miss_latencies, scenarios, sched: SchedulerConfig,
                *, slot_counts, quanta=None, bs_cache_entries: int = 64,
                bs_miss_extra: int = 100, total_steps: int = 400_000,
                path: str = "auto", scan_unroll: int = SCAN_UNROLL,
                interleave_window: int | None = None, use_kernel=None,
                device="cuda") -> FleetResult:
    """One call over the {quanta x fleets x slot counts x miss latencies}
    grid.

    fleets: (B, P, N) int32 traces.  Result axes: (B, K_slots, L_lat, P),
    or (Q, B, K_slots, L_lat, P) when `quanta` is given (each entry a
    scalar or a length-P vector).  Dispatch as in the reference:
    unpreempted warm grids take the stack-distance pass, unpreempted cold
    ones the stacked cold pass, preempted fleet-warm grids the interleaved
    engine (window pass on the card's kernel), and the rest the reference
    machine; `path` forces one ("stackdist"/"stackdist_cold"/"interleaved"
    raise if ineligible).  `interleave_window` overrides the window size
    and `use_kernel` the window pass; results are identical for any value
    of either."""
    dev = _device(device)
    fleets = _i32(fleets, dev)
    if fleets.dim() != 3:
        raise ValueError(
            f"sweep_fleet expects (B, P, N) fleet traces, got shape "
            f"{tuple(fleets.shape)}")
    num_progs = fleets.shape[1]
    table = fleet_tag_table(scenarios, num_progs)
    counts = _i32(slot_counts, dev).reshape(-1)
    lats = _i32(miss_latencies, dev).reshape(-1)
    if quanta is None:
        quanta_grid = sched.quanta(num_progs)[None, :]          # (1, P)
    else:
        if np.isscalar(quanta) or getattr(quanta, "ndim", None) == 0:
            raise ValueError(
                f"quanta must be a sequence of quantum cells (scalars or "
                f"per-program vectors), got bare scalar {quanta!r} — pass "
                f"quanta=[{quanta!r}] for a single-cell axis")
        quanta = list(quanta)
        if not quanta:
            raise ValueError("quanta needs at least one quantum cell")
        quanta_grid = np.stack([quanta_vector(q, num_progs) for q in quanta])
    max_lat = int(np.max(_np(miss_latencies)))
    eligible = stackdist_eligible(
        table[0], quantum_cycles=quanta_grid, bs_entries=bs_cache_entries,
        max_miss_latency=max_lat, bs_miss_extra=bs_miss_extra,
        total_steps=total_steps)
    inter_eligible = interleaved_eligible(
        table, bs_entries=bs_cache_entries, miss_latencies=lats,
        bs_miss_extra=bs_miss_extra, handler_cycles=sched.handler_cycles,
        total_steps=total_steps)
    inter_auto = _interleaved_auto_ok(
        quanta_grid, quanta_grid.shape[0] * counts.shape[0] * lats.shape[0],
        int(np.max(table)) + 1, total_steps, interleave_window, dev)
    cold_eligible = stackdist_cold_eligible(
        quantum_cycles=quanta_grid, max_miss_latency=max_lat,
        bs_miss_extra=bs_miss_extra, total_steps=total_steps)
    chosen = _check_path(path, eligible, inter_eligible, inter_auto,
                         cold_eligible)
    if chosen in ("stackdist", "stackdist_cold"):
        if chosen == "stackdist":
            res = _sweep_fleet_stackdist(fleets, table, lats, counts,
                                         bs_miss_extra, total_steps)
        else:
            res = _sweep_fleet_stackdist_cold(
                fleets, table, lats, counts, bs_cache_entries,
                bs_miss_extra, total_steps)
        if quanta is None:
            return res
        # every quantum cell is unpreempted, so cells are identical
        q = quanta_grid.shape[0]
        return FleetResult(*(x[None].expand((q,) + tuple(x.shape))
                             for x in res))
    if chosen == "interleaved":
        res = _sweep_fleet_interleaved(
            fleets, table, lats, counts, quanta_grid,
            sched.schedule(num_progs), sched.handler_cycles, bs_miss_extra,
            total_steps, interleave_window, use_kernel)
    else:
        res = _sweep_fleet(
            fleets, table, lats, counts, quanta_grid,
            sched.schedule(num_progs), sched.handler_cycles,
            int(np.max(_np(slot_counts))), bs_cache_entries, bs_miss_extra,
            total_steps, scan_unroll)
    if quanta is None:
        return FleetResult(*(x[0] for x in res))
    return res


def sweep_bitstream(traces, scenario: isa.SlotScenario, *, slot_counts,
                    miss_latencies, bs_entries, bs_miss_extras,
                    total_steps: int, path: str = "auto",
                    device="cuda") -> stackdist_cold.ColdGrid:
    """Solo-program sweep over {slot count x miss latency x bitstream
    capacity x bitstream penalty}: (B, N) traces -> `ColdGrid` with
    (B, K, L, E, X) cycles, (B, K) slot misses and (B, K, E) bitstream
    misses.  Eligible runs take the stacked Mattson pass; `path="scan"`
    runs the reference machine once per cell (the parity reference)."""
    dev = _device(device)
    traces = _i32(traces, dev)
    if traces.dim() != 2:
        raise ValueError(
            f"sweep_bitstream expects (B, N) solo traces, got shape "
            f"{tuple(traces.shape)}")
    counts = np.asarray(slot_counts, np.int32).reshape(-1)
    lats = np.asarray(miss_latencies, np.int32).reshape(-1)
    caps = np.asarray(bs_entries, np.int32).reshape(-1)
    extras = np.asarray(bs_miss_extras, np.int32).reshape(-1)
    cold_ok = stackdist_cold_eligible(
        quantum_cycles=NO_PREEMPT_QUANTUM,
        max_miss_latency=int(np.max(lats)),
        bs_miss_extra=int(np.max(extras)), total_steps=total_steps)
    if path not in ("auto", "stackdist_cold", "scan"):
        raise ValueError(
            f"unknown path {path!r} — sweep_bitstream accepts "
            f"'auto'|'stackdist_cold'|'scan'")
    if path == "stackdist_cold" and not cold_ok:
        raise ValueError(
            "stacked cold-bitstream path requires an unpreempted run with "
            "int32-safe costs (see simulator.stackdist_cold_eligible)")
    if path != "scan" and cold_ok:
        return stackdist_cold.sweep_cold(
            traces, scenario.instr_tag, isa.INSTR_HW_CYCLES, counts, lats,
            caps, extras, num_tags=max(scenario.num_tags, 1),
            total_steps=total_steps)
    # reference fallback: one scan per cell (slot/bitstream misses do not
    # depend on the latency/penalty axes in an unpreempted run)
    b = traces.shape[0]
    shape = (b, counts.size, lats.size, caps.size, extras.size)
    cycles = np.zeros(shape, np.int32)
    slot_misses = np.zeros(shape[:2], np.int32)
    bs_misses = np.zeros((b, counts.size, caps.size), np.int32)
    idx = torch.remainder(torch.arange(total_steps, device=dev),
                          traces.shape[-1])
    for i in range(b):
        stream = traces[i][idx]
        for k, s in enumerate(counts):
            for e, cap in enumerate(caps):
                for l, lat in enumerate(lats):
                    for x, pen in enumerate(extras):
                        r = simulate_single(
                            stream,
                            ReconfigConfig(num_slots=int(s),
                                           miss_latency=int(lat),
                                           bs_cache_entries=int(cap),
                                           bs_miss_extra=int(pen)),
                            scenario, path="scan", device=dev)
                        cycles[i, k, l, e, x] = int(r.cycles)
                        slot_misses[i, k] = int(r.slot_misses)
                        bs_misses[i, k, e] = int(r.bs_misses)
    return stackdist_cold.ColdGrid(cycles=_i32(cycles, dev),
                                   slot_misses=_i32(slot_misses, dev),
                                   bs_misses=_i32(bs_misses, dev))


# --- pair path: the P=2 special case


def simulate_pair(traces, cfg: ReconfigConfig, scenario: isa.SlotScenario,
                  sched: SchedulerConfig, total_steps: int = 400_000,
                  device="cuda") -> PairResult:
    r = simulate_many(traces, cfg, scenario, sched, total_steps,
                      device=device)
    return PairResult(r.cycles, r.instructions, r.slot_misses, r.switches)


def simulate_pair_batch(traces, cfg: ReconfigConfig,
                        scenario: isa.SlotScenario, sched: SchedulerConfig,
                        total_steps: int = 400_000,
                        device="cuda") -> PairResult:
    """traces: (B, P, N) — one-cell sweep over the pair lanes."""
    r = sweep_fleet(
        traces, [cfg.miss_latency], scenario, sched,
        slot_counts=[cfg.num_slots], bs_cache_entries=cfg.bs_cache_entries,
        bs_miss_extra=cfg.bs_miss_extra, total_steps=total_steps,
        device=device)
    return PairResult(r.cycles[:, 0, 0], r.instructions[:, 0, 0],
                      r.slot_misses[:, 0, 0], r.switches[:, 0, 0])


# ---------------------------------------------------------------------------
# fixed-ISA analytic helpers (Fig. 4 baselines; fleet variant for Fig. 7)
# ---------------------------------------------------------------------------


def fixed_fleet_cpi(mix: Mix, spec: isa.Spec, sched: SchedulerConfig,
                    program_index: int = 0) -> float:
    """CPI of a fixed-ISA machine inside a round-robin fleet (any P): the
    handler amortises as handler * CPI / quantum per instruction."""
    cpi = analytic_cpi(mix, spec)
    q = np.asarray(sched.quantum_cycles).reshape(-1)
    quantum = int(q[program_index if q.size > 1 else 0])
    return cpi * (1.0 + sched.handler_cycles / quantum)


fixed_pair_cpi = fixed_fleet_cpi
