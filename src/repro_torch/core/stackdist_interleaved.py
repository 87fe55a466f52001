"""Interleave-aware LRU stack-distance engine for *preempted* fleets.

PyTorch port of `repro.core.stackdist_interleaved`.  Under preemption the
round-robin quantum is counted in cycles, so the switch points — and with
them the merged access order — differ per {quantum x fleet x slots x
latency} cell.  Each cell therefore replays its own interleaving, but at
*scheduler-window* granularity: the carry holds the merged stream's per-tag
last-occurrence vector plus the scheduler state (per-program cursors,
schedule cursor, cycles burnt in the open quantum), and one trip of the
window loop commits one window of the scheduled program's accesses:

  1. gather the scheduled program's next `W` accesses (cursors wrap like
     the scan's);
  2. one cummax pass over the (W, num_tags) occurrence matrix, seeded with
     the carried last-occurrence vector, gives every access's stack
     distance in the merged stream;
  3. misses (first touch, or distance >= S) give per-access costs, the
     running cost sum the quantum-expiry point; the window commits up to
     it, and an expiry pays the handler and rotates the schedule.

Exactness needs a warm bitstream cache over the fleet's merged tag set
(`simulator.interleaved_eligible`); all arithmetic is int32, so eligible
results equal the scan's bit for bit.

**Resumable runs** (`resume_preempted`) seed a cell from a scan
`FleetState` translated into engine coordinates (`simulator._seed_carry`:
virtual per-tag positions in `[0, num_tags)`, segment positions from
`num_tags` up) and, tracking each tag's last slot-miss position, come back
out as a `FleetState` (`simulator._state_from_final`).

**The window pass** lives in `repro_torch.kernels.window_distance`: the
hand-written CUDA kernel for the card and the batched PyTorch body (the
plain version) beside it.  `use_kernel` picks one: None/'auto' launches the
kernel for CUDA tensors and runs the plain body for CPU tensors,
'kernel'/True forces the kernel (raising on CPU tensors), 'plain'/False
forces the plain body.  Every choice returns identical results.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import window_distance

__all__ = ["CellCarry", "InterleavedGrid", "resume_preempted",
           "sweep_preempted"]


class InterleavedGrid(NamedTuple):
    """Per-cell fleet counters over a {quantum x fleet x slots x latency}
    grid — the scan's `FleetResult` fields with (Q, B, K, L, ...) axes."""

    cycles: torch.Tensor        # (Q, B, K, L, P) int32, incl. handler
    instructions: torch.Tensor  # (Q, B, K, L, P) int32
    slot_misses: torch.Tensor   # (Q, B, K, L, P) int32
    bs_misses: torch.Tensor     # (Q, B, K, L, P) int32
    switches: torch.Tensor      # (Q, B, K, L) int32


class CellCarry(NamedTuple):
    """One cell's loop carry — also the seed/result type of the resumable
    entry.  Counters are cumulative.  `last_miss_pos` is live only when
    the cell materialises a resumable state; seeds pass -1s for it."""

    last_pos: torch.Tensor       # (num_tags,) merged-stream last occurrence
    last_miss_pos: torch.Tensor  # (num_tags,) last slot-miss occurrence
    cursors: torch.Tensor        # (P,) per-program trace cursor
    sched_idx: torch.Tensor      # () cursor into the priority schedule
    steps_done: torch.Tensor     # () committed accesses (merged position)
    q_cycles: torch.Tensor       # () cycles burnt in the open quantum
    cycles: torch.Tensor         # (P,) attributed cycles (incl. handler)
    instrs: torch.Tensor         # (P,)
    misses: torch.Tensor         # (P,) disambiguator misses
    bs_misses: torch.Tensor      # (P,) bitstream-cache misses
    switches: torch.Tensor       # () context switches


def _simulate_cell(ptags, pcosts, num_active, miss_latency, quanta,
                   schedule, handler, bs_miss_extra, num_tags: int,
                   total_steps: int, window: int,
                   seed: CellCarry | None = None,
                   materialise: bool = False):
    """One grid cell through the plain window body: (P, N) pre-gathered
    tag/cost streams -> the counter tuple (cycles, instrs, misses,
    bs_misses, switches), or with `materialise` the full final CellCarry.

    With a `seed` the cell resumes mid-run: segment positions shift up by
    `num_tags` above the seed's virtual block."""
    kseed = None if seed is None else (
        seed.last_pos, seed.cursors, seed.sched_idx, seed.q_cycles,
        seed.cycles, seed.instrs, seed.misses, seed.bs_misses,
        seed.switches)
    final = CellCarry(*window_distance.window_cell_plain(
        ptags, pcosts, num_active, miss_latency, quanta, schedule, handler,
        bs_miss_extra, kseed, num_tags=num_tags, total_steps=total_steps,
        window=window, materialise=materialise))
    if materialise:
        return final
    return (final.cycles, final.instrs, final.misses, final.bs_misses,
            final.switches)


def _gather_streams(fleets: torch.Tensor, tag_table, instr_costs):
    """(..., P, N) instruction ids -> (..., P, N) tag and hw-cost streams
    (the per-access dependent double gather hoisted out of the loop)."""
    dev = fleets.device
    table = torch.as_tensor(tag_table, dtype=torch.int32, device=dev)
    costs = torch.as_tensor(instr_costs, dtype=torch.int32, device=dev)
    idx = fleets.long()
    num_progs = fleets.shape[-2]
    prog = torch.arange(num_progs, device=dev).view(num_progs, 1)
    return table[prog, idx].contiguous(), costs[idx].contiguous()


def resume_preempted(fleet, tag_table, instr_costs, num_active,
                     miss_latency, quanta, schedule, handler, bs_miss_extra,
                     seed: CellCarry, *, num_tags: int, total_steps: int,
                     window: int, use_kernel=None) -> CellCarry:
    """One resumable cell: (P, N) traces + engine-coordinate seed -> final
    `CellCarry` (cumulative counters plus the per-tag occurrence vectors
    `simulator._state_from_final` turns back into a `FleetState`).  The
    seed's `last_miss_pos`/`steps_done` fields are ignored."""
    fleet = torch.as_tensor(fleet, dtype=torch.int32)
    ptags, pcosts = _gather_streams(fleet, tag_table, instr_costs)
    kseed = (seed.last_pos, seed.cursors, seed.sched_idx, seed.q_cycles,
             seed.cycles, seed.instrs, seed.misses, seed.bs_misses,
             seed.switches)
    fn = (window_distance.window_cell
          if window_distance.resolve(use_kernel, fleet.device)
          else window_distance.window_cell_plain)
    return CellCarry(*fn(
        ptags, pcosts, num_active, miss_latency, quanta, schedule, handler,
        bs_miss_extra, kseed, num_tags=num_tags, total_steps=total_steps,
        window=window, seeded=True, materialise=True))


def sweep_preempted(fleets, tag_table, instr_costs, slot_counts,
                    miss_latencies, quanta, schedule, handler,
                    bs_miss_extra, *, num_tags: int, total_steps: int,
                    window: int, use_kernel=None) -> InterleavedGrid:
    """Preempted-fleet sweep: (B, P, N) traces -> InterleavedGrid, every
    {quantum x fleet x slot count x latency} cell replaying its own
    interleaving; axis order matches the scan's sweep.  Runs on the
    fleets' device."""
    fleets = torch.as_tensor(fleets, dtype=torch.int32)
    ptags, pcosts = _gather_streams(fleets, tag_table, instr_costs)
    fn = (window_distance.window_grid
          if window_distance.resolve(use_kernel, fleets.device)
          else window_distance.window_grid_plain)
    return InterleavedGrid(*fn(
        ptags, pcosts, slot_counts, miss_latencies, quanta, schedule,
        handler, bs_miss_extra, num_tags=num_tags, total_steps=total_steps,
        window=window))
