"""Stacked Mattson pass: exact cold-bitstream sweeps for unpreempted runs.

PyTorch port of `repro.core.stackdist_cold`.  For an unpreempted run the
access order is fixed, so at each slot count ``S`` the disambiguator's miss
subsequence — the only accesses that touch the bitstream cache — is itself
an LRU reference stream.  A second Mattson pass over it gives every miss's
stack distance in the bitstream cache, and one histogram per slot count
answers every bitstream capacity ``E`` at once:

    bs_misses(S, E)    = cold + #{reuse misses with dist2 >= E}
    cycles(S, L, E, X) = base + slot_misses(S) * L + bs_misses(S, E) * X

All arithmetic is int32 like the reference scan (reductions pin
`dtype=torch.int32`), so eligible results are bit-for-bit identical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.stackdist import (_bincount_rows, _i32,
                                        _prev_and_dist, _stream)

__all__ = ["ColdGrid", "lanes_cold", "sweep_cold"]


class ColdGrid(NamedTuple):
    """Exact counters over the {slot count x latency x bitstream capacity
    x bitstream penalty} grid of one unpreempted run."""

    cycles: torch.Tensor       # (..., K, L, E, X) int32
    slot_misses: torch.Tensor  # (..., K) int32
    bs_misses: torch.Tensor    # (..., K, E) int32


def _cold_rows(tags: torch.Tensor, costs: torch.Tensor, slot_counts,
               miss_latencies, bs_entries, bs_miss_extras,
               num_tags: int) -> ColdGrid:
    """(B, N) tag streams (-1 = unslotted) + hw costs -> batched ColdGrid
    with (B, K, L, E, X) cycles."""
    b, n = tags.shape
    dev = tags.device
    idx = torch.arange(n, dtype=torch.int32, device=dev).view(1, n, 1)
    tag_ids = torch.arange(num_tags, dtype=torch.int32, device=dev)
    match = tags.unsqueeze(2) == tag_ids
    occurrence = torch.where(match, idx, -1).to(torch.int32)
    prev_self, dist = _prev_and_dist(tags, occurrence, num_tags)
    slotted = tags >= 0
    cold = slotted & (prev_self < 0)

    counts = _i32(slot_counts, dev).reshape(-1)
    slot_misses, hist2 = [], []
    for s in counts.tolist():
        # the miss subsequence at slot count s, re-profiled as its own LRU
        # reference stream (the bitstream cache sees exactly it)
        miss = slotted & (cold | (dist >= s))
        occ2 = torch.where(match & miss.unsqueeze(2), idx, -1).to(torch.int32)
        prev2_self, dist2 = _prev_and_dist(tags, occ2, num_tags)
        reuse = miss & (prev2_self >= 0)
        bucket = torch.where(reuse, dist2, num_tags)
        hist2.append(_bincount_rows(bucket, num_tags + 1)[:, :num_tags])
        slot_misses.append(miss.sum(1, dtype=torch.int32))
    slot_misses = torch.stack(slot_misses, 1)          # (B, K)
    hist2 = torch.stack(hist2, 1)                      # (B, K, num_tags)
    cold_count = cold.sum(1, dtype=torch.int32)
    base = costs.sum(1, dtype=torch.int32)

    # tail2[b, s, e] = reuse misses at slot count s with dist2 >= e
    tail2 = torch.cat(
        [torch.flip(torch.cumsum(torch.flip(hist2, [2]), 2,
                                 dtype=torch.int32), [2]),
         torch.zeros(hist2.shape[:2] + (1,), dtype=torch.int32,
                     device=dev)], dim=2)
    caps = _i32(bs_entries, dev).reshape(-1).clamp(0, num_tags)
    bs_misses = cold_count[:, None, None] + tail2[:, :, caps.long()]
    lats = _i32(miss_latencies, dev).reshape(-1)
    extras = _i32(bs_miss_extras, dev).reshape(-1)
    cycles = (base[:, None, None, None, None]
              + slot_misses[:, :, None, None, None]
              * lats[None, None, :, None, None]
              + bs_misses[:, :, None, :, None]
              * extras[None, None, None, None, :])
    return ColdGrid(cycles=cycles.to(torch.int32), slot_misses=slot_misses,
                    bs_misses=bs_misses.to(torch.int32))


def _cold_one(tags, costs, slot_counts, miss_latencies, bs_entries,
              bs_miss_extras, num_tags: int) -> ColdGrid:
    """(N,) tag stream (-1 = unslotted) + (N,) hw costs -> ColdGrid."""
    g = _cold_rows(tags[None], costs[None], slot_counts, miss_latencies,
                   bs_entries, bs_miss_extras, num_tags)
    return ColdGrid(*(x[0] for x in g))


def sweep_cold(traces, instr_tag, instr_costs, slot_counts, miss_latencies,
               bs_entries, bs_miss_extras, *, num_tags: int,
               total_steps: int) -> ColdGrid:
    """Solo-program sweep: (B, N) traces -> ColdGrid with (B, K, L, E, X)
    cycles, on the traces' device."""
    tags, costs = _stream(traces, instr_tag, instr_costs, total_steps)
    return _cold_rows(tags, costs, slot_counts, miss_latencies, bs_entries,
                      bs_miss_extras, num_tags)


def lanes_cold(traces, instr_tag, instr_costs, num_slots, miss_latencies,
               bs_entries, bs_miss_extra, *, num_tags: int,
               total_steps: int):
    """Paired (trace, latency) lanes at one slot count / capacity /
    penalty — the `simulate_single_batch` shape.  Returns
    (cycles, slot_misses, bs_misses), each (B,) int32."""
    tags, costs = _stream(traces, instr_tag, instr_costs, total_steps)
    lats = _i32(miss_latencies, traces.device).reshape(-1)
    g = _cold_rows(tags, costs, [int(num_slots)], [0], [int(bs_entries)],
                   [int(bs_miss_extra)], num_tags)
    # latency enters affinely: cycles at latency 0 plus misses * latency
    slot_misses = g.slot_misses[:, 0]
    cycles = g.cycles[:, 0, 0, 0, 0] + slot_misses * lats
    return cycles.to(torch.int32), slot_misses, g.bs_misses[:, 0, 0]
