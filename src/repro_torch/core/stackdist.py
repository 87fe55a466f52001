"""Single-pass LRU stack-distance engine (Mattson et al., 1970).

PyTorch port of `repro.core.stackdist`.  LRU has the *stack-inclusion*
property, so one pass over a tag stream yields exact hit/miss counts for
every cache size at once: an access whose stack distance (distinct slotted
tags touched since its previous occurrence) is `d` hits in any cache of
more than `d` slots; first touches miss at every size.  Whenever a run is
unpreempted (only program 0 runs) and its bitstream cache is warm, the
whole {slot count x miss latency} grid reconstructs affinely:

    slot_misses(S) = cold + #{accesses with distance >= S}
    bs_misses      = cold
    cycles(S, L)   = sum(hw[instr]) + slot_misses(S) * L
                     + bs_misses * bs_miss_extra

The distances come from a (steps, num_tags) last-occurrence matrix built
with `torch.cummax`.  All arithmetic is int32 like the reference: every
reduction pins `dtype=torch.int32` (torch's integer sums and cumsums
default to int64) and `torch.bincount`'s int64 result is cast back.  The
module is generic: callers pass the per-opcode tag and cost tables.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "DistanceProfile", "SweepGrid",
    "distance_profile", "misses_for_counts", "cycles_grid",
    "sweep_unpreempted", "lanes_unpreempted",
]


class DistanceProfile(NamedTuple):
    """Everything the affine cycle reconstruction needs, per tag stream
    (leading batch axes allowed)."""

    hist: torch.Tensor         # (..., num_tags) int32 reuse accesses at
                               # finite stack distance d
    cold: torch.Tensor         # (...) int32 first-touch accesses
    base_cycles: torch.Tensor  # (...) int32 sum of per-instruction hw cycles
    steps: torch.Tensor        # (...) int32 stream length (== instructions)


class SweepGrid(NamedTuple):
    """Reconstructed counters over a {slot count x miss latency} grid."""

    cycles: torch.Tensor       # (..., K, L) int32
    slot_misses: torch.Tensor  # (..., K) int32 — latency-independent
    bs_misses: torch.Tensor    # (...,) int32 — size- and latency-independent


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def _prev_and_dist(tags: torch.Tensor, occurrence: torch.Tensor,
                   num_tags: int):
    """(B, N) tags + (B, N, T) occurrence positions -> (prev_self, dist):
    each access's previous occurrence and its stack distance over the
    cummax of `occurrence` (shifted to *strictly before* the access)."""
    last_pos = torch.cummax(occurrence, dim=1).values
    prev = torch.cat(
        [torch.full_like(last_pos[:, :1], -1), last_pos[:, :-1]], dim=1)
    safe = tags.clamp(min=0).long()  # clamp -1 so the gather stays in-bounds
    prev_self = prev.gather(2, safe.unsqueeze(2))[..., 0]
    # distinct tags touched after my previous occurrence (excludes myself)
    dist = (prev > prev_self.unsqueeze(2)).sum(2, dtype=torch.int32)
    return prev_self, dist


def _bincount_rows(bucket: torch.Tensor, length: int) -> torch.Tensor:
    """Row-wise bincount of a (B, N) int tensor with values in [0, length)
    -> (B, length) int32."""
    b = bucket.shape[0]
    offs = torch.arange(b, device=bucket.device).unsqueeze(1) * length
    flat = torch.bincount((bucket.long() + offs).reshape(-1),
                          minlength=b * length)
    return flat.reshape(b, length).to(torch.int32)


def _profile_rows(tags: torch.Tensor, costs: torch.Tensor,
                  num_tags: int) -> DistanceProfile:
    """(B, N) tag streams (-1 = unslotted) + hw costs -> batched profile."""
    b, n = tags.shape
    dev = tags.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    tag_ids = torch.arange(num_tags, dtype=torch.int32, device=dev)
    occurrence = torch.where(tags.unsqueeze(2) == tag_ids,
                             idx.view(1, n, 1), -1).to(torch.int32)
    prev_self, dist = _prev_and_dist(tags, occurrence, num_tags)
    slotted = tags >= 0
    cold = slotted & (prev_self < 0)
    bucket = torch.where(slotted & ~cold, dist, num_tags)
    hist = _bincount_rows(bucket, num_tags + 1)[:, :num_tags]
    return DistanceProfile(
        hist=hist,
        cold=cold.sum(1, dtype=torch.int32),
        base_cycles=costs.sum(1, dtype=torch.int32),
        steps=torch.full((b,), n, dtype=torch.int32, device=dev),
    )


def _profile_one(tags: torch.Tensor, costs: torch.Tensor,
                 num_tags: int) -> DistanceProfile:
    """(N,) tag stream (-1 = unslotted) + (N,) hw costs -> DistanceProfile."""
    p = _profile_rows(tags[None], costs[None], num_tags)
    return DistanceProfile(*(x[0] for x in p))


def distance_profile(tags, costs, num_tags: int,
                     device="cuda") -> DistanceProfile:
    """Profile one (N,) tag/cost stream.  num_tags must cover max(tags)+1."""
    return _profile_one(_i32(tags, device), _i32(costs, device), num_tags)


def misses_for_counts(profile: DistanceProfile,
                      slot_counts) -> torch.Tensor:
    """(..., K) exact LRU miss counts, one per requested slot count."""
    hist = profile.hist
    num_tags = hist.shape[-1]
    # tail[s] = reuse accesses with distance >= s; tail[num_tags] = 0
    tail = torch.cat(
        [torch.flip(torch.cumsum(torch.flip(hist, [-1]), -1,
                                 dtype=torch.int32), [-1]),
         torch.zeros(hist.shape[:-1] + (1,), dtype=torch.int32,
                     device=hist.device)], dim=-1)
    counts = _i32(slot_counts, hist.device).reshape(-1).clamp(0, num_tags)
    return profile.cold.unsqueeze(-1) + tail[..., counts.long()]


def cycles_grid(profile: DistanceProfile, slot_counts, miss_latencies,
                bs_miss_extra) -> SweepGrid:
    """Affine reconstruction over the full {slot count x latency} grid."""
    dev = profile.hist.device
    misses = misses_for_counts(profile, slot_counts)             # (..., K)
    lats = _i32(miss_latencies, dev).reshape(-1)                 # (L,)
    cycles = (profile.base_cycles[..., None, None]
              + misses.unsqueeze(-1) * lats
              + (profile.cold * int(bs_miss_extra))[..., None, None])
    return SweepGrid(cycles=cycles.to(torch.int32), slot_misses=misses,
                     bs_misses=profile.cold)


def _stream(traces: torch.Tensor, instr_tag, instr_costs,
            total_steps: int):
    """Unroll (..., N) instruction traces into (..., total_steps) tag/cost
    streams, wrapping the cursor exactly like the scan path does."""
    dev = traces.device
    idx = torch.remainder(torch.arange(total_steps, device=dev),
                          traces.shape[-1])
    stream = traces[..., idx].long()
    return (_i32(instr_tag, dev)[stream], _i32(instr_costs, dev)[stream])


def sweep_unpreempted(traces, instr_tag, instr_costs, slot_counts,
                      miss_latencies, bs_miss_extra, *, num_tags: int,
                      total_steps: int) -> SweepGrid:
    """Solo-program sweep: (B, N) traces -> SweepGrid with (B, K, L) cycles.
    Runs on the traces' device."""
    tags, costs = _stream(traces, instr_tag, instr_costs, total_steps)
    profiles = _profile_rows(tags, costs, num_tags)
    return cycles_grid(profiles, slot_counts, miss_latencies, bs_miss_extra)


def lanes_unpreempted(traces, instr_tag, instr_costs, num_slots,
                      miss_latencies, bs_miss_extra, *, num_tags: int,
                      total_steps: int):
    """Paired (trace, latency) lanes at one slot count — the
    `simulate_single_batch` shape.  Returns (cycles, slot_misses,
    bs_misses), each (B,) int32."""
    tags, costs = _stream(traces, instr_tag, instr_costs, total_steps)
    profiles = _profile_rows(tags, costs, num_tags)
    misses = misses_for_counts(profiles, [int(num_slots)])[:, 0]
    lats = _i32(miss_latencies, traces.device).reshape(-1)
    cycles = (profiles.base_cycles + misses * lats
              + profiles.cold * int(bs_miss_extra))
    return cycles.to(torch.int32), misses, profiles.cold
