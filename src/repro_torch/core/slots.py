"""Instruction disambiguator — a functional fully-associative LRU cache.

Paper §IV, Fig. 2: the disambiguator is a small fully-associative L0 cache
whose tags are instruction opcodes (plus function fields).  On a hit it
multiplexes the operands to the slot holding the implementation; on a miss it
requests the bitstream from the bitstream cache and reconfigures the LRU
victim slot, paying a (technology-dependent) reconfiguration latency.

PyTorch port of `repro.core.slots`: exact LRU semantics as pure functions
over a tiny state tuple of int32 tensors.  Every function also takes states
with leading batch dimensions — `tags`/`last_use` of shape (..., S), `clock`
and the probed tag of shape (...) — which is how the simulator's reference
machine steps every lane of a sweep grid at once (the JAX package's `vmap`
written out as a batch dimension).  Tie-breaks match the reference: the hit
slot is the first matching entry and the victim the first argmin.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EMPTY = -1
_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


class SlotState(NamedTuple):
    """Disambiguator state.

    tags:     (..., S) int32 — tag resident in each slot, -1 when empty.
    last_use: (..., S) int32 — LRU clock value of the slot's last touch.
    clock:    (...)    int32 — monotonically increasing use counter.
    """

    tags: torch.Tensor
    last_use: torch.Tensor
    clock: torch.Tensor


def init(num_slots: int, device="cuda", batch: tuple = ()) -> SlotState:
    return SlotState(
        tags=torch.full(tuple(batch) + (num_slots,), EMPTY,
                        dtype=torch.int32, device=device),
        last_use=torch.zeros(tuple(batch) + (num_slots,), dtype=torch.int32,
                             device=device),
        clock=torch.zeros(tuple(batch), dtype=torch.int32, device=device),
    )


class LookupResult(NamedTuple):
    state: SlotState
    hit: torch.Tensor          # (...) bool — tag was resident (or unslotted)
    slot: torch.Tensor         # (...) int32 — slot serving the tag (-1 unslotted)
    evicted_tag: torch.Tensor  # (...) int32 — tag displaced on a fill, else -1


def _as_i32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=like.device)


def _access(state: SlotState, tag, num_active=None):
    """Shared LRU core: hit-test + victim fill, one implementation.

    Returns (new_state, hit, slot, unslotted, victim), like the reference,
    so `lookup` and `lookup_fused` build on the same eviction logic.
    """
    tag = _as_i32(tag, state.tags)
    unslotted = tag < 0
    n = state.tags.shape[-1]

    matches = state.tags == tag.unsqueeze(-1)
    if num_active is not None:
        in_active = (torch.arange(n, dtype=torch.int32,
                                  device=state.tags.device)
                     < _as_i32(num_active, state.tags).unsqueeze(-1))
        matches = matches & in_active
    hit_any = matches.any(-1) & ~unslotted
    # first matching entry (argmax over an int mask returns the first max)
    hit_slot = matches.to(torch.int32).argmax(-1)

    # LRU victim: prefer empty slots (their last_use is forced to int32 min)
    empties = state.tags == EMPTY
    use_key = torch.where(empties, _I32_MIN, state.last_use)
    if num_active is not None:
        use_key = torch.where(in_active, use_key, _I32_MAX)
    victim = use_key.argmin(-1)

    slot = torch.where(hit_any, hit_slot, victim)

    clock = state.clock + 1
    do_touch = ~unslotted
    at_slot = (torch.arange(n, device=state.tags.device)
               == slot.unsqueeze(-1))
    fill = at_slot & (do_touch & ~hit_any).unsqueeze(-1)
    new_tags = torch.where(fill, tag.unsqueeze(-1), state.tags)
    touch = at_slot & do_touch.unsqueeze(-1)
    new_last = torch.where(touch, clock.unsqueeze(-1), state.last_use)
    new_state = SlotState(tags=new_tags, last_use=new_last, clock=clock)
    return (new_state, hit_any | unslotted, slot.to(torch.int32), unslotted,
            victim.to(torch.int32))


def lookup(state: SlotState, tag, num_active=None) -> LookupResult:
    """Access `tag`; fill the LRU victim on a miss.  tag == -1 is unslotted
    (a hardwired base instruction) and leaves the state untouched but still
    reports hit=True so callers charge no reconfiguration latency.

    `num_active` (optional) restricts the cache to the first `num_active`
    slots: inactive slots never match and are never victims, which makes the
    state behave exactly like an LRU cache of that size.
    """
    tag = _as_i32(tag, state.tags)
    new_state, hit, slot, unslotted, victim = _access(state, tag, num_active)
    victim_tag = state.tags.gather(-1, victim.long().unsqueeze(-1))[..., 0]
    evicted = torch.where(hit | unslotted, EMPTY, victim_tag)
    return LookupResult(
        state=new_state,
        hit=hit,
        slot=torch.where(unslotted, EMPTY, slot),
        evicted_tag=evicted,
    )


def lookup_fused(slot_state: SlotState, bs_state: SlotState, tag,
                 num_active=None):
    """One fused disambiguator + bitstream-cache access — the fleet scan's
    hot pair.  Semantically `lookup(slot_state, tag, num_active)` followed
    by `lookup(bs_state, where(hit, -1, tag))`; returns
    (slot_state, bs_state, hit, bs_hit)."""
    tag = _as_i32(tag, slot_state.tags)
    slot_state, hit, _, _, _ = _access(slot_state, tag, num_active)
    bs_state, bs_hit, _, _, _ = _access(
        bs_state, torch.where(hit, EMPTY, tag))
    return slot_state, bs_state, hit, bs_hit


def lookup_batch(state: SlotState, tags, num_active=None
                 ) -> tuple[SlotState, torch.Tensor]:
    """Sequentially access a vector of tags (last axis); returns
    (state, hits bool tensor of the tags' shape)."""
    tags = _as_i32(tags, state.tags)
    hits = []
    for i in range(tags.shape[-1]):
        r = lookup(state, tags[..., i], num_active)
        state = r.state
        hits.append(r.hit)
    if not hits:
        return state, torch.zeros(tags.shape, dtype=torch.bool,
                                  device=tags.device)
    return state, torch.stack(hits, dim=-1)


def invalidate(state: SlotState, idx) -> SlotState:
    """SEU surgery: kill the residents at entry indices `idx` (the entries
    become empty: tag -1, last_use 0; clock and survivors untouched)."""
    idx = torch.as_tensor(idx, dtype=torch.long,
                          device=state.tags.device).reshape(-1)
    tags = state.tags.clone()
    last = state.last_use.clone()
    tags[..., idx] = EMPTY
    last[..., idx] = 0
    return SlotState(tags=tags, last_use=last, clock=state.clock)


def occupancy(state: SlotState) -> torch.Tensor:
    return (state.tags != EMPTY).sum(-1, dtype=torch.int32)


def resident(state: SlotState, tag) -> torch.Tensor:
    """Non-mutating residency probe (no LRU touch)."""
    tag = _as_i32(tag, state.tags)
    return (state.tags == tag.unsqueeze(-1)).any(-1) & (tag >= 0)


def resident_many(state: SlotState, tags) -> torch.Tensor:
    """Vectorised `resident`: (T,) bool residency per probed tag."""
    tags = _as_i32(tags, state.tags)
    return (state.tags[None, :] == tags[:, None]).any(1) & (tags >= 0)
