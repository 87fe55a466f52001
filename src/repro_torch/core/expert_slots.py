"""Slot-resident experts: PyTorch port of `repro.core.expert_slots`.

Mapping (DESIGN.md §2): an MoE expert's weight block is the *bitstream*,
device memory is the *bitstream cache*, a per-device pool of S resident
experts is the *reconfigurable slot* array, and the router's expert id is
the *opcode*.  The disambiguator becomes a block-granular exact-LRU
residency tracker: a token block "executes" a set of expert ids; ids not
resident trigger a slot fill whose cost is bytes/bandwidth (the
reconfiguration latency analogue).

Beyond-paper knob: *slot-hit routing* biases the router's logits toward
resident experts (within a quality margin), trading routing fidelity for
fill traffic.

Functional torch ops over a small state, equal to the JAX package's bit
for bit, with two differences of the frozen reference kept apart:

* `jax.lax.top_k` is stable (ties go to the lower index); `torch.topk`
  does not promise that, so every ranking here is `topk_stable`, a stable
  descending sort.
* the reference computes `misses * expert_bytes` in int32, which wraps
  once the product passes 2**31 - 1 (11 fills of arctic-480b's 209 MB
  experts in one block); here the product is int64, so `fill_seconds`
  equals the reference wherever the int32 product fits and is the true
  value where it does not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = ["ExpertSlotConfig", "ExpertSlotState", "init_state", "BlockStats",
           "access_block", "slot_hit_routing", "resident_expert_ids",
           "topk_stable"]


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties to the lower index, as `jax.lax.top_k` gives them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@dataclass(frozen=True)
class ExpertSlotConfig:
    num_experts: int
    slots_per_device: int
    expert_bytes: int                      # "bitstream" size
    fill_bandwidth: float = 100e9          # bytes/s budgeted for slot fills
    hit_bias: float = 0.0                  # slot-hit routing logit bias
    hit_margin: float = float("inf")       # only reroute if within margin of
                                           # the argmax logit

    @property
    def fill_seconds(self) -> float:
        return self.expert_bytes / self.fill_bandwidth


class ExpertSlotState(NamedTuple):
    """Block-granular exact LRU over expert ids: per-expert recency, the
    resident set being the S most recently used experts."""

    last_use: torch.Tensor  # (E,) int32; 0 = never used
    resident: torch.Tensor  # (E,) bool
    clock: torch.Tensor     # () int32


def init_state(cfg: ExpertSlotConfig, device="cuda") -> ExpertSlotState:
    dev = resolve_device(device)
    return ExpertSlotState(
        last_use=torch.zeros((cfg.num_experts,), dtype=torch.int32,
                             device=dev),
        resident=torch.zeros((cfg.num_experts,), dtype=torch.bool,
                             device=dev),
        clock=torch.zeros((), dtype=torch.int32, device=dev))


class BlockStats(NamedTuple):
    accessed: torch.Tensor       # () int32 — distinct experts touched
    misses: torch.Tensor         # () int32 — slot fills triggered
    fill_seconds: torch.Tensor   # () f32  — modelled reconfiguration time
    hit_rate: torch.Tensor       # () f32


def access_block(state: ExpertSlotState, expert_ids: torch.Tensor,
                 cfg: ExpertSlotConfig,
                 valid: torch.Tensor | None = None
                 ) -> tuple[ExpertSlotState, BlockStats]:
    """Charge one token block's expert accesses against the slot pool.

    expert_ids: (T,) int32 routed ids (pad with any id + valid=False).  As
    JAX's scatter, a negative id counts from the end and an id out of
    range is dropped.
    """
    e = cfg.num_experts
    dev = state.last_use.device
    ids = torch.as_tensor(expert_ids, device=dev).reshape(-1).long()
    if valid is None:
        valid = torch.ones(ids.shape, dtype=torch.bool, device=dev)
    ids = torch.where(ids < 0, ids + e, ids)
    valid = valid.reshape(-1) & (ids >= 0) & (ids < e)
    hits = torch.zeros((e,), dtype=torch.int32, device=dev).index_add_(
        0, ids.clamp(0, e - 1), valid.to(torch.int32))
    accessed = hits > 0

    misses = torch.sum(accessed & ~state.resident, dtype=torch.int32)
    n_accessed = torch.sum(accessed, dtype=torch.int32)

    clock = state.clock + 1
    last_use = torch.where(accessed, clock, state.last_use)
    # resident set = S most-recently-used experts (exact block-LRU);
    # never-used experts (last_use == 0) are not resident.
    s = min(cfg.slots_per_device, e)
    thresh = topk_stable(last_use, s)[0][-1]
    resident = (last_use >= torch.clamp(thresh, min=1)) & (last_use > 0)
    # tie-break: cap residency at S by preferring lower ids among the
    # threshold cohort (deterministic, matches hardware priority encoders)
    over = torch.cumsum((last_use == thresh) & resident, 0,
                        dtype=torch.int32) + \
        torch.sum(resident & (last_use > thresh), dtype=torch.int32)
    resident = resident & torch.where(last_use == thresh, over <= s, True)

    fill = (misses.to(torch.int64) * cfg.expert_bytes).to(torch.float32) / \
        torch.tensor(cfg.fill_bandwidth, dtype=torch.float32)
    stats = BlockStats(
        accessed=n_accessed,
        misses=misses,
        fill_seconds=fill,
        hit_rate=torch.where(
            n_accessed > 0,
            1.0 - misses.float() / torch.clamp(n_accessed, min=1).float(),
            1.0).to(torch.float32),
    )
    return ExpertSlotState(last_use, resident, clock), stats


def slot_hit_routing(gate_logits: torch.Tensor, state: ExpertSlotState,
                     cfg: ExpertSlotConfig, k: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bias routing toward resident experts (beyond-paper optimisation).

    gate_logits: (T, E).  Returns (expert_ids (T,k), gates (T,k)).
    A resident expert's logit gets +hit_bias, but only experts whose
    *unbiased* logit is within `hit_margin` of the per-token max are
    eligible for the boost — bounding the routing-quality loss.
    """
    unbiased_max = gate_logits.amax(-1, keepdim=True)
    eligible = gate_logits >= (unbiased_max - cfg.hit_margin)
    boost = torch.where(eligible & state.resident[None, :], cfg.hit_bias,
                        0.0)
    biased = gate_logits + boost
    _, ids = topk_stable(biased, k)
    # gate values are re-normalised from the *unbiased* distribution so the
    # mixture weights stay faithful to the learned router
    orig = torch.gather(gate_logits, -1, ids)
    gates = torch.softmax(orig, dim=-1)
    return ids, gates


def resident_expert_ids(state: ExpertSlotState, slots: int) -> torch.Tensor:
    """(S,) ids of resident experts (padded with -1), for fill scheduling."""
    score = torch.where(state.resident, state.last_use, -1)
    top, ids = topk_stable(score, slots)
    return torch.where(top >= 0, ids, -1)
