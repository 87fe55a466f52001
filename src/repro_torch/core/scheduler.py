"""Multi-program experiment construction (paper §VI-C, generalised to fleets).

The paper pairs benchmarks under FreeRTOS's round-robin scheduler:

  * C(5,2) = 10 pairs among the five "improved by F and M" benchmarks, and
  * 5 x 8 = 40 pairs of one FM-class with one M-only-class benchmark,

for 50 combinations total; pairs that do not compete for slots (M-only with
M-only, or anything with an insensitive benchmark) are omitted, because every
granularity scenario fits the whole "M" extension.

`make_fleets(k)` extends the same construction to k-way mixes: C(5,k)
all-FM fleets plus C(5,k-1) x 8 fleets with one M-only member — slot
competition is guaranteed because every fleet carries at least k-1 FM
working sets.  `make_pairs()` is exactly `make_fleets(2)`.

`SchedulerConfig` itself lives in `repro_torch.core.simulator`; this module
builds the fleet sets and the (B, P, N) trace arrays for
`repro_torch.core.simulator.sweep_fleet` / `simulate_pair_batch`.  PyTorch
port of `repro.core.scheduler` (numpy only, so a copy): the fleets and
trace arrays are equal to the reference's.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core import traces
from repro_torch.core.simulator import SchedulerConfig  # noqa: F401  (re-export)


def make_fleets(k: int, fm: list[str] | None = None,
                m: list[str] | None = None) -> list[tuple[str, ...]]:
    """All slot-competing k-way benchmark fleets (k >= 2).

    C(|FM|, k) all-FM fleets, then C(|FM|, k-1) x |M| fleets of FM-class
    programs joined by one M-only program — |fleets| = C(|FM|, k) +
    C(|FM|, k-1) * |M|, and every fleet carries at least k-1 FM working
    sets, which is what guarantees slot competition.  For k=2 with the
    default pools this is the paper's 50 combinations in their original
    order.  `fm`/`m` override the benchmark pools (property tests and
    custom tenant studies); programs never repeat within a fleet.
    """
    if k < 2:
        raise ValueError(f"fleets need at least 2 programs, got k={k}")
    fm = traces.FM_BENCHES if fm is None else list(fm)
    m = traces.M_BENCHES if m is None else list(m)
    if k - 1 > len(fm):
        raise ValueError(
            f"k={k} fleets need at least k-1={k - 1} FM-class benchmarks, "
            f"pool has {len(fm)}")
    fleets = list(itertools.combinations(fm, k))
    fleets += [c + (b,) for c in itertools.combinations(fm, k - 1)
               for b in m]
    return fleets


def make_pairs() -> list[tuple[str, str]]:
    """The paper's 50 benchmark combinations (§VI-C) — the P=2 fleet set."""
    pairs = make_fleets(2)
    assert len(pairs) == 50
    return pairs


def fm_fm_pairs() -> list[tuple[str, str]]:
    return list(itertools.combinations(traces.FM_BENCHES, 2))


def fm_m_pairs() -> list[tuple[str, str]]:
    return [(a, b) for a in traces.FM_BENCHES for b in traces.M_BENCHES]


def fleet_traces(fleets: list[tuple[str, ...]], length: int = 150_000,
                 seed: int = 0) -> np.ndarray:
    """(B, P, N) int32 trace tensor for `sweep_fleet`.

    Every fleet must have the same size P.  Traces are cached per benchmark
    (they are deterministic per seed).
    """
    sizes = {len(f) for f in fleets}
    if len(sizes) != 1:
        raise ValueError(f"mixed fleet sizes {sorted(sizes)}")
    cache: dict[str, np.ndarray] = {}

    def get(name: str) -> np.ndarray:
        if name not in cache:
            cache[name] = traces.build_trace(name, length, seed)
        return cache[name]

    return np.stack([np.stack([get(n) for n in fleet]) for fleet in fleets])


def pair_traces(pairs: list[tuple[str, str]], length: int = 150_000,
                seed: int = 0) -> np.ndarray:
    """(B, 2, N) trace tensor — the P=2 special case of `fleet_traces`."""
    return fleet_traces(pairs, length, seed)
