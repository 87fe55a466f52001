"""What a per-layer metric's reader reads: one run's record.

A reader is `cardbench/metrics/<metric name>.py`, holding `UNIT`,
`LAYER`, `MOVES` (as its `BENCHMARK.json` entry gives them) and
`read(ctx) -> float | None`; None where the run holds nothing for it to
read, and the metric is then left out of the line.
"""
from __future__ import annotations

from cardbench import spec, stats
from cardbench.work import peaks


class Context:
    def __init__(self, cell, rec):
        self.cell = cell
        self.rec = rec
        self.model = cell.model
        self.mix = cell.traffic
        self.profile = rec.get("profile") or {}
        self.bf16_flops = peaks.BF16_FLOPS

    def read(self, name: str):
        return spec.metric(name).read(self)

    def kernel_seconds(self, patterns) -> float | None:
        """Device seconds of the profiled kernels whose names hold any of
        `patterns`; None where none ran."""
        s = sum(sec for k, (sec, _) in self.profile.get("kernels", {}).items()
                if any(p in k for p in patterns))
        return s or None

    @staticmethod
    def median(values):
        return stats.median(values)
