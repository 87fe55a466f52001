"""Bitstream cache model (paper §IV, Fig. 1).

The paper adds a third L1 cache — the *bitstream cache* — beside the
instruction and data caches.  It is separate so its geometry can differ
("wider blocks to facilitate the increased data width to carry bitstreams").
The paper's evaluation folds its latency into the abstract miss-latency
constant; this module keeps an explicit sizing model so that

  * the simulator's two-level cost (disambiguator miss -> bitstream-cache
    hit/miss) has physically grounded defaults, and
  * the TPU adaptation (`repro.core.expert_slots`) can derive slot-fill
    times from *bytes moved / bandwidth* instead of abstract cycles.

Sizing grounding: a small reconfigurable region able to host one RISC-V
instruction group (a pipelined FP adder, say ~500-2000 LUTs) needs a partial
bitstream of roughly 30-200 KB on today's 7-series-class fabrics; a
wide-block cache line of 64-256 B then needs hundreds of beats per fill,
which is exactly why the paper calls for faster, smaller-region
reconfiguration technologies.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BitstreamCacheConfig:
    """Geometry + timing of the L1 bitstream cache."""

    entries: int = 16              # bitstreams resident (fully associative)
    bitstream_bytes: int = 64 * 1024   # per instruction-group bitstream
    block_bytes: int = 256         # wide cache block (vs 64B I/D lines)
    fill_cycles_per_block: int = 2  # from unified L2
    config_port_bytes_per_cycle: int = 1024  # fabric configuration port bw

    @property
    def reconfig_cycles(self) -> int:
        """Cycles to push a resident bitstream into a slot (the paper's
        'fast reconfiguration technology' knob).  64KB @ 1KB/cycle = 64."""
        return max(1, self.bitstream_bytes // self.config_port_bytes_per_cycle)

    @property
    def fill_cycles(self) -> int:
        """Cycles to bring a bitstream into the cache from L2 on a miss."""
        blocks = -(-self.bitstream_bytes // self.block_bytes)
        return blocks * self.fill_cycles_per_block

    def miss_latency(self, bs_hit: bool) -> int:
        """End-to-end disambiguator-miss cost."""
        return self.reconfig_cycles + (0 if bs_hit else self.fill_cycles)


# Presets spanning the paper's 10/50/250-cycle study range:
FUTURE_FAST = BitstreamCacheConfig(
    bitstream_bytes=8 * 1024, config_port_bytes_per_cycle=1024)   # ~8 cycles
NEAR_TERM = BitstreamCacheConfig(
    bitstream_bytes=48 * 1024, config_port_bytes_per_cycle=1024)  # ~47 cycles
PARTIAL_RECONFIG = BitstreamCacheConfig(
    bitstream_bytes=256 * 1024, config_port_bytes_per_cycle=1024)  # ~256 cycles
