"""The least time of each kernel's work on the card: the larger of its
operations at the bf16 peak and its bytes at the HBM peak, each input read
once and each output written once (copied from the port's kernels' `cost`
at the time the benchmark was written, so that a change there cannot move
it)."""
from __future__ import annotations

from cardbench.work.peaks import BF16_FLOPS, HBM_BYTES


def least(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)


def flash_forward(b: int, t: int, h: int, kh: int, dh: int,
                  elem: int = 2) -> float:
    """Causal flash attention forward over t queries and t keys: 4 B H Dh
    FLOPs a visible pair; q, k, v read and o written once."""
    pairs = t * (t + 1) // 2
    return least(4.0 * b * h * dh * pairs,
                 float(elem * b * (2 * t * h + 2 * t * kh) * dh))


def moe_ffn(rows: int, live: int, d: int, f: int, mats: int = 3,
            elem: int = 2) -> float:
    """A grouped expert FFN over `rows` routed rows (not the capacity
    padding) with `live` experts that receive rows: 2 D F FLOPs a row a
    weight matrix; every live expert's weights read once, the rows read and
    written once."""
    return least(2.0 * mats * rows * d * f,
                 float(elem * (mats * live * d * f + 2 * rows * d)))
