"""Deterministic synthetic LM data: PyTorch port of `repro.data.pipeline`.

Tokens are a counter-hash stream (reproducible across restarts: resuming
at step k regenerates exactly the batch the failed run would have seen,
which the fault-tolerance tests assert).  `DataConfig`, `_hash_tokens` and
`global_batch_at` are the JAX package's numpy code, copied, and give its
tokens bit for bit.  One card holds the whole batch, so `make_batch`
takes a device where the JAX package takes a sharding, and `Prefetcher`
keeps `depth` batches on that device, copied from pinned host memory
without waiting for the copy.
"""
from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "global_batch_at", "make_batch", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _hash_tokens(cfg: DataConfig, step: int, rows: np.ndarray) -> np.ndarray:
    """Deterministic pseudo-token block for (step, global row ids)."""
    # splitmix64-style mixing — stable across platforms, no RNG state;
    # uint64 wraparound is the point, so silence the overflow warning
    with np.errstate(over="ignore"):
        x = (rows[:, None].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.arange(cfg.seq_len, dtype=np.uint64)[None, :]
             + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(cfg.seed) * np.uint64(0x94D049BB133111EB))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
    return (x % np.uint64(cfg.vocab)).astype(np.int32)


def global_batch_at(cfg: DataConfig, step: int) -> np.ndarray:
    """The full (global_batch, seq_len) token block for a step (tests)."""
    return _hash_tokens(cfg, step, np.arange(cfg.global_batch))


def make_batch(cfg: DataConfig, step: int, device="cuda") -> torch.Tensor:
    """The step's (global_batch, seq_len) int32 tokens on `device`; to a
    card they are copied from pinned memory on the current stream,
    without waiting for the copy."""
    dev = resolve_device(device)
    host = torch.from_numpy(global_batch_at(cfg, step))
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


class Prefetcher:
    """Keeps `depth` batches ready on the device, from `start_step` on."""

    def __init__(self, cfg: DataConfig, device="cuda", start_step: int = 0,
                 depth: int = 2):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.depth = depth
        self._queue: collections.deque = collections.deque()
        self._next = start_step
        self._lock = threading.Lock()
        self._fill()

    def _fill(self):
        while len(self._queue) < self.depth:
            self._queue.append(
                (self._next, make_batch(self.cfg, self._next, self.device)))
            self._next += 1

    def get(self) -> tuple[int, torch.Tensor]:
        with self._lock:
            step, batch = self._queue.popleft()
            self._fill()
            return step, batch
