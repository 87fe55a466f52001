"""Continuous batching for the serving engine.

The decode step function has a fixed batch width B; real request streams do
not.  The `ContinuousBatcher` keeps a fixed-width decode batch whose ROWS
are independently leased to requests: finished sequences release their row,
queued requests claim it (their prompt is prefilled into the row's cache
slice at claim time).  The decode step then always runs at full shape —
no recompilation, no head-of-line blocking on long generations.

The row lease also carries the request's *extension working set* (the
paper's process identity): the engine can aggregate the active rows' router
biases so the slot pool serves the union of resident tenants, making
continuous batching and the slot architecture compose.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (T,) token ids
    max_new_tokens: int
    router_bias: np.ndarray | None = None
    generated: list = field(default_factory=list)
    row: int | None = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclass
class RowState:
    request: Request | None = None
    position: int = 0                   # next absolute position in the row


class ContinuousBatcher:
    """Fixed-width rolling decode batch.

    The model-side callbacks are injected so the batcher is backend
    agnostic (tests drive it with a toy step):

        prefill_row(row, tokens) -> None   # write prompt KV into row
        decode(tokens (B,1), positions (B,)) -> next_token (B,)
    """

    def __init__(self, batch_size: int, max_len: int, *, prefill_row,
                 decode):
        self.rows = [RowState() for _ in range(batch_size)]
        self.max_len = max_len
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self._prefill_row = prefill_row
        self._decode = decode
        self.steps = 0
        self.occupancy_log: list[int] = []

    # -- admission ------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i, row in enumerate(self.rows):
            if row.request is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.row = i
            row.request = req
            row.position = len(req.prompt)
            self._prefill_row(i, req.prompt)

    # -- one decode step over the full fixed-width batch ----------------
    def step(self) -> int:
        """Runs one decode step; returns the number of active rows."""
        self._admit()
        active = [r for r in self.rows if r.request is not None]
        if not active:
            return 0
        b = len(self.rows)
        tokens = np.zeros((b, 1), np.int32)
        positions = np.zeros((b,), np.int32)
        for i, row in enumerate(self.rows):
            if row.request is None:
                continue
            last = (row.request.generated[-1] if row.request.generated
                    else row.request.prompt[-1])
            tokens[i, 0] = last
            positions[i] = row.position
        nxt = np.asarray(self._decode(tokens, positions))
        for i, row in enumerate(self.rows):
            req = row.request
            if req is None:
                continue
            req.generated.append(int(nxt[i]))
            row.position += 1
            if req.done or row.position >= self.max_len:
                self.finished.append(req)
                row.request = None      # row released for the queue
        self.steps += 1
        self.occupancy_log.append(len(active))
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> dict:
        while (self.queue or any(r.request for r in self.rows)) and \
                self.steps < max_steps:
            self.step()
        occ = np.asarray(self.occupancy_log, np.float64)
        return {
            "steps": self.steps,
            "finished": len(self.finished),
            "mean_occupancy": float(occ.mean()) if len(occ) else 0.0,
            "batch_size": len(self.rows),
        }

    # -- slot integration ------------------------------------------------
    def active_router_bias(self, num_experts: int) -> np.ndarray | None:
        """Union of the active rows' tenant working sets (max per expert)."""
        biases = [r.request.router_bias for r in self.rows
                  if r.request is not None
                  and r.request.router_bias is not None]
        if not biases:
            return None
        return np.max(np.stack(biases), axis=0)
