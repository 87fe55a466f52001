"""Fault-tolerant training runtime: PyTorch port of `repro.runtime.fault`
(pure Python, copied): checkpoint/restart, straggler mitigation,
bounded-restart supervision.

The supervision loop the launcher (`repro_torch.launch.train`) runs:

  * `Heartbeat`     — per-step liveness file + step-time log; an external
                      watchdog (or the supervisor below) detects hangs.
  * `StragglerMonitor` — sliding-window step-time tracking; steps slower
                      than `k x median` raise a straggler event (recorded
                      + optional callback).
  * `run_supervised` — bounded-restart loop around a trainer: on failure,
                      restore the latest checkpoint and continue; honours
                      deterministic data (`repro_torch.data`) so the
                      retrained steps see the same batches.

After a permanent loss of ranks the job shrinks instead of restarting
as it was: `runtime.elastic.shrink_mesh` builds the largest mesh the
survivors hold and `reshard_state` restores the latest checkpoint onto
it, and training goes on from there.
"""
from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable



@dataclass
class Heartbeat:
    path: str
    interval_steps: int = 1
    _last: float = field(default=0.0, repr=False)

    def beat(self, step: int, step_time: float) -> None:
        now = time.time()
        with open(self.path, "w") as f:
            json.dump({"step": step, "time": now,
                       "step_time_s": step_time}, f)
        self._last = now

    def age(self) -> float:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["time"]
        except (OSError, ValueError):
            return float("inf")


@dataclass
class StragglerMonitor:
    """Flags steps slower than `threshold` x rolling median."""

    window: int = 32
    threshold: float = 2.0
    on_straggler: Callable | None = None
    times: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def observe(self, step: int, step_time: float) -> bool:
        history = self.times[-self.window:]
        self.times.append(step_time)
        # keep only the sliding window: `history` never looks further
        # back, so trimming is behaviour-free — without it a long run
        # accretes one float per step forever
        if len(self.times) > self.window:
            del self.times[:len(self.times) - self.window]
        if len(history) < 8:
            return False
        med = statistics.median(history)
        if step_time > self.threshold * med:
            self.events.append({"step": step, "step_time": step_time,
                                "median": med})
            if self.on_straggler:
                self.on_straggler(step, step_time, med)
            return True
        return False


@dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0


class TrainingFailure(RuntimeError):
    pass


def run_supervised(*, init_fn, step_fn, save_fn, restore_fn, num_steps: int,
                   ckpt_every: int, policy: RestartPolicy | None = None,
                   heartbeat: Heartbeat | None = None,
                   straggler: StragglerMonitor | None = None,
                   fail_hook: Callable | None = None,
                   retryable: tuple = (TrainingFailure,)) -> dict:
    """Supervision loop.

    init_fn()                -> (state, start_step)   (restores if possible)
    step_fn(state, step)     -> (state, metrics)
    save_fn(state, step)     -> None
    restore_fn()             -> (state, start_step)
    fail_hook(step)          -> None | raises  (test fault injection)

    `retryable` is the exception tuple the restart policy absorbs —
    anything else propagates immediately.  Defaults to `TrainingFailure`;
    widen it (e.g. ``(TrainingFailure, OSError)``) when the step function
    can fail in recoverable infrastructure-specific ways.

    Returns a report {steps_run, restarts, straggler_events, final_step}.
    """
    retryable = tuple(retryable)
    if not retryable or not all(
            isinstance(e, type) and issubclass(e, BaseException)
            for e in retryable):
        raise TypeError(
            f"retryable must be a non-empty tuple of exception types, "
            f"got {retryable!r}")
    policy = policy or RestartPolicy()
    restarts = 0
    state, step = init_fn()
    steps_run = 0
    while step < num_steps:
        try:
            if fail_hook is not None:
                fail_hook(step)
            t0 = time.time()
            state, metrics = step_fn(state, step)
            dt = time.time() - t0
            steps_run += 1
            step += 1
            if heartbeat:
                heartbeat.beat(step, dt)
            if straggler:
                straggler.observe(step, dt)
            if step % ckpt_every == 0 or step == num_steps:
                save_fn(state, step)
        except retryable:
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            time.sleep(policy.backoff_s)
            state, step = restore_fn()
    return {
        "steps_run": steps_run,
        "restarts": restarts,
        "straggler_events": list(straggler.events) if straggler else [],
        "final_step": step,
    }
