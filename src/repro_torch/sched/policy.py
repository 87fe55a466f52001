"""Named scheduling policies over the fleet simulator's quantum/priority
axes.  PyTorch port of `repro.sched.policy` (numpy, on the port's
`SchedulerConfig`).

The simulator accepts raw `(quantum_cycles, priorities)` pairs
(`repro_torch.core.simulator.SchedulerConfig`); this module gives the common
policies names and sane constructors so experiments and the serve layer
talk about *policies*, not tuples:

  * `PriorityPolicy.uniform(q)`              — the paper's round-robin;
  * `PriorityPolicy.weighted(weights, q)`    — CPU share proportional to
    integer weights (weighted round-robin, §VI-C generalised);
  * `PriorityPolicy.foreground_background()` — one latency-sensitive
    foreground program with a high weight and a long quantum, batch
    programs behind it;
  * `quantum_grid(...)`                      — builds the `quanta=` axis
    for `sweep_fleet` (scalars broadcast, vectors pass through).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.simulator import (SchedulerConfig, priority_schedule,
                                  quanta_vector)

__all__ = ["PriorityPolicy", "quantum_grid"]


@dataclass(frozen=True)
class PriorityPolicy:
    """A named (quanta, priorities) scheduling policy for a P-program fleet.

    `quanta` is a scalar or a per-program tuple; `priorities` is None
    (unit weights) or a per-program tuple of positive ints.  Use
    `.scheduler()` to compile into the simulator's `SchedulerConfig`.
    """

    name: str
    quanta: int | tuple[int, ...] = 20_000
    priorities: tuple[int, ...] | None = None
    handler_cycles: int = 150

    def scheduler(self) -> SchedulerConfig:
        return SchedulerConfig(quantum_cycles=self.quanta,
                               handler_cycles=self.handler_cycles,
                               priorities=self.priorities)

    def schedule(self, num_programs: int) -> np.ndarray:
        """The weighted round-robin turn order this policy produces."""
        return priority_schedule(self.priorities, num_programs)

    def cpu_share(self, num_programs: int) -> np.ndarray:
        """Nominal long-run CPU-time share per program.

        Each program holds the core for `priorities[p]` consecutive quanta
        of `quanta[p]` cycles per rotation, so the share is
        `w[p] * q[p] / sum(w * q)` — the quantity the weighted scan
        converges to when every program has work.
        """
        q = quanta_vector(self.quanta, num_programs).astype(np.float64)
        w = (np.ones(num_programs) if self.priorities is None
             else np.asarray(self.priorities, np.float64))
        if w.shape != (num_programs,):
            raise ValueError(
                f"priorities vector has shape {w.shape}, expected "
                f"({num_programs},)")
        return (w * q) / float(np.sum(w * q))

    # ------------------------------------------------------------------
    @classmethod
    def uniform(cls, quantum_cycles: int = 20_000,
                handler_cycles: int = 150) -> "PriorityPolicy":
        """The paper's scheduler: one quantum, unit weights."""
        return cls("uniform", quantum_cycles, None, handler_cycles)

    @classmethod
    def weighted(cls, priorities, quantum_cycles: int = 20_000,
                 handler_cycles: int = 150) -> "PriorityPolicy":
        """Weighted round-robin: share proportional to integer weights."""
        return cls("weighted", quantum_cycles, tuple(int(w) for w in
                                                     priorities),
                   handler_cycles)

    @classmethod
    def foreground_background(cls, num_programs: int,
                              fg_weight: int = 4,
                              fg_quantum: int = 40_000,
                              bg_quantum: int = 10_000,
                              handler_cycles: int = 150
                              ) -> "PriorityPolicy":
        """Program 0 is foreground (heavy weight, long quantum); the rest
        are background batch programs on short quanta."""
        if num_programs < 2:
            raise ValueError("foreground/background needs >= 2 programs")
        quanta = (fg_quantum,) + (bg_quantum,) * (num_programs - 1)
        weights = (int(fg_weight),) + (1,) * (num_programs - 1)
        return cls("foreground_background", quanta, weights, handler_cycles)


def quantum_grid(*cells, num_programs: int | None = None) -> list:
    """Normalise a mixed list of quantum cells for `sweep_fleet(quanta=...)`.

    Each cell is a scalar (shared by all programs) or a per-program
    vector.  With `num_programs` given, every cell is validated/broadcast
    to a (P,) vector up front so shape errors surface here, not inside the
    sweep.
    """
    if not cells:
        raise ValueError("quantum_grid needs at least one quantum cell")
    if num_programs is None:
        return list(cells)
    return [quanta_vector(c, num_programs) for c in cells]
