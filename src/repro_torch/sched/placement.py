"""Contention-aware tenant -> core placement.  PyTorch port of
`repro.sched.placement`: the search, the scores and the cache are the
reference's numpy and Python; only the sweeps run through the port's
simulator, on the model's `device`.

T tenants (each characterised by an instruction-mix profile, i.e. a
benchmark name from `repro_torch.core.traces`) must share C reconfigurable
cores.  Which tenants co-reside decides how hard they fight over
disambiguator slots (paper §VI-C): two F+M-class tenants thrash a 4-slot
core, while an F+M-class tenant next to an M-only tenant barely notices
it.  This module treats that choice as an optimisation problem:

  * `ContentionModel` — batch-predicts per-tenant contention slowdowns
    (fleet CPI / unpreempted solo CPI) for candidate co-residency groups by
    running them through `repro_torch.core.simulator.sweep_fleet` — the
    same machinery behind the Fig. 7 numbers and
    `repro_torch.serve.engine.estimate_fleet_contention`.  Candidate groups are
    canonicalised (sorted bench multiset), cached, batched per fleet size,
    and padded to power-of-two batches so the jitted sweep compiles a
    handful of shapes, not one per call.
  * `place_tenants` — greedy seeding (most contentious tenants first, each
    onto the core that minimises the resulting group's predicted worst
    slowdown) followed by swap-based local search, minimising predicted
    worst-tenant slowdown with mean slowdown as the tie-break.
  * `fifo_placement` / `random_placement` — the baselines the benchmark
    (`repro_torch.bench.placement_study`) compares against.

Solo references are unpreempted + warm-cache, so the sweep dispatcher
serves them from stack-distance passes; candidate fleets are preempted
and — since they are one-shot, warm-bitstream runs — ride the
interleave-aware fast path (`repro_torch.core.stackdist_interleaved`,
the window kernel on the card), which is
what makes the greedy + swap search's many batched sweeps cheap.  The
`path` knob forces an engine for parity studies; every engine returns
bit-for-bit identical predictions.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import isa, simulator
from repro_torch.device import resolve_device
from repro_torch.sched.topology import Topology

__all__ = [
    "PlacementConfig", "ContentionModel", "Placement",
    "place_tenants", "place_fleet", "score_placement", "fifo_placement",
    "random_placement",
]


@dataclass(frozen=True)
class PlacementConfig:
    """Simulator knobs behind the contention predictions."""

    num_slots: int = 4
    miss_latency: int = 50
    # short quantum: frequent switching is the regime where co-residency
    # actually hurts (paper §VI-C, the 1K-vs-20K comparison) and hence where
    # placement has something to optimise.  Candidate groups span sizes
    # 1..P, so the model assumes the uniform unit-priority policy —
    # per-program priorities have no well-defined meaning across candidate
    # sizes (priority-aware admission is a ROADMAP direction).
    quantum_cycles: int = 2_000
    handler_cycles: int = 150
    trace_len: int = 12_000
    steps_per_program: int = 12_000   # total_steps = P * steps_per_program

    def scheduler(self) -> simulator.SchedulerConfig:
        return simulator.SchedulerConfig(
            quantum_cycles=self.quantum_cycles,
            handler_cycles=self.handler_cycles)


def _pad_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class ContentionModel:
    """Batched, cached slowdown predictions for co-residency groups.

    A *group* is a multiset of benchmark names sharing one core; its
    prediction is the per-member contention slowdown vector (fleet CPI over
    unpreempted solo CPI), ordered like the sorted group tuple.  Everything
    is cached: traces per benchmark, solo CPIs (one batched unpreempted
    sweep per set of new benchmarks — stack-distance fast path), and group
    predictions (one batched preempted sweep per fleet size, padded to
    power-of-two batch shapes so repeated greedy/swap rounds reuse
    compilations).

    `scenarios` maps benchmark name -> `SlotScenario` for tenants whose
    binaries slot different opcodes (per-tenant slot taxonomies); benches
    absent from the mapping use the shared `scenario` default.  Tenant
    names are Embench bench names or model-zoo "<arch>:<phase>"
    workloads, resolved by `repro_torch.workloads.resolve_trace` as the
    reference resolves them; any other name raises a ValueError naming
    both sets.

    `path` is handed to every underlying `sweep_fleet` call: the default
    "auto" serves solo references from the unpreempted stack-distance
    engine and preempted candidate groups from the interleaved engine;
    forcing "scan" reproduces the same predictions bit-for-bit on the
    reference machine (tests pin this).  Every sweep runs on `device`
    (default "cuda"); predictions are numpy, read back at the points
    where the reference calls `np.asarray(res.…)`.
    """

    def __init__(self, cfg: PlacementConfig | None = None,
                 scenario: isa.SlotScenario | None = None,
                 trace_seed: int = 0,
                 scenarios: dict[str, isa.SlotScenario] | None = None,
                 path: str = "auto", device="cuda"):
        self.cfg = cfg or PlacementConfig()
        self.device = resolve_device(device)
        self.scenario = scenario or isa.SCENARIO_2
        # per-tenant slot taxonomies: bench name -> SlotScenario overrides
        # the shared default (tenants compiled against different extension
        # sets disagree about which opcodes are slotted, paper §IV)
        self.scenarios = dict(scenarios or {})
        self.path = path
        self.trace_seed = trace_seed
        self._traces: dict[str, np.ndarray] = {}
        self._solo_cpi: dict[str, float] = {}
        self._solo_miss_rate: dict[str, float] = {}
        self._groups: dict[tuple[str, ...], np.ndarray] = {}
        self.sim_calls = 0          # batched sweep_fleet invocations
        self.groups_simulated = 0   # non-padding groups actually simulated

    # ------------------------------------------------------------------
    def trace(self, bench: str) -> np.ndarray:
        if bench not in self._traces:
            # repro_torch.workloads.resolve_trace accepts Embench benches
            # (bit for bit the core traces stream) and model-zoo
            # "<arch>:<phase>" workloads, and raises a ValueError naming
            # both valid sets otherwise; imported lazily so pure-Embench
            # placement never touches the model/configs stack
            from repro_torch import workloads

            self._traces[bench] = workloads.resolve_trace(
                bench, self.cfg.trace_len, seed=self.trace_seed)
        return self._traces[bench]

    def scenario_of(self, bench: str) -> isa.SlotScenario:
        """The slot taxonomy this bench simulates under (per-tenant
        mapping first, shared default otherwise)."""
        return self.scenarios.get(bench, self.scenario)

    def _ensure_solo(self, benches) -> None:
        missing = sorted(set(benches) - self._solo_cpi.keys())
        if not missing:
            return
        # one batched unpreempted sweep per distinct taxonomy (the common
        # shared-scenario roster stays a single sweep)
        by_scen: dict[str, list[str]] = {}
        for b in missing:
            by_scen.setdefault(self.scenario_of(b).name, []).append(b)
        for _, group in sorted(by_scen.items()):
            tensor = np.stack([self.trace(b) for b in group])[:, None, :]
            # the solo window matches each fleet member's step budget so
            # cold misses amortise identically on both sides of the
            # slowdown ratio
            res = simulator.sweep_fleet(
                tensor, [self.cfg.miss_latency], self.scenario_of(group[0]),
                simulator.SchedulerConfig.no_preempt(
                    self.cfg.handler_cycles),
                slot_counts=[self.cfg.num_slots],
                total_steps=self.cfg.steps_per_program, path=self.path,
                device=self.device)
            self.sim_calls += 1
            cpi = simulator._np(res.cpi)[:, 0, 0, 0]
            miss = simulator._np(res.slot_misses)[:, 0, 0, 0]
            instr = simulator._np(res.instructions)[:, 0, 0, 0]
            for i, b in enumerate(group):
                self._solo_cpi[b] = float(cpi[i])
                self._solo_miss_rate[b] = (float(miss[i])
                                           / max(int(instr[i]), 1))

    def warm(self, benches) -> None:
        """Precompute solo references for a bench set in ONE batched sweep
        (callers with a known tenant roster should warm before querying
        per-bench metrics one at a time)."""
        self._ensure_solo(benches)

    def solo_cpi(self, bench: str) -> float:
        self._ensure_solo([bench])
        return self._solo_cpi[bench]

    def solo_miss_rate(self, bench: str) -> float:
        """Solo slot misses per instruction — the greedy seeding order."""
        self._ensure_solo([bench])
        return self._solo_miss_rate[bench]

    # ------------------------------------------------------------------
    def _cache_key(self, group, num_slots: int) -> tuple:
        """Canonical prediction-cache key: (sorted bench multiset, slot
        width).  Every lookup AND store routes through this one function,
        so there is one keying convention: a permuted group priced at a
        degraded width hits the same entry as its sorted twin, and a
        degraded prediction never aliases (or is served from) the
        full-width one."""
        return (tuple(sorted(group)), int(num_slots))

    def predict(self, groups, *, num_slots: int | None = None
                ) -> list[np.ndarray]:
        """Per-tenant slowdown vectors for a sequence of bench groups.

        Each group is a sequence of benchmark names (any order; the result
        vector is ordered like `tuple(sorted(group))`).  All uncached
        groups sharing a (size, per-program taxonomy) signature are
        simulated in a single `sweep_fleet` call — with no per-tenant
        scenario mapping that is exactly "one call per size".  Batches
        pad to power-of-two sizes rounded up to a multiple of the device
        count (`simulator.fleet_mesh_size`), so on multi-device hosts
        every candidate-group sweep shards evenly across the fleet mesh
        (a no-op on single-device hosts: the historical shapes are
        already multiples of 1).

        `num_slots` prices the group on a core with fewer usable slots
        (a fault-degraded core, `repro_torch.sched.faults`): the candidate
        sweep runs at that slot count while the solo reference stays at
        full width, so a degraded core's predictions are intrinsically
        down-weighted — the extra thrashing of the smaller disambiguator
        shows up as extra slowdown.  Predictions are cached under the
        canonical `_cache_key` (group multiset, width) for every width,
        the default full width included.
        """
        ns = self.cfg.num_slots if num_slots is None else int(num_slots)
        if not 1 <= ns <= self.cfg.num_slots:
            raise ValueError(
                f"num_slots must be in [1, {self.cfg.num_slots}] (the "
                f"configured core width), got {num_slots}")
        keys = [self._cache_key(g, ns) for g in groups]
        todo: dict[tuple, list[tuple[str, ...]]] = {}
        for k, _ in dict.fromkeys(keys):   # unique, order-preserving
            if k and self._cache_key(k, ns) not in self._groups:
                sig = tuple(self.scenario_of(b).name for b in k)
                todo.setdefault((len(k), sig), []).append(k)
        ndev = simulator.fleet_mesh_size()
        for (size, _sig), ks in sorted(todo.items()):
            self._ensure_solo([b for k in ks for b in k])
            pad = -(-_pad_pow2(len(ks)) // ndev) * ndev
            batch = ks + [ks[0]] * (pad - len(ks))
            tensor = np.stack([np.stack([self.trace(b) for b in k])
                               for k in batch])
            res = simulator.sweep_fleet(
                tensor, [self.cfg.miss_latency],
                [self.scenario_of(b) for b in ks[0]],
                self.cfg.scheduler(),
                slot_counts=[ns],
                total_steps=size * self.cfg.steps_per_program,
                path=self.path, device=self.device)
            self.sim_calls += 1
            self.groups_simulated += len(ks)
            cpis = simulator._np(res.cpi)[:, 0, 0, :]
            instrs = simulator._np(res.instructions)[:, 0, 0, :]
            for gi, k in enumerate(ks):
                solo = np.array([self._solo_cpi[b] for b in k])
                slow = cpis[gi] / solo
                # a tenant the rotation never reached has no CPI: treat as
                # unboundedly contended, never as "free"
                self._groups[self._cache_key(k, ns)] = np.where(
                    instrs[gi] > 0, slow, np.inf)
        return [self._groups[key] if key[0] else np.zeros((0,))
                for key in keys]


# ---------------------------------------------------------------------------
# placements and their scores
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Placement:
    """An assignment of named tenants to cores, with predicted slowdowns."""

    cores: tuple[tuple[str, ...], ...]      # tenant names per core
    tenant_slowdown: dict[str, float] = field(compare=False)
    worst_slowdown: float
    mean_slowdown: float

    @property
    def objective(self) -> tuple[float, float]:
        """Lexicographic score: worst-tenant first, mean as tie-break."""
        return (self.worst_slowdown, self.mean_slowdown)


def _core_groups(cores, tenants):
    return [tuple(sorted(tenants[n] for n in core)) for core in cores]


def _tenant_slowdowns(cores, tenants, preds) -> dict[str, float]:
    out: dict[str, float] = {}
    for core, pred in zip(cores, preds):
        # prediction vectors are ordered like the sorted bench tuple; match
        # tenants to entries by sorting them the same way (ties share a
        # bench, hence a value, so the pairing is well-defined)
        for name, slow in zip(sorted(core, key=lambda n: (tenants[n], n)),
                              pred):
            out[name] = float(slow)
    return out


def score_placement(cores, tenants: dict[str, str],
                    model: ContentionModel) -> Placement:
    """Predict per-tenant slowdowns for an explicit core assignment."""
    cores = tuple(tuple(c) for c in cores if c)
    preds = model.predict(_core_groups(cores, tenants))
    per_tenant = _tenant_slowdowns(cores, tenants, preds)
    vals = np.array(list(per_tenant.values()))
    return Placement(cores=cores, tenant_slowdown=per_tenant,
                     worst_slowdown=float(vals.max()),
                     mean_slowdown=float(vals.mean()))


def _capacities(num_tenants: int, num_cores: int) -> list[int]:
    base, extra = divmod(num_tenants, num_cores)
    return [base + 1] * extra + [base] * (num_cores - extra)


def fifo_placement(names, num_cores: int) -> list[list[str]]:
    """Chunk tenants into cores in arrival order — the naive serve layer."""
    names = list(names)
    caps = _capacities(len(names), num_cores)
    cores, i = [], 0
    for c in caps:
        cores.append(names[i:i + c])
        i += c
    return cores

def random_placement(names, num_cores: int, seed: int = 0) -> list[list[str]]:
    rng = np.random.default_rng(seed)
    names = list(names)
    order = [names[i] for i in rng.permutation(len(names))]
    return fifo_placement(order, num_cores)


# ---------------------------------------------------------------------------
# greedy seeding + swap local search
# ---------------------------------------------------------------------------


def place_tenants(tenants: dict[str, str], num_cores: int,
                  model: ContentionModel | None = None, *,
                  max_rounds: int = 8, device="cuda") -> Placement:
    """Assign tenants to cores minimising predicted worst-tenant slowdown.

    `tenants` maps tenant name -> benchmark profile.  Core sizes are kept
    balanced (|size difference| <= 1, matching the FIFO/random baselines).
    Greedy seeding walks tenants in order of decreasing solo slot-miss rate
    (the most slot-hungry tenants get first pick) and puts each on the core
    whose resulting group predicts the best (worst, mean) objective; then
    swap-based local search exchanges tenant pairs across cores while any
    swap improves the global objective (up to `max_rounds` passes).  All
    candidate groups of a round are predicted in batched `sweep_fleet`
    calls through the `ContentionModel` cache (a new one on `device`
    when `model` is None).
    """
    if not tenants:
        raise ValueError("place_tenants needs at least one tenant")
    if num_cores < 1:
        raise ValueError(f"num_cores must be >= 1, got {num_cores}")
    model = model or ContentionModel(device=device)
    names = sorted(tenants)
    caps = _capacities(len(names), num_cores)

    # --- greedy seeding, most contentious first ---
    model.warm(tenants.values())   # one batched solo sweep, not T singletons
    order = sorted(names, key=lambda n: (-model.solo_miss_rate(tenants[n]),
                                         n))
    cores: list[list[str]] = [[] for _ in range(num_cores)]
    for n in order:
        open_cores = [ci for ci in range(num_cores)
                      if len(cores[ci]) < caps[ci]]
        cand = [tuple(sorted([tenants[m] for m in cores[ci]]
                             + [tenants[n]])) for ci in open_cores]
        preds = model.predict(cand)
        best = min(range(len(open_cores)),
                   key=lambda i: (float(np.max(preds[i])),
                                  float(np.mean(preds[i])), i))
        cores[open_cores[best]].append(n)

    # --- swap local search on the global objective ---
    current = score_placement(cores, tenants, model)
    for _ in range(max_rounds):
        moves = [(a, i, b, j)
                 for a in range(num_cores) for b in range(a + 1, num_cores)
                 for i in range(len(cores[a])) for j in range(len(cores[b]))]
        # batch-predict every post-swap group pair up front (cache absorbs
        # the duplicates across moves)
        cand_groups = []
        for a, i, b, j in moves:
            na = cores[a][:i] + cores[a][i + 1:] + [cores[b][j]]
            nb = cores[b][:j] + cores[b][j + 1:] + [cores[a][i]]
            cand_groups += [tuple(sorted(tenants[n] for n in na)),
                            tuple(sorted(tenants[n] for n in nb))]
        model.predict(cand_groups)

        best_move, best_pl = None, current
        for a, i, b, j in moves:
            trial = [list(c) for c in cores]
            trial[a][i], trial[b][j] = trial[b][j], trial[a][i]
            pl = score_placement(trial, tenants, model)
            if pl.objective < best_pl.objective:
                best_move, best_pl = (a, i, b, j), pl
        if best_move is None:
            break
        a, i, b, j = best_move
        cores[a][i], cores[b][j] = cores[b][j], cores[a][i]
        current = best_pl
    return current


def place_fleet(tenants: dict[str, str], topology: Topology,
                model: ContentionModel | None = None, *,
                max_rounds: int = 8, device="cuda") -> Placement:
    """Topology-aware static placement over a whole fleet.

    Partitions tenants across hosts, then runs the greedy + swap
    `place_tenants` search independently inside each host (the placement
    *domain* — swap moves may cross sockets within a host, never hosts),
    so the cost is sum-over-hosts of O(T_h^2) instead of the flat pool's
    O(T^2) swap frontier.  Tenants are dealt across hosts round-robin in
    decreasing solo slot-miss-rate order, so the slot-hungriest tenants
    spread out instead of piling onto host 0.  With `Topology.flat(C)`
    (one host) this is exactly `place_tenants(tenants, C)`.

    The returned `Placement.cores` tuple is ordered by global core index
    (host-major), empty trailing cores of a host omitted — matching how
    `score_placement` drops empty cores.
    """
    if not tenants:
        raise ValueError("place_fleet needs at least one tenant")
    model = model or ContentionModel(device=device)
    model.warm(tenants.values())   # one batched solo sweep up front
    order = sorted(tenants, key=lambda n: (-model.solo_miss_rate(tenants[n]),
                                           n))
    per_host: list[dict[str, str]] = [{} for _ in range(topology.num_hosts)]
    for i, n in enumerate(order):
        per_host[i % topology.num_hosts][n] = tenants[n]
    cores: list[tuple[str, ...]] = []
    per_tenant: dict[str, float] = {}
    for roster in per_host:
        if not roster:
            continue
        pl = place_tenants(roster,
                           min(topology.cores_per_host, len(roster)),
                           model, max_rounds=max_rounds)
        cores.extend(pl.cores)
        per_tenant.update(pl.tenant_slowdown)
    vals = np.array(list(per_tenant.values()))
    return Placement(cores=tuple(cores), tenant_slowdown=per_tenant,
                     worst_slowdown=float(vals.max()),
                     mean_slowdown=float(vals.mean()))
