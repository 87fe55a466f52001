"""Print the JAX package's digests for `chip_smoke.py`'s sched phases (not
a test module: pytest does not collect it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_sched_anchor.py

It runs the JAX package's sched benchmarks at their full sizes on the CPU
(`placement_study`, `placement_search`, `online_churn`, `chaos_serve`,
`fleet_scale_study` at its three full sizes, about four minutes, and
`perf_slot_decode`), and the JAX engine's sched half on `chip_smoke.py`'s
`ENGINE_*` scenario (a weighted admission plan, then a churn serve under a
seeded fault storm), and prints one JSON object: the sha1 of each result
in the form `chip_smoke.py` digests the port's (its `search_rows_held`,
`fleet_rows_held`, `fleet_reports_held`, `decision_held` and
`report_json`), to be pasted into its `EXPECTED_ROWS`.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from benchmarks import (chaos_serve, fleet_scale_study,  # noqa: E402
                        online_churn, perf_slot_decode, placement_search,
                        placement_study)
from repro.configs import base as cb  # noqa: E402
from repro.models import transformer  # noqa: E402
from repro.sched import (FaultPlan, OnlineConfig,  # noqa: E402
                         PlacementConfig, TenantEvent)
from repro.serve.engine import (EngineConfig, SlotServeEngine,  # noqa: E402
                                Tenant)


def engine_digests() -> dict:
    import jax
    cb.load_all()
    cfg = cb.get_config("arctic-480b").smoke()
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.zeros((1, 4), np.int32)
    eng = SlotServeEngine(cfg, params, EngineConfig(slots_per_shard=4),
                          [Tenant(n, tokens) for n in cs.ENGINE_BENCHES],
                          max_len=8)
    decision = eng.plan_coresidency(cs.ENGINE_BENCHES, **cs.ENGINE_PLAN)
    eng.apply_admission(decision, 0)
    rep = eng.serve_online(
        [TenantEvent(*e) for e in cs.ENGINE_EVENTS],
        online_cfg=OnlineConfig(
            placement=PlacementConfig(**cs.ENGINE_PLACEMENT),
            **cs.ENGINE_ONLINE),
        faults=FaultPlan.storm(**cs.ENGINE_STORM),
        num_epochs=cs.ENGINE_EPOCHS)
    print(f"# engine: admitted {decision.admitted}, deferred "
          f"{decision.deferred}; {rep.evacuations} evacuation(s), "
          f"{len(rep.fault_log)} fault-log entries", file=sys.stderr)
    return {"engine_plan": cs.sha([cs.decision_held(decision)]),
            "engine_online": cs.sha([cs.report_json(rep)])}


def main() -> None:
    out = {}
    for name, mod in (("placement_study", placement_study),
                      ("online_churn", online_churn),
                      ("chaos_serve", chaos_serve)):
        rows, _ = mod.run()
        out[name] = cs.sha(rows)
    rows, _ = placement_search.run()
    out["placement_search"] = cs.sha(cs.search_rows_held(rows))
    rows, res = fleet_scale_study.run()
    out["fleet_scale_rows"] = cs.sha(cs.fleet_rows_held(rows))
    out["fleet_scale_reports"] = cs.sha(cs.fleet_reports_held(res))
    rows = perf_slot_decode.run()
    out["perf_slot_decode_fleet"] = cs.sha(
        [r for r in rows if r.startswith("fleet")])
    out.update(engine_digests())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
