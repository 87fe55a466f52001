"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix.  Its
files:

- the configuration: the `file` of its `configs` entry (a JSON object whose
  `model` holds the port's `ModelConfig` fields as run, and whose
  `reference` names its plain reference, `cardbench/reference/<name>.py`);
- the traffic mix: `cardbench/traffic/<traffic>.json`;
- each per-layer metric: `cardbench/metrics/<metric name>.py` (see
  `metrics_ctx`);
- the limits of its correctness check: `cardbench/limits/<cell>.json`;
- its driver: `cardbench/drivers/<the mix's "kind">.py`.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict         # the configuration file's contents
    traffic: dict        # the mix file's contents
    end_to_end: list     # the metric entries that apply to this cell
    per_layer: list
    limits: dict

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def reference(self):
        """The plain reference that the configuration names (its
        `"reference"`): `cardbench/reference/<name>.py`, which also draws
        the weights both sides take."""
        return importlib.import_module(
            "cardbench.reference." + self.config["reference"])


def cell(name: str) -> Cell:
    bench = load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(ROOT, conf["file"])),
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=_json(os.path.join(HERE, "limits", name + ".json")))


def metric(name: str):
    """The module `cardbench/metrics/<name>.py` (a per-layer metric's
    reader), loaded once."""
    if name not in _METRICS:
        path = os.path.join(HERE, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "cardbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _METRICS[name] = mod
    return _METRICS[name]


_METRICS: dict = {}
