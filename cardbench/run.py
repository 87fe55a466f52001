"""Run one cell of `BENCHMARK.json` on this machine's card and print one
JSON line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (spans around the calls into each layer, and a
profiled sub-window on the card).  Every run checks what its timed path
produced against the plain reference (`cardbench/check.py`) after the
window and prints each number compared beside its limit, as the last
lines of standard error and as the last key of the line.  It exits with
another code than 0 and prints no result when there is no card (or fewer
than the cell asks for), when the program under test (`repro_torch`,
under `src/`) is missing, or when `jax`, `jaxlib`, `flax` or the JAX
package `repro` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's build and kernel caches: fixed directories in the checkout
CACHE = os.path.join(HERE, ".cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ["USE_FLAX"] = "0"
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list:
    """The modules whose top-level name, compared whole, is one that no
    run may load."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card() -> dict:
    """The card's name and power limit, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, _, limit = out[0].partition(",") if out else ("", "", "")
    return {"name": name.strip(), "power_limit": limit.strip()}


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float | None = None, hooks=None) -> dict:
    """Run the cell and check it; returns the result line's object (without
    `device`'s card fields on the CPU, where tests drive it)."""
    import torch

    from cardbench import check, metrics_ctx

    driver = importlib.import_module(
        f"cardbench.drivers.{cell.traffic['kind']}")
    rec = driver.run(cell, seed, seconds, bool(trace), device,
                     T_START if t_start is None else t_start, hooks)
    if trace:
        ctx = metrics_ctx.Context(cell, rec)
        values = {m["name"]: (ctx.read(m["name"]), m["unit"])
                  for m in cell.per_layer}
    else:
        values = {k: (v, unit_of(cell, k))
                  for k, v in driver.end_to_end(rec).items()}
        values["setup_s"] = (rec["setup_s"], unit_of(cell, "setup_s"))
    shown = {k: {"value": v, "unit": u} for k, (v, u) in values.items()
             if v is not None}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else torch.device(device).type,
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": shown, "device": dev}
    prof = rec.get("profile") or {}
    if trace and "busy_s" in prof:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    numbers = driver.correctness(rec, cell, seed, device)
    ok, compared = check.judge(numbers, cell.limits)
    out["correct"] = ok and rec["failed"] == 0
    out["check"] = compared
    return out


def unit_of(cell, name: str) -> str:
    return {m["name"]: m["unit"] for m in cell.end_to_end}[name]


def main(argv=None) -> int:
    args = _args(argv)
    import torch
    from cardbench import spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cardbench: the cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"cardbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    out["card"] = _card()
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device", "breakdown", "card")
            if k in out}
    line["check"] = out["check"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
