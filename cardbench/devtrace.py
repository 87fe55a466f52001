"""A profiled sub-window on the card: `torch.profiler` around a few steady
steps, its trace read back into device busy time, kernel times by name and
the longest idle gaps labelled by what the host was doing.

The trace of the sub-window goes to a temporary file (under TMPDIR) that
is read and deleted at once; no trace of the whole window is written.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

WINDOW = "cardbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def warm() -> None:
    """Start and stop the profiler once, so that the first real session
    pays no start-up of its own."""
    with torch.profiler.profile(activities=_activities()):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def session(out: dict):
    """Profile the block; on exit, `out` holds `summarize`'s reading."""
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    out.update(summarize(events.get("traceEvents", events)))


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list) -> dict:
    """{"window_s", "busy_s", "kernels": {name: [seconds, launches]},
    "device_ops": top 10 [name, seconds], "idle_gaps": top 10 [host
    activity, seconds]} of the trace's `WINDOW` range (times in the
    trace's microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and
           e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels = [], {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0.0, 0])
            k[0] += (b - a) * 1e-6
            k[1] += 1
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") in HOST_CATS and e["name"] != WINDOW]
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    labelled = []
    for a, b in longest:
        cover = [h for h in host if h[0] <= a < h[1]]
        name = max(cover)[2] if cover else "host: no traced activity"
        labelled.append([name, (b - a) * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels,
            "device_ops": [[n, v[0]] for n, v in top[:10]],
            "idle_gaps": labelled}

