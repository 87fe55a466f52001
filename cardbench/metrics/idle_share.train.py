"""The share of a measured step in which no operation ran on the card:
the card's busy time a step, from the profiled steps after the window
(`devtrace`), against the measured window's host time a step (the
profiler slows the host's dispatch, so the profiled steps' own wall
would read idler than the measured ones)."""

UNIT, LAYER, MOVES = "%", "device", "train_tokens_per_s"


def read(ctx):
    p, rec = ctx.profile, ctx.rec
    if not p.get("busy_s") or not p.get("steps") or not rec.get("steps"):
        return None
    busy = p["busy_s"] / p["steps"]
    return 100.0 * (1.0 - busy / (rec["window_s"] / rec["steps"]))
