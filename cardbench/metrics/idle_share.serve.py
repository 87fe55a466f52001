"""The share of the measured window in which no operation ran on the card:
the card's busy time a generated token, from the profiled seconds after
the window (`devtrace`), against the measured window's host time a
generated token (the profiler slows the host's dispatch, so the profiled
seconds' own wall would read idler than the measured ones)."""
from cardbench.drivers import serve

UNIT, LAYER, MOVES = "%", "device", "output_tokens_per_s"


def read(ctx):
    p = ctx.profile
    tokens = serve.window_tokens(ctx.rec)
    if not p.get("busy_s") or not p.get("tokens") or not tokens:
        return None
    busy = p["busy_s"] / p["tokens"]
    return 100.0 * (1.0 - busy / (ctx.rec["window_s"] / tokens))
