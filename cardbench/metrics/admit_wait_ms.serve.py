"""The median time from a request's sending to the start of its prefill
(the benchmark's wrapper around the batcher's prefill callback), over the
requests sent in the window."""

UNIT, LAYER, MOVES = "ms", "batcher", "ttft_p95_ms"


def read(ctx):
    return ctx.median(1e3 * (r.admitted - r.sent) for r in ctx.rec["sent"]
                      if r.admitted is not None)
