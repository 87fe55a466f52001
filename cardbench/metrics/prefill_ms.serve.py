"""The median synchronised host time of a prefill callback in the window
(the prompt alone through `transformer.prefill`, its cache copied into
the row)."""

UNIT, LAYER, MOVES = "ms", "model step, prefill", "ttft_p95_ms"


def read(ctx):
    return ctx.median(1e3 * s for _, s in ctx.rec["loop"].spans["prefill"])
