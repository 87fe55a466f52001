"""The median host time of a decode callback in the window (one
`transformer.decode_step` over the whole batch; its tokens copied to the
host, which synchronises)."""

UNIT, LAYER, MOVES = "ms", "model step, decode", "itl_p95_ms"


def read(ctx):
    return ctx.median(1e3 * s for s in ctx.rec["loop"].spans["decode"])
