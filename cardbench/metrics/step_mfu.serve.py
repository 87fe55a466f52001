"""The model FLOPs of the prompts prefilled and the tokens generated in
the window (`work.flops.prefill` and `decode_token`: 2 per active matmul
parameter a token touches and the attention products it needs) over the
window's time, as a share of the card's bf16 peak."""
from cardbench.drivers import serve

UNIT, LAYER, MOVES = "%", "model step", "output_tokens_per_s"


def read(ctx):
    work = serve.window_flops(ctx.rec, ctx.model)
    if not work:
        return None
    return 100.0 * work / ctx.rec["window_s"] / ctx.bf16_flops
