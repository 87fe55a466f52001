"""The train step's model FLOPs (`work.flops.train_step`: 6 per matmul
parameter a token touches, the head included, and 3 x the causal
attention products; no remat recompute) over the window's time, as a share
of the card's bf16 peak."""
from cardbench.work import flops

UNIT, LAYER, MOVES = "%", "train step", "train_tokens_per_s"


def read(ctx):
    rec = ctx.rec
    if not rec.get("steps"):
        return None
    work = rec["steps"] * flops.train_step(ctx.model, ctx.mix["batch"],
                                           ctx.mix["seq"])
    return 100.0 * work / rec["window_s"] / ctx.bf16_flops
