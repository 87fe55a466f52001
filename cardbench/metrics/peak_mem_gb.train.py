"""The card's peak allocated memory over the window
(`torch.cuda.max_memory_allocated` after a reset before it), in GB."""

UNIT, LAYER, MOVES = "GB", "train step", "train_tokens_per_s"


def read(ctx):
    peak = ctx.rec.get("window_peak_bytes")
    return peak / 1e9 if peak else None
