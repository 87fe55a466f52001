"""The prefills' share of the card's bf16 peak: the model FLOPs of the
prompts prefilled in the window (`work.flops.prefill`) over the
synchronised host time of their prefill callbacks."""
from cardbench.work import flops

UNIT, LAYER, MOVES = "%", "model step, prefill", "ttft_p95_ms"


def read(ctx):
    spans = ctx.rec["loop"].spans["prefill"]
    if not spans:
        return None
    work = sum(flops.prefill(ctx.model, t) for t, _ in spans)
    return 100.0 * work / sum(s for _, s in spans) / ctx.bf16_flops
