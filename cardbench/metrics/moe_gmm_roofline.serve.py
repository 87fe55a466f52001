"""The grouped-FFN kernel's share of its roofline at the prefills of the
profiled sub-window: the least time of the expert FFN that their routed
rows need (`work.kernels.moe_ffn` a layer: the kept assignments, not the
capacity padding, and every expert that receives one), over the device
time of the `moe_gmm` kernels (the decode steps' `moe_gmm_skip` is not
counted)."""
from cardbench.work import kernels

UNIT, LAYER, MOVES = "%", "kernels", "ttft_p95_ms"
PATTERNS = ("moe_gmm_kernel_",)


def read(ctx):
    dev = ctx.kernel_seconds(PATTERNS)
    loads = ctx.profile.get("prefill_loads") or []
    if not dev or not loads:
        return None
    m = ctx.model
    least = 0.0
    for per_layer in loads:                # (layers, E) kept assignments
        for load in per_layer:
            least += kernels.moe_ffn(int(load.sum()), int((load > 0).sum()),
                                     m["d_model"], m["d_ff"])
    return 100.0 * least / dev
