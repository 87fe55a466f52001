"""The flash kernel's share of its roofline in the profiled train steps:
the least time of the causal attention forward that the steps need (one a
layer a step: `work.kernels.flash_forward`) over the device time of the
kernels that run it (remat's recompute launches it a second time, and
that time counts)."""
from cardbench.work import kernels

UNIT, LAYER, MOVES = "%", "kernels", "train_tokens_per_s"
PATTERNS = ("flash_kernel_",)


def read(ctx):
    dev = ctx.kernel_seconds(PATTERNS)
    steps = ctx.profile.get("steps")
    if not dev or not steps:
        return None
    m = ctx.model
    least = steps * m["num_layers"] * kernels.flash_forward(
        ctx.mix["batch"], ctx.mix["seq"], m["num_heads"], m["num_kv_heads"],
        m["head_dim"])
    return 100.0 * least / dev
