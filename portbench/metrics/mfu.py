"""mfu.train, mfu.serve: the model's operations in the traced slice
(`flops.py`, no recompute counted) over the slice's length at the card's
bf16 peak, in %."""

from portbench import flops


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels() or tr.window_s <= 0:
        return None
    return 100.0 * ctx["unit_flops"] * ctx["units"] / (tr.window_s * flops.PEAK_BF16_FLOPS)
