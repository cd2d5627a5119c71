"""flash_roofline.train, flash_roofline.serve: B4's least time at the traced
slice's launches (`flops.flash_bound_s` a launch) over the device time of
its kernels, in %."""

NAMES = ("flash_attention_kernel", "flash_tc_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    ks = [k for k in tr.kernels() if any(n in k.name for n in NAMES)]
    busy = sum(k.end - k.start for k in ks) / 1e6
    if not ks or busy <= 0:
        return None
    return 100.0 * len(ks) * ctx["flash_bound_s"] / busy
