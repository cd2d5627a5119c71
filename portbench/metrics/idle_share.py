"""idle_share.train, idle_share.serve: 1 − the union of the device's busy
intervals over the traced slice's length, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels() or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
