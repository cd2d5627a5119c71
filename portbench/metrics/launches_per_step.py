"""launches_per_step.train: device kernels in the traced slice over its steps
(a CUDA graph's kernels counted at each replay)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels():
        return None
    return len(tr.kernels()) / ctx["units"]
