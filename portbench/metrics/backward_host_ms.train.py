"""backward_host_ms.train: the host's wall time in the program's `train.backward`
span (how long the step's thread blocks on autograd's backward, remat's
recomputed forwards included) over the traced steps, in ms."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("units"):
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a program without spans
        return None
    t = obs.totals("train.backward")
    return t.wall_ms / ctx["units"] if t.count else None
