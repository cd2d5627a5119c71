"""optimizer_host_ms.train: the host's wall time in the program's
`train.optimizer` span (the loss's reductions, the global norm, clipping,
AdamW and the relayout) over the traced steps, in ms."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("units"):
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a program without spans
        return None
    t = obs.totals("train.optimizer")
    return t.wall_ms / ctx["units"] if t.count else None
