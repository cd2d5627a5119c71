"""dr_host_ms.serve: the host's wall time in the program's
`dr.serve_and_update` and `dr.transform` spans (the serving engine's DR
call) over the traced requests, in ms."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("units"):
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a program without spans
        return None
    ts = [obs.totals(n) for n in ("dr.serve_and_update", "dr.transform")]
    if not any(t.count for t in ts):
        return None
    return sum(t.wall_ms for t in ts) / ctx["units"]
