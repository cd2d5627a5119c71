"""step_host_ms.serve: the scheduler thread's wall time in the program's
`serve.step` spans (an LM step run at flush) over the traced requests, in
ms."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("units"):
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a program without spans
        return None
    t = obs.totals("serve.step")
    return t.wall_ms / ctx["units"] if t.count else None
