"""step_off_cpu_ms.serve: the time the scheduler thread spends off the CPU in
the program's `serve.step` spans (wall − the thread's CPU time: waiting on
the interpreter lock, a lock or a full launch queue) over the traced
requests, in ms."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("units"):
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a program without spans
        return None
    t = obs.totals("serve.step")
    return t.off_cpu_ms / ctx["units"] if t.count else None
