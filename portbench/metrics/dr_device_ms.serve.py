"""dr_device_ms.serve: the device time a request of everything launched under
the benchmark's `portbench.dr` span around the DR call (the captured
program's replays and its copies in and out), in ms."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    busy = tr.device_s(lambda e: "portbench.dr" in e.spans)
    return busy / ctx["units"] * 1e3 if busy > 0 else None
