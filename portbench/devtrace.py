"""A traced slice of the window: `torch.profiler` over the CPU and the card,
reduced to what the per-layer metrics read.

The profiler's chrome trace is written to a temporary file, read back and
deleted.  Each device event (kernel, copy, fill) is tied by its correlation
id to the runtime call that launched it (a graph's kernels to the
`cudaGraphLaunch` of its replay), and that call to the innermost CPU op
and the benchmark's own spans (`record_function("portbench.<name>")`) open
around it on its thread.  Device busy time is the union of the device
events' intervals inside the slice, not their sum.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
GAPS_NAMED = 10


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float        # us
    end: float
    op: str             # innermost host op open around the launch
    spans: Tuple[str, ...]   # the benchmark's spans open around the launch


@dataclasses.dataclass
class Trace:
    start: float
    end: float
    events: List[DeviceEvent]
    gaps: List[Tuple[str, float]]       # (what the host ran, seconds), longest first

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> List[DeviceEvent]:
        return [e for e in self.events if e.cat == "kernel"]

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union([(e.start, e.end) for e in self.events])) / 1e6

    def device_s(self, pred: Callable[[DeviceEvent], bool]) -> float:
        return sum(e.end - e.start for e in self.events if pred(e)) / 1e6

    def by_op(self, top: int = 10) -> List[List]:
        acc: Dict[str, float] = {}
        for e in self.events:
            acc[e.op] = acc.get(e.op, 0.0) + (e.end - e.start) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _experimental():
    """Ask the profiler for the CPU ops of every thread (the scheduler's
    loop launches the prefill), where this torch offers it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profiled(device: torch.device, out: Dict):
    """Profile the body, which opens the span `SLICE` (`slice_span`);
    `collect(out)`, called once the window has closed, reduces it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    exp = _experimental()
    if exp is not None:
        kw["experimental_config"] = exp
    with profile(activities=acts, **kw) as prof:
        yield
    out["prof"] = prof


def collect(out: Dict) -> Optional[Trace]:
    """The `Trace` of the profile `profiled` left in `out` (None if none)."""
    prof = out.pop("prof", None)
    if prof is None:
        return None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            raw = json.load(fh)
    finally:
        os.unlink(path)
    return reduce(raw)


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name[:80]


def slice_span():
    return torch.profiler.record_function(SLICE)


def reduce(raw: Dict) -> Optional[Trace]:
    """The `Trace` of a chrome trace's `SLICE` span; None without one."""
    evs = [e for e in raw.get("traceEvents", []) if e.get("ph") == "X"]
    sl = [e for e in evs if e.get("cat") == "user_annotation" and e.get("name") == SLICE]
    if not sl:
        return None
    t0 = float(sl[0]["ts"])
    t1 = t0 + float(sl[0]["dur"])
    host: Dict[object, List[Tuple[float, float, str, bool]]] = {}
    launch: Dict[int, Tuple[object, float]] = {}
    for e in evs:
        cat = e.get("cat")
        if cat in HOST_CATS:
            user = cat == "user_annotation"
            host.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"], user))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[int(corr)] = (e.get("tid"), float(e["ts"]))
    for tid in host:
        host[tid].sort()
    starts = {tid: [h[0] for h in hs] for tid, hs in host.items()}
    spans_of = {tid: [h for h in hs if h[3] and h[2].startswith("portbench.") and h[2] != SLICE]
                for tid, hs in host.items()}

    def innermost(tid, ts) -> Optional[str]:
        """The most recently started host event still open at ts: events
        nest, so that is the innermost one."""
        hs = host.get(tid) or []
        i = bisect.bisect_right(starts.get(tid, []), ts)
        for j in range(i - 1, -1, -1):
            h = hs[j]
            if h[1] >= ts and not (h[3] and h[2] == SLICE):
                return h[2]
        return None

    device = []
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if b <= t0 or a >= t1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        tid, ts = launch.get(int(corr), (None, None)) if corr is not None else (None, None)
        if tid is None:
            op, spans = "(launch not traced)", ()
        else:
            # the port's own kernels launch through ctypes, under no aten op
            op = innermost(tid, ts) or kernel_name(e["name"])
            spans = tuple(h[2] for h in spans_of.get(tid, []) if h[0] <= ts <= h[1])
        device.append(DeviceEvent(e["name"], e["cat"], max(a, t0), min(b, t1), op, spans))
    device.sort(key=lambda d: d.start)
    busy = _union([(d.start, d.end) for d in device])
    edges = [t0] + [x for seg in busy for x in seg] + [t1]
    raw_gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:GAPS_NAMED]
    gaps = []
    for width, g0 in raw_gaps:
        mid = g0 + 0.5 * width
        names = [n for n in (innermost(tid, mid) for tid in sorted(host, key=str)) if n]
        gaps.append((" | ".join(names)[:160] or "(no host op recorded)", width / 1e6))
    return Trace(start=t0, end=t1, events=device, gaps=gaps)
