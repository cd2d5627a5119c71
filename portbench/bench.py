"""The harness: one run of one cell, as `BENCHMARK.json` describes it.

`main` resolves the cell by name (its configuration in `configs/<name>.json`,
with its family in `families/` and its reference in `reference/`, its
traffic mix in `traffic/<name>.json`, its limits in
`limits/<cell>.json`), refuses to run without the cards the cell asks for,
hands the run to the traffic's driver (`drivers/<driver>.py`), reads each
per-layer metric of a traced run with its reader (`reader_path`),
and prints the result as the last line of standard output, each compared
number beside its limit on the last lines of standard error, and in the
result's last key.  Nothing here names a cell, a configuration or a
metric: a later cell or metric is a new file and a manifest entry.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot be made here (no card, files missing)."""


@dataclasses.dataclass
class Run:
    """What a driver needs of one run."""
    traffic: Dict[str, Any]
    arch: Any                     # arch.Arch
    seed: int
    seconds: float
    trace: bool
    device: Any                   # torch.device
    t_start: float
    fault: Optional[str] = None   # a fault planted under the timed path (tests, calibration)
    log: Callable[[str], None] = print
    reference: Optional[str] = None   # the config's plain reference, `reference/<name>.py`


def reference_of(r: Run):
    """The plain reference module the run's configuration names."""
    return importlib.import_module(f"portbench.reference.{r.reference}")


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    t_window: float                       # perf_counter at the window's start
    e2e: Dict[str, float]
    checks: List[Tuple[str, float]]       # (name, value), judged against limits
    memory_peak_bytes: int
    layer: Dict[str, Any]                 # what the per-layer readers read (traced runs)


def load_json(path: Path) -> Dict[str, Any]:
    if not path.exists():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def load_source(path: Path):
    """A module of the benchmark read from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: `metrics/<name>.py`, or where there
    is none, the family's `metrics/<name without its last .suffix>.py`
    (`mfu.train` and `mfu.serve` share `mfu.py`)."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.exists() or "." not in metric else \
        HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"


def resolve(root: Path, name: str):
    """(manifest, cell, config, traffic, limits) of cell `name`."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return manifest, cell, config, traffic, limits


def e2e_metrics(manifest, cell) -> List[Dict[str, Any]]:
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def layer_metrics(manifest, cell) -> List[Dict[str, Any]]:
    reported = {m["name"] for m in e2e_metrics(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> List[str]:
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)} & set(FORBIDDEN))


def judge(checks: List[Tuple[str, float]], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    out, ok = {}, True
    for name, value in checks:
        if name not in limits:
            raise Refused(f"no limit for {name!r} in the cell's limits file")
        good = value is not None and math.isfinite(value) and value <= limits[name]
        ok &= good
        out[name] = {"value": value, "limit": limits[name]}
    missing = sorted(set(limits) - {n for n, _ in checks})
    if missing:
        ok = False
        for name in missing:
            out[name] = {"value": None, "limit": limits[name]}
    return ok, out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *,
             device=None, t_start: Optional[float] = None, fault: Optional[str] = None,
             arch_overrides: Optional[Dict] = None, traffic_overrides: Optional[Dict] = None,
             log: Callable[[str], None] = print):
    """(result dict, checks dict): the whole run, the device's look aside
    when `device` is given (the CPU tests)."""
    import torch

    from portbench import arch as arch_mod

    t_start = time.perf_counter() if t_start is None else t_start
    manifest, cell, config, traffic, limits = resolve(root, name)
    traffic = dict(traffic, **(traffic_overrides or {}))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{name} needs {cell['chips']} CUDA device(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen")
        device = torch.device("cuda", 0)
        torch.zeros((), device=device)
        log(f"[set-up] {time.perf_counter() - t_start:.2f} s: imports and CUDA start")
        log(f"[card] {card_line()}")
        log(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    r = Run(traffic=traffic, arch=arch_mod.sizes(config["arch"], arch_overrides), seed=seed,
            seconds=seconds, trace=trace, device=device, t_start=t_start, fault=fault, log=log,
            reference=config["reference"])
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    out: Outcome = driver.run(r)
    correct, checks = judge(out.checks, limits)
    correct &= out.failed == 0 and out.attempted > 0
    if trace:
        metrics = {}
        for m in layer_metrics(manifest, cell):
            value = load_source(reader_path(m["name"])).read(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out.e2e, setup_s=out.t_window - t_start)
        metrics = {}
        for m in e2e_metrics(manifest, cell):
            if m["name"] not in e2e:
                raise Refused(f"the {traffic['driver']} driver gives no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace:
        tr = out.layer.get("trace")
        dev["busy_s"] = tr.busy_s() if tr is not None else 0.0
        dev["window_s"] = tr.window_s if tr is not None else 0.0
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.by_op(10),
                                   "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
    result["checks"] = checks
    return result, checks


def main(t_start: float, argv=None) -> int:
    """`t_start`: the process's first moment, as `run.py` read it."""
    p = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    sys.path.insert(0, str(root / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program (src/repro_torch) is not here: {e}", file=sys.stderr)
        return 2
    try:
        result, checks = run_cell(root, args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
