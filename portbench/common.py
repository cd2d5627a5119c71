"""Small pieces the drivers share: the device's clock and memory, the
percentile, and the gaps that decide `correct`."""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, Iterable, List, Optional

import torch


def now() -> float:
    return time.perf_counter()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def percentile(values: Iterable[float], p: float) -> float:
    """Nearest-rank p-th percentile; a failed request is +inf."""
    v = sorted(values)
    if not v:
        return math.inf
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-300))


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[List[str]] = None) -> float:
    """The largest |‖prog‖ − ‖ref‖| over leaves, each against the larger of
    its reference norm and the median leaf's."""
    paths = keep if keep is not None else list(ref)
    med = statistics.median(ref[p] for p in ref)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-300) for p in paths)
