"""The kernels under fake tensors: the dry run's shape-only branch.

`repro_torch.launch.dryrun` builds a step on fake CUDA tensors
(`FakeTensorMode`), which hold a shape, a dtype and a device but no data.
A kernel wrapper given a fake tensor off the CPU takes one branch of its
own: it returns outputs of the kernel's shapes and dtypes on the fake
device, counts no launch, and reports the call's work here, since
`FlopCounterMode` sees no operation in an output made by `torch.empty`.
The branch is taken only for a fake tensor; a real CUDA tensor still
launches the kernel or raises, and a CPU tensor, fake or real, runs the
plain version.

What a call reports, from its shapes alone:
  * FLOPs: the products the kernel does, counted as `FlopCounterMode` counts
    a matrix product (2 · m · n · k).  R's nonzeros are data, which a fake
    tensor does not hold, so B1 and B3 report the dense contraction, an
    upper bound; B2 its Gram products and G B; B4 its visible (query, key)
    pairs, 4 · Dh each and head (q kᵀ and p v), as `PERF.md` §6's bound
    column counts them; B4's backward 14 · Dh a pair and head (its two
    passes recompute s and dp: s, dp and dq, then s, dp, dv and dk).
  * bytes: each input read once and each output written once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List

import torch


def is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(t)


@dataclasses.dataclass
class KernelWork:
    """The kernel calls a dry run made, by kernel: calls, FLOPs, bytes."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0.0) + flops
        self.bytes[name] = self.bytes.get(name, 0.0) + nbytes

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


_recorders: List[KernelWork] = []


@contextlib.contextmanager
def recording() -> Iterator[KernelWork]:
    """Collect the work of every fake kernel call made inside the block."""
    rec = KernelWork()
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


def report(name: str, flops: float, nbytes: float) -> None:
    for rec in _recorders:
        rec.add(name, flops, nbytes)


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def visible_pairs(sq: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """The (query, key) pairs flash attention computes: key c is visible to
    the query at q_offset + r when c < skv, and, if causal, c <= q_offset +
    r, and, with a window w, q_offset + r - c < w."""
    total = 0
    for r in range(sq):
        pos = q_offset + r
        hi = min(skv, pos + 1) if causal else skv
        lo = max(0, pos - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total
