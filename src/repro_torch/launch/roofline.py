"""Roofline terms of a dry-run cell, priced for the H100 (the port's twin
of `src/repro/launch/roofline.py`, which prices TPU v5e from XLA's HLO).

The port has no HLO: the dry run (`launch/dryrun.py`) counts a rank's work
while it builds the real step on fake tensors, and hands this module
per-rank FLOPs, per-rank bytes and the step's collectives.  So there is no
HLO parser here.

Hardware model, one NVIDIA H100 SXM5 80GB a rank, each figure from NVIDIA's
H100 Tensor Core GPU data sheet (SXM column, dense rates) unless said:

    PEAK_BF16   989e12 FLOP/s   bf16 on the tensor cores
    PEAK_F32     67e12 FLOP/s   f32 outside the tensor cores
    HBM_BW     3.35e12 B/s      HBM3
    NVLINK_BW   900e9  B/s      NVLink 4, a GPU's 18 links, both directions
                                together (450 GB/s each way)
    IB_BW        50e9  B/s      one 400 Gb/s NDR InfiniBand port a GPU (the
                                DGX H100's eight ConnectX-7 ports, one a
                                GPU; NVIDIA DGX H100 user guide)

    T_comp = FLOPs / PEAK_BF16
    T_mem  = bytes / HBM_BW
    T_coll = Σ wire_bytes(op) / link_bw(op's group)

SEMANTICS: every count is PER RANK: the dry run builds one rank's step on its
local shards, so the terms are per-device times directly.  Collective wire
bytes use the reference's ring model (`_wire_bytes`, kept here as a copy),
a per-participating-device quantity:

    all-reduce       2·size·(N−1)/N     (send+receive per device)
    all-gather         size·(N−1)/N     (size = gathered output)
    reduce-scatter     size·(N−1)/N     (size = scattered input)
    all-to-all         size·(N−1)/N
    collective-permute size

Link bandwidth.  The reference prices every collective at one ICI link
(`ICI_BW`, 50 GB/s).  Here ranks are laid out node-major, 8 GPUs to a node
(NVLink inside, InfiniBand between), with the mesh's `model` axis
innermost, and a collective is priced at the slowest link its group
crosses: NVLink when all its ranks share a node, else InfiniBand.  On the
(16, 16) mesh a `model` group spans two nodes, so both axes cross
InfiniBand.  Collectives run one after another (no overlap with compute or
each other), so T_coll is an upper bound.

MODEL_FLOPS is GLOBAL (6·N_active·tokens train / 2·N_active·tokens
prefill / 2·N_active·batch decode); the per-device useful time is
MODEL_FLOPS / (chips · PEAK_BF16), and flops_ratio = MODEL_FLOPS / (chips ·
FLOPs) catches recompute (remat) and work repeated across ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

PEAK_FLOPS = 989e12       # bf16 / GPU (tensor cores, dense)
PEAK_F32_FLOPS = 67e12    # f32 / GPU (outside the tensor cores)
HBM_BW = 3.35e12          # bytes/s / GPU
NVLINK_BW = 900e9         # bytes/s / GPU inside a node
IB_BW = 50e9              # bytes/s / GPU between nodes
GPUS_PER_NODE = 8

# Datasheet peaks per torch device type (f32, the port's default dtype);
# other devices (CPU hosts, mostly) get a MEASURED dense-matmul peak instead
# (see `device_peak_flops`)
PEAK_FLOPS_BY_DEVICE = {"cuda": PEAK_F32_FLOPS}

_MEASURED_PEAK: Dict[str, float] = {}   # device type -> FLOP/s, probed once

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def measured_peak_flops(n: int = 512, reps: int = 5, device: str = "cpu") -> float:
    """Best-of-`reps` f32 dense-matmul throughput of `device`: 2n³ FLOPs
    over the fastest (n, n) @ (n, n) wall time."""
    import torch

    a = torch.full((n, n), 0.5, dtype=torch.float32, device=device)
    a @ a                                         # warm up outside timing
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        a @ a
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n ** 3 / best


def device_peak_flops(device: Any = "cuda") -> Tuple[float, str]:
    """(peak f32 FLOP/s, source) for a torch device: the data sheet's on
    CUDA (an H100), else a cached measured peak."""
    import torch

    kind = torch.device(device).type
    if kind in PEAK_FLOPS_BY_DEVICE:
        return PEAK_FLOPS_BY_DEVICE[kind], "datasheet"
    if kind not in _MEASURED_PEAK:
        _MEASURED_PEAK[kind] = measured_peak_flops(device=kind)
    return _MEASURED_PEAK[kind], "measured"


def _wire_bytes(kind: str, out_bytes: int, n: int) -> float:
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "collective-permute":
        return float(out_bytes)
    return out_bytes * frac


def link_bw(ranks: Sequence[int], gpus_per_node: int = GPUS_PER_NODE) -> float:
    """The slowest link a group of global ranks crosses: NVLink when they
    share a node (ranks node-major, `gpus_per_node` a node), else
    InfiniBand."""
    nodes = {r // gpus_per_node for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else IB_BW


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective of a step, as a rank issues it."""

    kind: str                    # one of COLLECTIVE_KINDS
    bytes: float                 # the ring model's `size` (see the module doc)
    axes: Tuple[str, ...]        # the mesh axes of its group
    ranks: Tuple[int, ...]       # the group's global ranks

    @property
    def n(self) -> int:
        return len(self.ranks)

    @property
    def wire_bytes(self) -> float:
        return _wire_bytes(self.kind, self.bytes, max(2, self.n)) if self.n > 1 else 0.0

    @property
    def seconds(self) -> float:
        return self.wire_bytes / link_bw(self.ranks) if self.n > 1 else 0.0


def summarize(colls: Iterable[Collective]) -> Dict[str, Any]:
    """Wire bytes and seconds by kind, and by (kind, axes)."""
    by_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    by_axes: Dict[str, float] = {}
    secs = 0.0
    for c in colls:
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.wire_bytes
        count[c.kind] = count.get(c.kind, 0) + 1
        key = f"{c.kind}@{','.join(c.axes)}"
        by_axes[key] = by_axes.get(key, 0.0) + c.wire_bytes
        secs += c.seconds
    return {"bytes_by_kind": by_kind, "count_by_kind": count, "bytes_by_axes": by_axes,
            "total_bytes": sum(by_kind.values()), "seconds": secs}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per-rank FLOPs the dry run counted (the reference's name)
    hlo_bytes: float            # per-rank bytes (each op's inputs and outputs, unfused)
    collective_bytes: float
    model_flops: float
    t_comp: float
    t_mem: float
    t_coll: float
    sources: Dict[str, str]
    collectives: Dict[str, Any]
    memory_per_device: Optional[float] = None
    notes: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem, "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def step_time_bound(self) -> float:
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound  (1.0 = at the roofline)."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / max(self.step_time_bound, 1e-30)

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS (global) / counted FLOPs (global = per-rank × chips)."""
        return self.model_flops / max(self.hlo_flops * self.chips, 1.0)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_time_bound=self.step_time_bound,
                 roofline_fraction=self.roofline_fraction, flops_ratio=self.flops_ratio)
        return d


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, flops: float,
            nbytes: float, collectives: Sequence[Collective], model_flops: float,
            peak_flops: float = PEAK_FLOPS, memory_per_device: Optional[float] = None,
            notes: str = "") -> RooflineReport:
    """The three terms of one rank's step: `flops` and `nbytes` per rank,
    `collectives` as the rank issues them, priced at `peak_flops` per rank
    (bf16 by default), HBM_BW and each group's link."""
    colls = summarize(collectives)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(flops), hlo_bytes=float(nbytes),
        collective_bytes=colls["total_bytes"], model_flops=float(model_flops),
        t_comp=flops / peak_flops, t_mem=nbytes / HBM_BW, t_coll=colls["seconds"],
        sources={"flops": "FlopCounterMode + kernel formulas", "bytes": "op inputs + outputs",
                 "collectives": "fake process group"},
        collectives=colls, memory_per_device=memory_per_device, notes=notes)


def collectives_from_json(rows: List[Dict[str, Any]]) -> List[Collective]:
    return [Collective(r["kind"], r["bytes"], tuple(r["axes"]), tuple(r["ranks"])) for r in rows]


def format_table(reports) -> str:
    hdr = (f"{'arch':16s} {'shape':12s} {'mesh':10s} {'T_comp(s)':>10s} {'T_mem(s)':>10s} "
           f"{'T_coll(s)':>10s} {'bound':>10s} {'dominant':>10s} {'MF/HLO':>7s} {'roofline%':>9s}")
    rows = [hdr, "-" * len(hdr)]
    for r in reports:
        rows.append(
            f"{r.arch:16s} {r.shape:12s} {r.mesh:10s} {r.t_comp:10.4f} {r.t_mem:10.4f} "
            f"{r.t_coll:10.4f} {r.step_time_bound:10.4f} {r.dominant:>10s} "
            f"{r.flops_ratio:7.3f} {100*r.roofline_fraction:8.1f}%")
    return "\n".join(rows)
