"""Multi-pod dry run: build every (arch × shape × mesh) cell's real step for
the ranks of the production mesh that bound it (`priced_ranks`), with no
card and no allocation.

The port's twin of `src/repro/launch/dryrun.py`, which lowers and compiles
the jitted program on 512 fake devices and reads XLA's analyses.  Here the
step itself runs, as each priced rank runs it, on fake tensors:

  * a fake process group of the mesh's world size (backend "fake",
    `torch.testing._internal.distributed.fake_pg.FakeStore`): collectives
    move nothing, and every rank's shard has its real shape;
  * `FakeTensorMode`: every tensor has a shape, a dtype and the device
    "cuda", and no storage; the kernels take their shape-only branch
    (`repro_torch.kernels.fake`);
  * the REAL step: the train step with AdamW (`train_step.make_train_step`
    on the state laid out by `state_specs`), or `serve_step`'s prefill or
    decode on params laid out by `param_specs` (and the cache by
    `cache_specs`), each with `mesh=` and the port's own rules.

The ranks of `model` are not all alike.  Where attention splits its query
rows over `model` in contiguous causal blocks (heads that the `model` size
does not divide), the last rank holds the last block and does the most
attention work; where a rank holds part of a K/V head, prefill's slot
exchange (`transformer._kv_slots`) has the first rank holding each head
send it, and rank 0 is one.  So a cell prices rank 0 and the last rank of
`model` (every other coordinate 0), and takes each term from the rank
where it is larger: FLOPs, bytes, the collectives (the rank with the
longer T_coll) and the peak; the record keeps each rank's own terms under
`by_rank`.  Every other rank of `model` does no more of either.

What a cell records, term by term the larger of the priced ranks':

  * state bytes: the arithmetic of `param_specs`, `cache_specs` and
    `state_specs` over the leaves (what a rank stores between steps);
  * peak bytes: `MemTracker` around the step, over the rank's stored
    shards and everything the step allocates, and what they are at the
    peak by `MemTracker`'s kinds (activations kept for the backward,
    temporaries, ...).  The port's steps compute on
    shards (`dist.sharding.compute_params`): a layer's params are gathered
    inside its checkpointed body, the gradients reduce-scattered in the
    backward, the K/V cache's slots kept split over `model`; so the peak
    holds the stored state, the remat boundaries and one layer's gathered
    params and recompute, not the whole params or a whole gradient;
    `fits` says whether it stays within the H100's 80 GB;
  * FLOPs: `FlopCounterMode`'s count of the step's aten ops (forward,
    backward, optimizer) plus what the kernels' fake branches report;
  * bytes: the sum over every op that makes a tensor and is not a view of
    its inputs' and outputs' bytes, each tensor counted at the memory it
    spans (a broadcast view once; an allocation or a constant fill counts
    nothing), plus the kernels' reported bytes: an unfused upper bound on
    the step's memory traffic;
  * collectives: every collective the rank issues, by kind, bytes and the
    mesh axes of its group, read from the fake group's calls;
  * the three roofline terms of `launch.roofline`, priced for the H100.

A cell's shard shapes are exact, so the numbers are what a rank of the real
mesh would hold and do, under the stated definitions; no number here is a
measurement on a card.

The fake tensors lie on "cuda:0" where torch is built with CUDA.  A torch
built without it (a CPU-only host) has no CUDA device guard, which
`Tensor.copy_`'s binding takes before it dispatches, so there
`Execution.torch_device()` puts them on the meta device instead
(`core/execution.resolve_device`); shapes, dtypes and every count are the
same.

Usage (CPU only, no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Per-cell JSON lands in experiments/dryrun_torch/; existing files are skipped
(delete or --force to re-run), so the sweep is resumable.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.configs import registry
from repro_torch.core.execution import Execution
from repro_torch.dist import sharding as shard_rules
from repro_torch.kernels import fake as fake_kernels
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline
from repro_torch.launch.report import HBM_PER_CHIP
from repro_torch.models import api

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")

# mesh name -> (shape, axes): the production meshes, and one rank alone
MESHES = {"single": mesh_mod.PRODUCTION[False], "multi": mesh_mod.PRODUCTION[True],
          "one": ((1, 1), ("data", "model"))}


CARD = torch.device("cuda", 0)     # the device a dry run builds its cells for

_COLLECTIVE_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"), ("broadcast", "broadcast"))
# allocations and constant fills: counted as no traffic
_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided",
               "zeros_like", "zeros", "ones", "full", "new_zeros", "scalar_tensor", "lift_fresh",
               "detach", "wait_tensor"}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A fake process group of `world_size` ranks, this process `rank`, for
    the block; destroyed on the way out, also when the block raises.
    Refuses to start while another group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; a process group "
                           f"({dist.get_backend()}, {dist.get_world_size()} ranks) is already "
                           "up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def priced_ranks(mesh_name: str) -> Tuple[int, ...]:
    """The global ranks a cell prices on the named mesh: rank 0 and the
    last of `model`, every other coordinate 0 (row-major, as
    `init_device_mesh` numbers them); one rank where they are the same."""
    shape, axes = MESHES[mesh_name]
    last = 0
    for size, ax in zip(shape, axes):
        last = last * size + (size - 1 if ax == "model" else 0)
    return (0, last) if last else (0,)


def make_mesh(mesh_name: str, device):
    """The named mesh over the current fake group."""
    if mesh_name in ("single", "multi"):
        return mesh_mod.make_production_mesh(multi_pod=mesh_name == "multi", device=device)
    return mesh_mod.make_smoke_mesh(1, device=device)


# ---------------------------------------------------------------------------
# counting modes
# ---------------------------------------------------------------------------

def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _span_bytes(ts) -> int:
    """The memory each tensor spans: a broadcast (stride-0) view counts
    once, so `matmul`'s mm and bmm forms of one product count alike."""
    total = 0
    for t in ts:
        if t.numel():
            total += (1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))) \
                * t.element_size()
    return total


class StepCounter:
    """A dispatch mode over one step: bytes of every non-view op, and the
    collectives, each with its group's mesh axes and global ranks."""

    def __init__(self, mesh):
        from torch.utils._python_dispatch import TorchDispatchMode

        axes = {}
        for name in mesh.mesh_dim_names:
            axes[mesh.get_group(name).group_name] = (name,)
        self.bytes = 0.0
        self.collectives: List[roofline.Collective] = []
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(t is DTensor for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                counter._see(func, args, kwargs, out, axes)
                return out

        self.mode = _Mode()

    def _see(self, func, args, kwargs, out, axes) -> None:
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            kind = next((k for key, k in _COLLECTIVE_KINDS if key in name), None)
            if kind is None:
                return
            group = _group_of(args)
            if group is None:
                return
            if kind == "all-gather":
                size = max(_nbytes(_tensors(args[0])) if ns == "c10d" else 0,
                           _nbytes(_tensors(out)))
            elif ns == "c10d" and kind in ("reduce-scatter", "all-to-all"):
                size = _nbytes(_tensors(args[1]))
            else:
                size = _nbytes(_tensors(args[0]))
            ranks = tuple(dist.get_process_group_ranks(group))
            self.collectives.append(roofline.Collective(
                kind, float(size), axes.get(group.group_name, ("?",)), ranks))
            return
        outs = _tensors(out)
        if func.is_view or name in _NO_TRAFFIC or not outs:
            return
        self.bytes += _span_bytes(_tensors(list(args) + list(kwargs.values())))
        self.bytes += _span_bytes(outs)


def _group_of(args):
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
        if isinstance(a, str):
            try:
                return _resolve_process_group(a)
            except (ValueError, RuntimeError, KeyError):
                continue
    return None


@dataclasses.dataclass
class StepCount:
    flops: float
    bytes: float
    peak_bytes: float
    collectives: List[roofline.Collective]
    kernels: Dict[str, Any]
    peak_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_top: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


def _peak_tracker(top: int):
    """A MemTracker that also keeps, each time the total reaches a new peak,
    the `top` largest live storages: bytes, kind, and the op, shape and
    dtype of the tensor that first held each."""
    from torch.distributed._tools import mem_tracker

    class PeakTop(mem_tracker.MemTracker):
        def __init__(self):
            super().__init__()
            self.tops: Dict[Any, List[Dict[str, Any]]] = {}
            self._op = "external"

        @property
        def peak_top(self) -> List[Dict[str, Any]]:
            """The list of the device with the largest peak."""
            if not self._peak_mem:
                return []
            return self.tops.get(max(self._peak_mem, key=self._peak_mem.get), [])

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._op = str(func)
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _track(self, reftype, t):
            super()._track(reftype, t)
            for st in mem_tracker.get_untyped_storages(t):
                winfo, _ = self._WINFO.get(st, (None, None))
                if winfo is not None and not hasattr(winfo, "made_by"):
                    winfo.made_by = (self._op, list(t.shape), str(t.dtype))

        def _update_peak_stats(self, peak_state):
            before = dict(self._peak_mem)
            super()._update_peak_stats(peak_state)
            for dev, peak in self._peak_mem.items():
                if peak == before.get(dev):
                    continue
                live = sorted((w for w, _ in self._WINFO.values() if w.device == dev),
                              key=lambda w: w.mem_consumed, reverse=True)[:top]
                self.tops[dev] = [
                    dict(zip(("op", "shape", "dtype"), getattr(w, "made_by", ("?", [], "?"))),
                         bytes=w.mem_consumed, kind=getattr(w.reftype, "value", str(w.reftype)))
                    for w in live]

    return PeakTop()


def count_step(fn, external: List[torch.Tensor], mesh, top: int = 0) -> StepCount:
    """Run `fn()` once under the counting modes: MemTracker (with `external`,
    the tensors the rank holds before the step), FlopCounterMode, the
    StepCounter and the kernels' fake-branch recorder.  With `top`, the
    record also lists the `top` largest storages live at the peak
    (`_peak_tracker`; each new peak scans the live storages, so it is off
    by default)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    mt = _peak_tracker(top) if top else MemTracker()
    mt.track_external(*external)
    counter = StepCounter(mesh)
    flop = FlopCounterMode(display=False)
    with fake_kernels.recording() as work, mt, flop, counter.mode:
        fn()
    snaps = mt.get_tracker_snapshot("peak").values()
    by_kind: Dict[str, float] = {}
    for snap in snaps:
        for kind, n in snap.items():
            if kind != "Total" and n:
                name = getattr(kind, "value", str(kind))
                by_kind[name] = by_kind.get(name, 0.0) + float(n)
    return StepCount(flops=flop.get_total_flops() + work.total_flops,
                     bytes=counter.bytes + work.total_bytes,
                     peak_bytes=float(sum(snap["Total"] for snap in snaps)),
                     collectives=counter.collectives,
                     kernels={"calls": dict(work.calls), "flops": dict(work.flops),
                              "bytes": dict(work.bytes)},
                     peak_by_kind=by_kind, peak_top=getattr(mt, "peak_top", []))


# ---------------------------------------------------------------------------
# building a cell
# ---------------------------------------------------------------------------

def _sharded_bytes(tree, specs, mesh) -> float:
    """Per-rank bytes of a tree under `specs` ({path: spec})."""
    total = 0.0
    for path, leaf in tree_mod.flatten_with_path(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        denom = 1
        for ax in specs.get(path, ()) or ():
            if ax is not None:
                denom *= shard_rules.axis_size(mesh, ax)
        total += leaf.numel() * leaf.element_size() / denom
    return total


def _owned_locals(tree) -> Tuple[Any, List[torch.Tensor]]:
    """`tree` with each DTensor's local shard owning its storage (a shard
    cut from a whole tensor would keep the whole alive: a rank holds its
    shards only, as a restore from a checkpoint gives them), and the list of
    the rank's local tensors."""
    from torch.distributed.tensor import DTensor

    held: List[torch.Tensor] = []

    def own(t):
        if shard_rules.is_dtensor(t):
            loc = t.to_local()
            if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
                loc = loc.clone()
                t = DTensor.from_local(loc, t.device_mesh, t.placements, run_check=False,
                                       shape=t.shape, stride=t.stride())
            held.append(loc)
        elif isinstance(t, torch.Tensor):
            held.append(t)
        return t

    return tree_mod.tree_map(own, tree), held


def apply_cut(cfg, *, layers: Optional[int] = None, opt_override: Optional[Dict] = None):
    """The config with `opt_override`'s fields and, with `layers`, cut to that
    many layers (the width stays)."""
    if opt_override:
        cfg = dataclasses.replace(cfg, **opt_override)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


@dataclasses.dataclass
class Cell:
    """A cell's step for the current rank, built and ready to run once."""

    run: Any                     # () -> the step's outputs
    held: List[torch.Tensor]     # what the rank holds before the step
    mode: Any                    # the FakeTensorMode to run it in (a no-op context if real)
    state_bytes: float
    model_flops: float
    params: int
    active_params: int
    batch: int
    seq: int


def build_cell(cfg, shape_name: str, mesh, *, batch: Optional[int] = None,
               seq: Optional[int] = None, device=None, fake: bool = True) -> Cell:
    """The cell's real step for the current rank on `device` (the card by
    default), on fake tensors unless `fake` is False (then on real ones, as
    the tests and chip_smoke.py run it to compare)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.serve import serve_step
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts

    cell = api.SHAPES[shape_name]
    b = batch or cell.global_batch
    s = seq or cell.seq_len
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    exe = Execution(backend="kernel", device=device if device is not None else CARD)
    n_total, n_active = api.exact_param_counts(cfg)
    gen = torch.Generator().manual_seed(0)
    with mode:
        device = exe.torch_device()
        specs = (api.input_specs(cfg, shape_name, batch_override=b, seq_override=s, mode=mode,
                                 device=device) if fake
                 else _real_inputs(cfg, cell, b, s, device))
        if cell.kind == "train":
            tcfg = ts.TrainConfig(arch=cfg, opt=opt_mod.AdamWConfig(),
                                  grad_accum=cfg.train_grad_accum)
            state = ts.init_state(gen, tcfg, execution=exe)
            state_bytes = _sharded_bytes(state, ts.state_specs(state, mesh), mesh)
            state, held = _owned_locals(ts.lay_out_state(state, mesh))
            data, more = _owned_locals(shard_rules.lay_out(
                specs["batch"], shard_rules.train_batch_specs(specs["batch"], mesh), mesh))
            step = ts.make_train_step(tcfg, execution=exe, mesh=mesh)
            run = lambda: step(state, data)  # noqa: E731
            model_flops = 6.0 * n_active * b * s
        else:
            params = api.init_params(gen, cfg, execution=exe)
            pspecs = shard_rules.param_specs(params, mesh)
            state_bytes = _sharded_bytes(params, pspecs, mesh)
            params, held = _owned_locals(shard_rules.lay_out(params, pspecs, mesh))
            if cell.kind == "prefill":
                data, more = _owned_locals(shard_rules.lay_out(
                    specs["batch"], shard_rules.train_batch_specs(specs["batch"], mesh), mesh))
                fn = serve_step.make_prefill(cfg, mesh, params, data, s, execution=exe,
                                             cache=_no_cache())
                run = lambda: fn(params, data)  # noqa: E731
                model_flops = 2.0 * n_active * b * s
            else:
                cache = specs["cache"]
                cspecs = shard_rules.cache_specs(cache, mesh)
                state_bytes += _sharded_bytes(cache, cspecs, mesh)
                cache, more = _owned_locals(shard_rules.lay_out(cache, cspecs, mesh))
                tok_spec = shard_rules.train_batch_specs({"t": specs["token"]}, mesh)
                token, tok = _owned_locals(shard_rules.lay_out({"t": specs["token"]}, tok_spec,
                                                               mesh))
                more = more + tok
                fn = serve_step.make_decode(cfg, mesh, params, cache, execution=exe,
                                            cache=_no_cache())
                run = lambda: fn(params, token["t"], cache)  # noqa: E731
                model_flops = 2.0 * n_active * b
    return Cell(run=run, held=held + more, mode=mode, state_bytes=state_bytes,
                model_flops=model_flops, params=n_total, active_params=n_active, batch=b, seq=s)


def build_and_count(cfg, shape_name: str, mesh, top: int = 0, **kw) -> Dict[str, Any]:
    """`build_cell`, then its step run once under the counting modes;
    returns the counts, the per-rank state bytes and the model FLOPs."""
    cell = build_cell(cfg, shape_name, mesh, **kw)
    with cell.mode:
        count = count_step(cell.run, cell.held, mesh, top=top)
    return {"count": count, "state_bytes": cell.state_bytes, "model_flops": cell.model_flops,
            "params": cell.params, "active_params": cell.active_params, "batch": cell.batch,
            "seq": cell.seq}


def _real_inputs(cfg, cell, b: int, s: int, device) -> Dict[str, Any]:
    """Seeded inputs of a cell's shapes, for a step run for real."""
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, dtype=torch.int32)
    if cell.kind == "decode":
        cache = api.init_cache(cfg, b, s, execution=Execution(device=device))
        return {"token": tokens[:, 0].to(device), "cache": cache}
    d = {"tokens": tokens.to(device)}
    if cfg.frontend == "audio":
        d["frames"] = torch.randn((b, s, cfg.frontend_dim), generator=gen).to(device)
    elif cfg.frontend == "vision":
        d["patches"] = torch.randn((b, cfg.frontend_seq, cfg.frontend_dim), generator=gen
                                   ).to(device)
    return {"batch": d}


def _no_cache():
    """A private LRU, so a dry run's steps never enter the serving LRU."""
    from repro_torch.serve.batching import BoundedCompileCache

    return BoundedCompileCache(maxsize=1)


def run_cell(arch_id: str, shape_name: str, mesh_name: str, *, verbose: bool = True,
             opt_override: Optional[Dict[str, Any]] = None, layers: Optional[int] = None,
             batch: Optional[int] = None, seq: Optional[int] = None,
             top: int = 0) -> Dict[str, Any]:
    """One cell's JSON record: "skipped" where `cell_supported` rules it out,
    else "ok" with the counts and the roofline terms (with `top`, the largest
    storages live at the peak, `peak_top_per_device`).  Starts and destroys
    its own fake process group."""
    cfg = apply_cut(registry.get(arch_id), layers=layers, opt_override=opt_override)
    ok, why = api.cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    shape, _ = MESHES[mesh_name]
    chips = math.prod(shape)
    t0 = time.monotonic()
    counts: Dict[int, StepCount] = {}
    for rank in priced_ranks(mesh_name):
        with fake_world(chips, rank):
            mesh = make_mesh(mesh_name, CARD)
            res = build_and_count(cfg, shape_name, mesh, top=top, batch=batch, seq=seq)
        counts[rank] = res["count"]
    t_build = time.monotonic() - t0

    def analyze(flops, nbytes, collectives, peak):
        return roofline.analyze(
            arch=arch_id, shape=shape_name, mesh_name=mesh_name, chips=chips, flops=flops,
            nbytes=nbytes, collectives=collectives, model_flops=res["model_flops"],
            memory_per_device=peak)

    by_rank = {r: analyze(c.flops, c.bytes, c.collectives, c.peak_bytes)
               for r, c in counts.items()}
    of = {"flops": max(counts, key=lambda r: counts[r].flops),
          "bytes": max(counts, key=lambda r: counts[r].bytes),
          "collectives": max(counts, key=lambda r: by_rank[r].t_coll),
          "peak": max(counts, key=lambda r: counts[r].peak_bytes)}
    count = counts[of["peak"]]
    coll = counts[of["collectives"]].collectives
    report = analyze(counts[of["flops"]].flops, counts[of["bytes"]].bytes, coll,
                     count.peak_bytes)
    out = {
        "status": "ok", "build_s": t_build, "rank_of": of,
        "by_rank": {str(r): {"t_comp": b.t_comp, "t_mem": b.t_mem, "t_coll": b.t_coll,
                             "peak_bytes": counts[r].peak_bytes}
                    for r, b in by_rank.items()},
        "state_bytes_per_device": res["state_bytes"],
        "peak_bytes_per_device": count.peak_bytes,
        "peak_by_kind_per_device": count.peak_by_kind,
        "peak_top_per_device": count.peak_top,
        "fits": count.peak_bytes <= HBM_PER_CHIP,
        "over_bytes": max(0.0, count.peak_bytes - HBM_PER_CHIP),
        "params": res["params"], "active_params": res["active_params"],
        "n_layers": cfg.n_layers, "batch": res["batch"], "seq": res["seq"],
        "kernels": counts[of["flops"]].kernels,
        "collective_calls": [dataclasses.asdict(c) for c in coll],
        **report.to_json(),
    }
    if verbose:
        print(f"[dryrun] {arch_id}/{shape_name}/{mesh_name}: build {t_build:.1f}s "
              f"state {res['state_bytes'] / 1e9:.2f} GB/rank peak "
              f"{count.peak_bytes / 1e9:.2f} GB/rank ({'fits' if out['fits'] else 'over'} 80 GB) "
              f"dominant={report.dominant} bound={report.step_time_bound:.4f}s "
              f"roofline={100 * report.roofline_fraction:.1f}%")
        print(f"[dryrun]   flops={report.hlo_flops:.3e} bytes={report.hlo_bytes:.3e} "
              f"coll={report.collective_bytes:.3e}")
    return out


def cell_path(out_dir: str, arch_id: str, shape_name: str, mesh_name: str, tag: str = "") -> str:
    stem = f"{arch_id}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    return os.path.join(out_dir, stem + ".json")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-rp", type=int, default=None,
                    help="RP-compressed KV cache ratio (hillclimb variant)")
    ap.add_argument("--tag", type=str, default="",
                    help="suffix for output files (hillclimb variants)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (the record's n_layers)")
    ap.add_argument("--top", type=int, default=0,
                    help="record the N largest storages live at the peak")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in registry.ARCH_IDS for s in api.SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(registry.ALIASES.get(args.arch, args.arch), args.shape)]

    override = {"kv_rp": args.kv_rp} if args.kv_rp else None
    failures = []
    for arch_id, shape_name in cells:
        for mesh_name in meshes:
            path = cell_path(args.out, arch_id, shape_name, mesh_name, args.tag)
            if os.path.exists(path) and not args.force:
                print(f"[dryrun] skip existing {path}")
                continue
            try:
                res = run_cell(arch_id, shape_name, mesh_name, opt_override=override,
                               layers=args.layers, top=args.top)
            except Exception as e:      # noqa: BLE001 — recorded in the cell's JSON
                traceback.print_exc()
                res = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures.append((arch_id, shape_name, mesh_name))
            with open(path, "w") as f:
                json.dump(res, f, indent=1, default=str)
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        return 1
    print("[dryrun] all requested cells OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
