"""Rank programs of the port's multi-rank mesh tests.

`spawn(scenario, world, directory, inputs)` saves `inputs` under
`directory`, starts `world` processes of this file (`python
torch_mesh_ranks.py <scenario> <rank> <world> <directory>`), each with one
thread, a gloo process group through a `FileStore` under `directory` (so
xdist workers never share a port) and a time limit, and returns every
rank's result dict.  A rank imports torch and the port only: `jax_loaded`
in each result says whether anything brought JAX in.  The reference's
numbers are computed by the test process and compared there.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")


def spawn(scenario: str, world: int, directory, inputs, *, timeout: float = 240.0):
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    for r in range(world):
        log = open(d / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, scenario, str(r), str(world), str(d)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = (d / f"rank{bad[0]}.log").read_text()[-4000:]
        raise AssertionError(f"{scenario}: ranks {bad} failed (exit "
                             f"{[procs[r].returncode for r in bad]}):\n{text}")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# helpers shared by the scenarios
# ---------------------------------------------------------------------------

def _cpu(backend="kernel"):
    from repro_torch.core.execution import Execution

    return Execution(backend=backend, device="cpu")


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _gathered(tree):
    """{path: numpy} of a (laid-out) tree; collective."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding

    return {p: np.asarray(v) for p, v in tree_mod.flatten_with_path(sharding.to_numpy(tree))}


def _local_blocks(tree, mesh):
    """{path: (this rank's local numpy block, [(start, size)] per dim of the
    whole tensor)} of a laid-out tree; a plain leaf is the whole."""
    from repro_torch import tree as tree_mod
    from repro_torch.bridge import to_array
    from repro_torch.dist import sharding

    out = {}
    for p, v in tree_mod.flatten_with_path(tree):
        loc = sharding.local(v)
        index = [(0, n) for n in loc.shape]
        if sharding.is_dtensor(v):
            for dim, ax in enumerate(sharding.spec_of(v)):
                i, _ = sharding.shard_index(mesh, ax)
                index[dim] = (i * loc.shape[dim], loc.shape[dim])
        out[p] = (np.asarray(to_array(loc)), index)
    return out


def _local_shapes(tree, mesh):
    """{path: (local shape, the shape its spec gives)} of a laid-out tree's
    DTensor leaves."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding

    out = {}
    for p, v in tree_mod.flatten_with_path(tree):
        if sharding.is_dtensor(v):
            want = list(v.shape)
            for dim, ax in enumerate(sharding.spec_of(v)):
                want[dim] //= sharding.axis_size(mesh, ax)
            out[p] = (tuple(v.to_local().shape), tuple(want))
    return out


class Allocations:
    """A dispatch mode that records the shape of every tensor an op makes
    that is not a view of its inputs (factories, copies, collectives'
    buffers), forward, backward and the backward's recompute alike."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        self.shapes = []
        seen = self.shapes

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(t is DTensor for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if not func.is_view:
                    for t in (out if isinstance(out, (list, tuple)) else [out]):
                        if isinstance(t, torch.Tensor):
                            seen.append(tuple(t.shape))
                return out

        self.mode = _Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _whole_shapes(params, mesh, cfg, cache=None):
    """{shape: what} a rank must never allocate in a meshed step: each
    stacked `layers` matrix leaf that the mesh splits, whole; each layer's
    whole (E, d, f) expert stack; each K/V cache leaf whole in its slots
    (whole, or this rank's DP rows of it).  Global shapes from the whole
    `params` / `cache` every rank was given."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding

    out = {}
    specs = sharding.param_specs(params, mesh)
    for path, leaf in tree_mod.flatten_with_path(params):
        if not path.startswith("['layers']") or not sharding.split_axes(specs[path], mesh):
            continue
        if leaf.ndim >= 3:
            out[tuple(leaf.shape)] = f"whole stacked {path}"
        if cfg.moe is not None and leaf.ndim == 4:
            out[tuple(leaf.shape[1:])] = f"a layer's whole expert stack {path}"
    if cache is not None:
        cspecs = sharding.cache_specs(cache, mesh)
        for path, leaf in tree_mod.flatten_with_path(cache):
            if sharding.is_kv_leaf(path, leaf) and "model" in sharding.split_axes(cspecs[path],
                                                                                  mesh):
                out[tuple(leaf.shape)] = f"whole K/V cache {path}"
                rows = list(leaf.shape)
                rows[1] //= sharding.axis_size(mesh, cspecs[path][1])
                out[tuple(rows)] = f"K/V cache {path}, this rank's rows with every slot"
    return out


def _by_design(forbidden, params, mesh):
    """(`forbidden` without the shapes a step makes by design, [those
    entries as (shape, what)]): the buffers that `LayerShard.rows()`
    exchanges over "model", (n, rows / n, columns / n) of each layer
    matrix whose columns "model" splits.  A whole leaf "model" splits can
    only be made by a gather over "model", so such an entry is held by
    `ModelGathers` instead (`_gathered_whole`)."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding

    _, n = sharding.model_rank(mesh)
    specs = sharding.param_specs(params, mesh)
    made = {(n, leaf.shape[-2] // n, leaf.shape[-1] // n)
            for path, leaf in tree_mod.flatten_with_path(params)
            if path.startswith("['layers']") and leaf.ndim == 3 and n > 1
            and specs[path][-1] == "model"}
    return ({s: w for s, w in forbidden.items() if s not in made},
            sorted((s, w) for s, w in forbidden.items() if s in made))


def _violations(alloc, forbidden):
    return sorted({f"{shape}: {forbidden[shape]}" for shape in alloc.shapes
                   if shape in forbidden})


def _train_cases(rank, inputs, mesh, out, key="train"):
    from repro_torch.train import train_step as ts

    for name, case in inputs.get(key, {}).items():
        state = ts.lay_out_state(case["state"], mesh)
        step = ts.make_train_step(case["tcfg"], execution=_cpu(), mesh=mesh)
        forbidden = _whole_shapes(case["state"].params, mesh, case["tcfg"].arch)
        metrics = []
        with Allocations() as alloc:
            for batch in case["batches"]:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        shapes = _local_shapes(state, mesh)
        leaves = _gathered(state)
        out[f"train/{name}"] = {"metrics": metrics, "shapes": shapes,
                                "leaves": leaves if rank == 0 else None,
                                "allocations": len(alloc.shapes), "forbidden": len(forbidden),
                                "violations": _violations(alloc, forbidden)}


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def scenario_mesh_2x2(rank, world, inputs, d):
    """(2 data, 2 model): the meshed train steps (the MoE one expert-parallel),
    each under the allocation guard; on (4 data, 1 model) the
    MoE train step without expert parallelism and the RP-compressed DP step;
    a sharded checkpoint saved over 4 ranks, and the trainer's resume on the
    mesh."""
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import compress
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    out = {}
    mesh = _mesh((2, 2))
    _train_cases(rank, inputs, mesh, out)
    _train_cases(rank, inputs, mesh, out, key="train_ep")

    dmesh = _mesh((4, 1))
    _train_cases(rank, inputs, dmesh, out, key="train_data_mesh")

    dp = inputs["dp"]
    r = {int(i): torch.as_tensor(v) for i, v in dp["r"].items()}
    seen = []
    step = ts.make_dp_compressed_step(dp["tcfg"], dmesh, execution=_cpu(), r=r,
                                      inspect=lambda *a: seen.append(a))
    state, ef = dp["state"], compress.residual_init(dp["state"].params)
    metrics = []
    for batch in dp["batches"]:
        state, ef, m = step(state, batch, ef)
        metrics.append({k: float(v) for k, v in m.items()})
    # synced + new error feedback = gradient + old error feedback, on every
    # compressed leaf (the plain-mean leaves keep their carry)
    min_size = dp["tcfg"].grad_compress.min_size
    ident = max(float(torch.max(torch.abs(s + e2 - g - e1)) / torch.max(torch.abs(g + e1)))
                for g, e1, s, e2 in zip(*(tree_mod.leaves(t) for t in seen[0]))
                if g.numel() >= min_size)
    out["dp"] = {"metrics": metrics, "ident": ident,
                 "params": _gathered(state.params) if rank == 0 else None,
                 "ef": _gathered(ef)}

    ck = inputs["elastic"]
    saved = ts.lay_out_state(ck["state"], mesh)
    CheckpointManager(ck["dir"], async_save=False).save(1, saved)
    out["elastic_saved_shapes"] = _local_shapes(saved, mesh)

    tr = inputs["trainer"]
    quiet = dict(execution=_cpu("torch"), mesh=mesh, data_cfg=tr["data"], log=lambda s: None)
    cfg = lambda sub, **kw: dataclasses.replace(tr["cfg"], ckpt_dir=os.path.join(d, sub), **kw)
    full = trainer.train(cfg("a"), **quiet)
    first = trainer.train(cfg("b", total_steps=3), **quiet)
    resumed = trainer.train(cfg("b"), **quiet)
    long = trainer.train(cfg("c", total_steps=12, ckpt_every=20), **quiet)
    out["trainer"] = {"full": full["losses"], "first": first["losses"],
                      "resumed": resumed["losses"], "start": resumed["start_step"],
                      "full_params": _gathered(full["state"].params),
                      "resumed_params": _gathered(resumed["state"].params),
                      "long": long["losses"]}
    return out


def scenario_mesh_4x2(rank, world, inputs, d):
    """(4 data, 2 model): `dr_transform` at an odd and an even batch,
    `DRService(mesh=)` over ragged rows, the meshed train steps, meshed
    prefill + decode over a K/V cache split over `model` (a `kv_rp` case on
    the reference's R, put in place of the port's), each under the
    allocation guard, and the elastic restore of the 4-rank checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import transformer
    from repro_torch.dist import sharding
    from repro_torch.serve import BucketPolicy, DRService, dr_serve, serve_step
    from repro_torch.train import train_step as ts

    out = {}
    mesh = _mesh((4, 2))

    dr = inputs["dr"]
    model, state = dr["model"], dr["state"]
    for name, x in dr["x"].items():
        y = dr_serve.dr_transform(model, state, x, mesh=mesh)
        out[f"dr/{name}"] = {"y": sharding.full(y).numpy(), "spec": sharding.spec_of(y),
                             "local": tuple(y.to_local().shape)}
    svc = DRService(mesh=mesh, buckets=BucketPolicy(min_bucket=8, max_bucket=64))
    svc.register("m", model, state)
    out["service"] = {"answers": {n: svc.transform("m", x).numpy()
                                  for n, x in dr["rows"].items()},
                      "misses": svc.cache.misses}

    _train_cases(rank, inputs, mesh, out)

    for name, case in inputs["serve"].items():
        cfg, params = case["cfg"], case["params"]
        own_r = transformer.kv_rp_matrix
        if "kv_rp_r" in case:
            transformer.kv_rp_matrix = lambda c, device: case["kv_rp_r"].to(device)
        laid = sharding.lay_out(params, sharding.param_specs(params, mesh), mesh)
        exe = _cpu()
        pre = serve_step.make_prefill(cfg, mesh, laid, case["batch"], case["cache_size"],
                                      execution=exe)
        with Allocations() as alloc, ModelGathers() as gathers:
            logits, cache = pre(laid, case["batch"])
        steps = [sharding.full(logits).numpy()]
        placements = {k: sharding.spec_of(v) for k, v in cache.items()
                      if sharding.is_dtensor(v)}
        dec = serve_step.make_decode(cfg, mesh, laid, cache, execution=exe)
        with alloc:
            for tok in case["forced"]:
                logits, cache = dec(laid, tok, cache)
                steps.append(sharding.full(logits).numpy())
        transformer.kv_rp_matrix = own_r
        whole_cache = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in cache.items() if isinstance(v, torch.Tensor) and v.ndim}
        forbidden, unguarded = _by_design(_whole_shapes(params, mesh, cfg, whole_cache), params,
                                          mesh)
        out[f"serve/{name}"] = {"logits": steps, "cache": _gathered(cache),
                                "specs": placements, "shapes": _local_shapes(cache, mesh),
                                "allocations": len(alloc.shapes), "forbidden": len(forbidden),
                                "violations": (_violations(alloc, forbidden)
                                               + _gathered_whole(gathers, unguarded))}

    ck = inputs["elastic"]
    target = ts.lay_out_state(ck["target"], mesh)
    step, restored = CheckpointManager(ck["dir"]).restore(target)
    out["elastic"] = {"step": step, "leaves": _gathered(restored),
                      "shapes": _local_shapes(restored, mesh)}
    return out


def scenario_dist_8(rank, world, inputs, d):
    """8 ranks: expert-parallel MoE on (2 data, 4 model) over the rank's
    stored shards of a one-layer stack (`param_specs`' layout, as the
    meshed steps hand them to `moe_layer`), its gradients, and
    `compress_sync` over (8 data,)."""
    from repro_torch.dist import compress, sharding
    from repro_torch.models import blocks

    out = {}
    moe = inputs["moe"]
    mesh = _mesh((2, 4))
    params, x, spec = moe["params"], moe["x"], moe["spec"]
    stacked = {"layers": {k: v[None] for k, v in params.items()}}
    specs = sharding.param_specs(stacked, mesh)
    path = {k: f"['layers'][{k!r}]" for k in params}

    def layer(local):
        cp = sharding.compute_params({"layers": local}, specs, mesh, True)
        return blocks.gather_layer(blocks.layer_params(cp, 0), keep=blocks.EXPERT_KEYS)

    di = mesh.get_local_rank("data")
    rows = x.shape[0] // 2
    x_loc = x[di * rows:(di + 1) * rows]
    local = {k: sharding.local_slice(v, specs[path[k]], mesh).clone()
             for k, v in stacked["layers"].items()}
    with Allocations() as alloc:
        y, aux = blocks.moe_layer(layer(local), x_loc, spec, "silu")
    out["moe"] = {"y": y.numpy(), "aux": {k: float(v) for k, v in aux.items()}, "data": di,
                  "whole_stacks": sorted({s for s in alloc.shapes
                                          if s in {tuple(v.shape) for v in params.values()
                                                   if v.ndim == 3}})}
    # gradients: of the sum over the DP ranks of <y, w> on each rank's rows;
    # each local shard's gradient is the DP mean of that sum's, gathered
    # whole here and scaled back to the sum
    p = {k: v.requires_grad_(True) for k, v in local.items()}
    xl = x_loc.clone().requires_grad_(True)
    y, _ = blocks.moe_layer(layer(p), xl, spec, "silu")
    (y * moe["w"][di * rows:(di + 1) * rows]).sum().backward()
    grads = {}
    for k, v in p.items():
        g = v.grad
        for dim, ax in enumerate(specs[path[k]]):
            if ax is not None:
                g = sharding.all_gather_cat(g, mesh, ax, dim)
        grads[k] = (g[0] * sharding.axis_size(mesh, "data")).numpy()
    out["moe_grad"] = {"x": xl.grad.numpy(), "params": grads}

    cs = inputs["compress"]
    cmesh = _mesh((8,), ("data",))
    g = cs["g"][rank:rank + 1]
    cfg = cs["cfg"]
    synced, ef = compress.compress_sync({"g": g}, {"g": torch.zeros_like(g)}, cfg, ("data",),
                                        mesh=cmesh)
    rr = {0: torch.as_tensor(cs["r"])}
    synced_r, ef_r = compress.compress_sync({"g": g}, {"g": torch.zeros_like(g)}, cfg,
                                            ("data",), mesh=cmesh, r=rr)
    out["compress"] = {"synced": synced["g"].numpy(), "ef": ef["g"].numpy(),
                       "synced_r": synced_r["g"].numpy(), "ef_r": ef_r["g"].numpy()}
    return out


def _split_forbidden(params, mesh, cfg, cache=None):
    """({shape: what} a rank must never allocate, [what the guard cannot
    hold]): `_whole_shapes` (with the K/V cache's entries where `cache` is
    given), plus one layer's whole matrix of each leaf that a transformer's
    layers split over `model` read only in part: `wq` / `wo` where the
    query heads split, `wk` / `wv` where no rank reads every K/V head, the
    dense MLP's matrices where d_ff splits.  A shape that a step makes by
    design — a leaf's local shard or its block gathered over the DP axes,
    any piece of a leaf outside the layers — cannot be guarded by shape:
    an entry with such a shape goes to the second list, as (shape, what).
    That happens where the query heads a rank of `model` holds are as many
    as the K/V heads (hq / n == hkv): the block of `wq` it stores is then
    `wk`'s and `wv`'s whole shape.  A whole leaf that "model" splits can
    only be made by a gather over "model" (`ModelGathers` records them),
    so such an entry is held there instead."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding
    from repro_torch.models import transformer

    out = _whole_shapes(params, mesh, cfg, cache)
    _, n = sharding.model_rank(mesh)
    if n > 1 and cfg.family == "transformer":
        layers = params["layers"]
        names = []
        if cfg.n_heads % n == 0:
            names += ["wq", "wo"]
            if all(c - a < cfg.n_kv_heads for _, (a, c) in transformer._head_ranges(cfg, n)):
                names += ["wk", "wv"]
        if cfg.moe is None and cfg.d_ff % n == 0:
            names += [k for k in ("w_in", "w_gate", "w_out") if k in layers]
        for k in names:
            out[tuple(layers[k].shape[1:])] = f"one layer's whole ['layers'][{k!r}]"
    specs = sharding.param_specs(params, mesh)
    by_design = set()
    for path, leaf in tree_mod.flatten_with_path(params):
        spec = specs[path]
        layer = path.startswith("['layers']")
        # the local shard and its block gathered over the DP axes; outside
        # the layers every stage of the gather too
        kept = [spec, tuple(ax if ax == "model" else None for ax in spec)]
        if not layer:
            kept += [tuple(None if ax == "model" else ax for ax in spec), (None,) * leaf.ndim]
        for keep in kept:
            shape = tuple(d // sharding.axis_size(mesh, ax) for d, ax in zip(leaf.shape, keep))
            by_design.add(shape[1:] if layer else shape)
            by_design.add(shape)
    return ({shape: what for shape, what in out.items() if shape not in by_design},
            sorted((shape, what) for shape, what in out.items() if shape in by_design))


class ModelGathers:
    """Records the shape of every tensor gathered over "model": the
    results of `sharding.all_gather_cat` over an axis set that holds it and
    of `sharding.TakeCols` (columns exchanged over "model")."""

    def __enter__(self):
        from repro_torch.dist import sharding

        self.shapes = set()
        self._orig = (sharding.all_gather_cat, sharding.TakeCols.forward)
        gather, take = self._orig

        def all_gather_cat(t, mesh, axes, dim):
            out = gather(t, mesh, axes, dim)
            if "model" in sharding.as_axes(axes):
                self.shapes.add(tuple(out.shape))
            return out

        def take_cols(ctx, t, mesh, ranges):
            out = take(ctx, t, mesh, ranges)
            self.shapes.add(tuple(out.shape))
            return out

        sharding.all_gather_cat = all_gather_cat
        sharding.TakeCols.forward = staticmethod(take_cols)
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import sharding

        sharding.all_gather_cat = self._orig[0]
        sharding.TakeCols.forward = staticmethod(self._orig[1])


def _gathered_whole(gathers, unguarded):
    """The entries the allocation guard cannot hold whose whole shape a
    gather over "model" made."""
    return [f"{shape}: {what}" for shape, what in unguarded if shape in gathers.shapes]


class LayerInputs:
    """Records the residual stream each layer body starts from under
    `blocks.remat` (what the checkpoint keeps between layers), and the
    shapes of every tensor autograd saves outside the checkpointed bodies."""

    def __init__(self):
        self.remat, self.saved = [], []

    def __enter__(self):
        from repro_torch.models import blocks

        self._orig = blocks.remat

        def remat(fn, *args):
            if fn.__name__ == "body" and torch.is_grad_enabled():
                self.remat.append(tuple(args[0].shape))
            return self._orig(fn, *args)

        blocks.remat = remat
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            lambda t: (self.saved.append(tuple(t.shape)), t)[1], lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks

        self._hooks.__exit__(*exc)
        blocks.remat = self._orig


def scenario_mesh_tp(rank, world, inputs, d):
    """A transformer's layers split over `model` on the mesh `inputs`
    names: the train steps under the allocation guard and `LayerInputs`,
    prefill + decode of the serving cases, and on (1, 4) one layer's matmul
    FLOPs on this rank against the unmeshed layer's (`FlopCounterMode`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import sharding
    from repro_torch.models import transformer
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts

    out = {}
    shape, names = inputs["mesh"]
    mesh = _mesh(shape, names)
    r, n = sharding.model_rank(mesh)
    n_dp = sharding.axis_size(mesh, sharding.batch_axes(mesh))
    for name, case in inputs["train"].items():
        tcfg = case["tcfg"]
        state = ts.lay_out_state(case["state"], mesh)
        step = ts.make_train_step(tcfg, execution=_cpu(), mesh=mesh)
        forbidden, unguarded = _split_forbidden(case["state"].params, mesh, tcfg.arch)
        metrics = []
        with Allocations() as alloc, LayerInputs() as seen, ModelGathers() as gathers:
            for batch in case["batches"]:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        rows = case["batches"][0]["tokens"].shape[0]
        s = transformer.stream_len(tcfg.arch, case["batches"][0])
        b_loc = rows // n_dp if sharding.splits_rows(rows, mesh) else rows
        split = sharding.seq_splits(s, mesh)
        leaves = _gathered(state)                     # collective: every rank
        whole = (b_loc, s, tcfg.arch.d_model)
        out[f"train/{name}"] = {
            "metrics": metrics, "leaves": leaves if rank == 0 else None,
            "shapes": _local_shapes(state, mesh), "allocations": len(alloc.shapes),
            "forbidden": len(forbidden), "unguarded": len(unguarded),
            "violations": _violations(alloc, forbidden) + _gathered_whole(gathers, unguarded),
            "remat": sorted(set(seen.remat)),
            "remat_want": (b_loc, s // n, tcfg.arch.d_model) if split else whole,
            "saved_whole": sum(sh == whole for sh in seen.saved) if split else None}

    for name, case in inputs["serve"].items():
        cfg, params = case["cfg"], case["params"]
        own_r = transformer.kv_rp_matrix
        if "kv_rp_r" in case:
            transformer.kv_rp_matrix = lambda c, device: case["kv_rp_r"].to(device)
        laid = sharding.lay_out(params, sharding.param_specs(params, mesh), mesh)
        pre = serve_step.make_prefill(cfg, mesh, laid, case["batch"], case["cache_size"],
                                      execution=_cpu())
        with Allocations() as alloc, ModelGathers() as gathers:
            logits, cache = pre(laid, case["batch"])
            steps = [sharding.full(logits).numpy()]
            dec = serve_step.make_decode(cfg, mesh, laid, cache, execution=_cpu())
            for tok in case["forced"]:
                logits, cache = dec(laid, tok, cache)
                steps.append(sharding.full(logits).numpy())
        transformer.kv_rp_matrix = own_r
        whole_cache = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in cache.items() if isinstance(v, torch.Tensor) and v.ndim}
        forbidden, unguarded = _split_forbidden(params, mesh, cfg, whole_cache)
        out[f"serve/{name}"] = {"logits": steps, "cache": _gathered(cache),
                                "allocations": len(alloc.shapes), "forbidden": len(forbidden),
                                "unguarded": len(unguarded),
                                "violations": (_violations(alloc, forbidden)
                                               + _gathered_whole(gathers, unguarded))}

    if "flops" in inputs:
        fl = inputs["flops"]
        cfg, params, batch = fl["cfg"], fl["params"], fl["batch"]
        local, specs = sharding.local_specs(
            sharding.lay_out(params, sharding.param_specs(params, mesh), mesh))
        on_rank = sharding.compute_params(local, specs, mesh, False, seq=True)
        counts = {}
        for key, p in (("split", on_rank), ("whole", params)):
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                transformer.hidden_states(p, batch, cfg, remat=False, execution=_cpu())
            counts[key] = fc.get_total_flops()
        out["flops"] = counts
    return out


def _recurrent_forbidden(params, mesh, cfg, cache=None):
    """`_split_forbidden`'s twin for the recurrent families: ({shape: what}
    a rank must never allocate, [what the guard cannot hold by shape]).
    Beside `_whole_shapes`, each whole matrix that their split over
    `model` reads only in part: Zamba-2's `in_proj`, `conv_w` and
    `out_proj` where its SSD heads split, its shared block's `wq` / `wk` /
    `wv` / `wo` where the shared heads split and `w_in` / `w_gate` /
    `w_out` where d_ff does; RWKV-6's `wr` / `wk` / `wv` / `wg` /
    `w_lora_b` / `wo` where the WKV heads split and `cm_r` / `cm_k` /
    `cm_v` where d_ff does (`w_lora_a` is read whole by design).  A shape
    that a step makes by design — a leaf's local shard, its block gathered
    over the DP axes, its rows moved over "model", each stacked over the
    layers as the backward stacks their gradients — goes to the second
    list, held by `ModelGathers` instead."""
    from repro_torch import tree as tree_mod
    from repro_torch.dist import sharding
    from repro_torch.models import rwkv6, ssm, transformer

    out = _whole_shapes(params, mesh, cfg, cache)
    _, n = sharding.model_rank(mesh)
    layers, named = params["layers"], []
    if cfg.family == "zamba" and ssm.splits(cfg, n):
        if cfg.ssm.n_heads(cfg.d_model) % n == 0:
            named += [("layers", k) for k in ("in_proj", "conv_w", "out_proj")]
        if transformer.splits_heads(cfg, n):
            named += [("shared", k) for k in ("wq", "wk", "wv", "wo")]
        if cfg.d_ff % n == 0:
            named += [("shared", k) for k in ("w_in", "w_gate", "w_out")]
    if cfg.family == "rwkv6" and n > 1 and (cfg.d_model // rwkv6.HEAD_DIM) % n == 0:
        named += [("layers", k) for k in ("wr", "wk", "wv", "wg", "w_lora_b", "wo")]
        if cfg.d_ff % n == 0:
            named += [("layers", k) for k in ("cm_r", "cm_k", "cm_v")]
    for tree, k in named:
        shape = tuple(params[tree][k].shape[1:] if tree == "layers" else params[tree][k].shape)
        out[shape] = f"whole ['{tree}'][{k!r}]"
    specs = sharding.param_specs(params, mesh)
    by_design = set()
    for path, leaf in tree_mod.flatten_with_path(params):
        spec = specs[path]
        inner = path.startswith(("['layers']", "['shared']"))
        shape = tuple(leaf.shape[1:]) if path.startswith("['layers']") else tuple(leaf.shape)
        spec = spec[len(spec) - len(shape):]
        kept = [spec, tuple(ax if ax == "model" else None for ax in spec)]
        if not inner:
            kept += [tuple(None if ax == "model" else ax for ax in spec), (None,) * len(shape)]
        made = [tuple(d // sharding.axis_size(mesh, ax) for d, ax in zip(shape, keep))
                for keep in kept]
        if inner and len(shape) >= 2 and spec[-1] == "model":
            made.append(shape[:-2] + (shape[-2] // n, shape[-1]))
        by_design.update(made)
        if path.startswith("['layers']"):        # stacked, as the backward stacks them
            by_design.update((leaf.shape[0],) + m for m in made)
    return ({shape: what for shape, what in out.items() if shape not in by_design},
            sorted((shape, what) for shape, what in out.items() if shape in by_design))


def scenario_mesh_recurrent(rank, world, inputs, d):
    """Zamba-2 and RWKV-6 split over `model` on the mesh `inputs` names:
    the train steps under the allocation guard and `LayerInputs`, prefill
    + decode of the serving cases (every rank's cache gathered), and one
    layer's matmul FLOPs on this rank against the unmeshed layer's
    (`FlopCounterMode`) where `inputs` holds a FLOPs case.  `ssd_chunk`
    sets Mamba-2's block-form chunk, as the reference's is set.  A serving
    case records each rank's own block of the cache (`_local_blocks`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import sharding
    from repro_torch.models import api, rwkv6, ssm
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step as ts

    ssm.SSD_CHUNK = inputs["ssd_chunk"]
    out = {}
    shape, names = inputs["mesh"]
    mesh = _mesh(shape, names)
    r, n = sharding.model_rank(mesh)
    n_dp = sharding.axis_size(mesh, sharding.batch_axes(mesh))
    for name, case in inputs["train"].items():
        tcfg = case["tcfg"]
        cfg = tcfg.arch
        state = ts.lay_out_state(case["state"], mesh)
        step = ts.make_train_step(tcfg, execution=_cpu(), mesh=mesh)
        forbidden, unguarded = _recurrent_forbidden(case["state"].params, mesh, cfg)
        metrics = []
        with Allocations() as alloc, LayerInputs() as seen, ModelGathers() as gathers:
            for batch in case["batches"]:
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        rows, s = case["batches"][0]["tokens"].shape
        b_loc = rows // n_dp if sharding.splits_rows(rows, mesh) else rows
        feat = api.splits_features(cfg, mesh)
        leaves = _gathered(state)                     # collective: every rank
        out[f"train/{name}"] = {
            "metrics": metrics, "leaves": leaves if rank == 0 else None,
            "shapes": _local_shapes(state, mesh), "allocations": len(alloc.shapes),
            "forbidden": len(forbidden), "unguarded": len(unguarded),
            "violations": _violations(alloc, forbidden) + _gathered_whole(gathers, unguarded),
            "remat": sorted(set(seen.remat)),
            "remat_want": (b_loc, s, cfg.d_model // n if feat else cfg.d_model)}

    for name, case in inputs["serve"].items():
        cfg, params = case["cfg"], case["params"]
        laid = sharding.lay_out(params, sharding.param_specs(params, mesh), mesh)
        pre = serve_step.make_prefill(cfg, mesh, laid, case["batch"], case["cache_size"],
                                      execution=_cpu())
        with Allocations() as alloc, ModelGathers() as gathers:
            logits, cache = pre(laid, case["batch"])
            steps = [sharding.full(logits).numpy()]
            dec = serve_step.make_decode(cfg, mesh, laid, cache, execution=_cpu())
            for tok in case["forced"]:
                logits, cache = dec(laid, tok, cache)
                steps.append(sharding.full(logits).numpy())
        whole_cache = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in cache.items() if isinstance(v, torch.Tensor) and v.ndim}
        forbidden, unguarded = _recurrent_forbidden(params, mesh, cfg, whole_cache)
        out[f"serve/{name}"] = {"logits": steps, "blocks": _local_blocks(cache, mesh),
                                "allocations": len(alloc.shapes), "forbidden": len(forbidden),
                                "unguarded": len(unguarded),
                                "violations": (_violations(alloc, forbidden)
                                               + _gathered_whole(gathers, unguarded))}

    for name, fl in inputs.get("flops", {}).items():
        cfg, params, batch = fl["cfg"], fl["params"], fl["batch"]
        local, specs = sharding.local_specs(
            sharding.lay_out(params, sharding.param_specs(params, mesh), mesh))
        on_rank = sharding.compute_params(local, specs, mesh, False,
                                          seq=api.splits_features(cfg, mesh))
        mod = {"zamba": ssm, "rwkv6": rwkv6}[cfg.family]
        counts = {}
        for key, p in (("split", on_rank), ("whole", params)):
            with torch.no_grad(), FlopCounterMode(display=False) as fc:
                mod.hidden_states(p, batch, cfg, remat=False, execution=_cpu())
            counts[key] = fc.get_total_flops()
        out[f"flops/{name}"] = counts
    return out


def scenario_dp_spans(rank, world, inputs, d):
    """One `make_dp_compressed_step` under a profile: the spans it records
    on this rank, as (name, parent's name)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.dist import compress
    from repro_torch.models.config import DRFrontendSpec
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    arch = dataclasses.replace(registry.get_smoke("hubert_xlarge"), compute_dtype="float32",
                               dr_frontend=DRFrontendSpec(p=16, n=8))
    cfg = ts.TrainConfig(arch=arch, grad_compress=compress.CompressConfig())
    state = ts.init_state(torch.Generator().manual_seed(0), cfg, execution=_cpu())
    data = synthetic.TokenStreamConfig(vocab_size=arch.vocab_size, seq_len=8,
                                       global_batch=2 * world)
    step = ts.make_dp_compressed_step(cfg, _mesh((world, 1)), execution=_cpu())
    batch = trainer.make_batch(arch, data, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch, compress.residual_init(state.params))
    spans = obs.spans()
    names = {s.index: s.name for s in spans}
    return {"spans": [(s.name, names.get(s.parent)) for s in spans]}


SCENARIOS = {"mesh_2x2": scenario_mesh_2x2, "mesh_4x2": scenario_mesh_4x2,
             "dist_8": scenario_dist_8, "mesh_tp": scenario_mesh_tp,
             "mesh_recurrent": scenario_mesh_recurrent, "dp_spans": scenario_dp_spans}


def main():
    import torch.distributed as dist

    scenario, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
        out = SCENARIOS[scenario](rank, world, inputs, d)
        out["jax_loaded"] = "jax" in sys.modules or "repro" in sys.modules
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
