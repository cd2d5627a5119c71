"""Mesh sharding rules, and the layouts and collectives they drive.

The JAX package's `dist/sharding.py` over a `torch.distributed`
`DeviceMesh` (`repro_torch.launch.mesh`).  Axis semantics:

  pod    — cross-pod data parallelism (gradient sync only)
  data   — in-pod data parallelism, sharded param storage
  model  — expert parallelism (and the KV cache's sequence dim)

The rules are the reference's to the letter: an axis absent from the
mesh, a dim its axis size does not divide, and a stacked `layers` leading
dim stay replicated.  A spec is a plain tuple with one entry per tensor
dim — None, an axis name, or a tuple of axis names — so it compares equal
to the reference's `PartitionSpec`.  Tree specs are dicts from a leaf's
path (`jax.tree_util.keystr`'s string, `repro_torch.tree`) to its spec.
The rules read only the mesh's axis names and shape: a `DeviceMesh`, or
any object with `axis_names` and `devices.shape` (the reference's mesh).

Layouts.  `lay_out` turns full tensors into DTensors with the placements
of their specs (`Shard(d)` on each mesh dim a spec names, `Replicate()`
elsewhere), each rank slicing its own shard with no communication;
`full` / `to_numpy` gather them back.  A spec of `()` leaves the tensor
as it is: replicated by construction (the DR state, the host counters).

Compute never sees a DTensor: every meshed entry point hands the model
code and the kernels local tensors (`full`, `dp_rows`), and the
collectives below move what crosses ranks.  `use_mesh` is the counterpart
of the reference's `with mesh:` — the ambient mesh `moe_layer` reads to
choose expert parallelism.  The reference's `constrain` (a layout hint
inside its model code) has no counterpart: on local tensors it pins
nothing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]
Specs = Dict[str, Spec]


# ---------------------------------------------------------------------------
# mesh introspection
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _sizes(mesh) -> Dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is None or a named `DeviceMesh`."""
    if mesh is not None and not (is_device_mesh(mesh) and mesh.mesh_dim_names):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh with named dims "
                        f"(repro_torch.launch.mesh), got {type(mesh).__name__}")


def batch_axes(mesh) -> AxisName:
    """The data-parallel axis (or axes) of `mesh`: ("pod", "data") on a
    multi-pod mesh, "data" on one pod; a str for one axis, a tuple for
    several, () for none."""
    if mesh is None:
        return "data"
    names = tuple(n for n in ("pod", "data") if n in axis_names(mesh))
    if not names:
        return ()
    return names[0] if len(names) == 1 else names


def as_axes(axes: AxisName) -> Tuple[str, ...]:
    """`axes` (None, a name, or a tuple of names) as a tuple of names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: AxisName) -> int:
    """Product of the sizes of `axes` (str, tuple, or None) in `mesh`."""
    if mesh is None or axes is None:
        return 1
    sizes = _sizes(mesh)
    size = 1
    for ax in as_axes(axes):
        size *= sizes.get(ax, 1)
    return size


def _divisible(dim: int, mesh, axes: AxisName) -> bool:
    s = axis_size(mesh, axes)
    return s >= 1 and dim % s == 0


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(name: str, shape: Sequence[int], mesh) -> Spec:
    """Spec of one parameter:
      * last dim        → "model"
      * second-to-last  → "data"   (the reference's FSDP shard of the other feature dim)
      * a stacked `layers` leading dim is never sharded
      * any dim not divisible by its axis size stays replicated"""
    shape = tuple(shape)
    ndim = len(shape)
    if ndim == 0:
        return ()
    spec: list = [None] * ndim
    names = axis_names(mesh)
    if ndim >= 2:
        if "model" in names and _divisible(shape[-1], mesh, "model"):
            spec[-1] = "model"
        cand = ndim - 2
        stacked = "layers" in name and cand == 0
        if not stacked and "data" in names and _divisible(shape[cand], mesh, "data"):
            spec[cand] = "data"
    return tuple(spec)


def param_specs(params: Any, mesh) -> Specs:
    """{path: spec} of every parameter leaf (named by its tree path)."""
    return {path: param_spec(path, leaf.shape, mesh)
            for path, leaf in tree_mod.flatten_with_path(params)}


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def train_batch_specs(batch: Any, mesh) -> Specs:
    """Shard every batch leaf's leading (batch) dim over the DP axes."""
    dax = batch_axes(mesh)

    def leaf_spec(leaf) -> Spec:
        if leaf.ndim == 0:
            return ()
        if dax and _divisible(leaf.shape[0], mesh, dax):
            return (dax,) + (None,) * (leaf.ndim - 1)
        return (None,) * leaf.ndim

    return {path: leaf_spec(leaf) for path, leaf in tree_mod.flatten_with_path(batch)}


def splits_rows(rows: int, mesh) -> bool:
    """Whether a batch of `rows` splits over the DP axes: they exist, have
    more than one rank, and divide it (else every rank holds the whole
    batch)."""
    dax = batch_axes(mesh)
    n = axis_size(mesh, dax)
    return bool(dax) and n > 1 and rows % n == 0


def cache_specs(cache: Any, mesh) -> Specs:
    """KV / recurrence-cache layout (layers, batch, seq?, ...): dim 1
    (batch) over the DP axes; for attention K/V caches dim 2 (sequence)
    over "model" — sequence parallelism of a long context's cache."""
    dax = batch_axes(mesh)
    out = {}
    for name, leaf in tree_mod.flatten_with_path(cache):
        if leaf.ndim < 2:
            out[name] = (None,) * leaf.ndim
            continue
        spec: list = [None] * leaf.ndim
        if dax and _divisible(leaf.shape[1], mesh, dax):
            spec[1] = dax
        is_kv = name.endswith("['k']") or name.endswith("['v']")
        if (is_kv and leaf.ndim >= 4 and "model" in axis_names(mesh)
                and _divisible(leaf.shape[2], mesh, "model")):
            spec[2] = "model"
        out[name] = tuple(spec)
    return out


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, *, rows_split: bool = True) -> Iterator[Any]:
    """Make `mesh` the ambient mesh of this thread (the reference's
    `with mesh:`).  `rows_split`: whether the rows this rank computes on are
    its DP shard of the batch (False when the DP axes do not divide it and
    every rank holds the whole batch)."""
    prev = getattr(_AMBIENT, "ctx", None)
    _AMBIENT.ctx = (mesh, rows_split)
    try:
        yield mesh
    finally:
        _AMBIENT.ctx = prev


def ambient_mesh():
    """The mesh of the enclosing `use_mesh` block, or None outside one."""
    ctx = getattr(_AMBIENT, "ctx", None)
    return None if ctx is None else ctx[0]


def rows_split() -> bool:
    ctx = getattr(_AMBIENT, "ctx", None)
    return bool(ctx is not None and ctx[1])


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on every mesh dim
    that shards tensor dim d, `Replicate()` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        for a in as_axes(ax):
            out[names.index(a)] = Shard(dim)
    return out


def spec_of(x) -> Spec:
    """The spec (one entry per tensor dim) of a DTensor's placements."""
    names = axis_names(x.device_mesh)
    spec: list = [None] * x.ndim
    for i, p in enumerate(x.placements):
        if p.is_shard():
            d = p.dim
            spec[d] = names[i] if spec[d] is None else as_axes(spec[d]) + (names[i],)
    return tuple(spec)


def shard_index(mesh, axes: AxisName) -> Tuple[int, int]:
    """(this rank's block index, block count) along `axes`, the first axis
    major (the order JAX and DTensor split a dim over several axes)."""
    sizes = _sizes(mesh)
    idx, n = 0, 1
    for a in as_axes(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def local_slice(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of `full` under `spec` (a view)."""
    out = full
    for dim, ax in enumerate(spec):
        i, n = shard_index(mesh, ax)
        if n > 1:
            size = full.shape[dim] // n
            out = out.narrow(dim, i * size, size)
    return out


def lay_out_leaf(full: torch.Tensor, spec: Spec, mesh):
    """`full` (the same on every rank) as a DTensor laid out by `spec`."""
    from torch.distributed.tensor import DTensor

    local = local_slice(full, spec, mesh)
    return DTensor.from_local(local if local is full else local.contiguous(), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


def lay_out(tree: Any, specs: Specs, mesh, *, device=None) -> Any:
    """`tree` (tensors or numpy arrays, the same on every rank) with each
    leaf whose path `specs` names with a non-empty spec laid out on `mesh`
    as a DTensor; other leaves as they are.  numpy leaves become tensors on
    `device` (the mesh's device type by default)."""
    dev = torch.device(device if device is not None else _mesh_device(mesh))

    def one(path, leaf):
        if isinstance(leaf, np.ndarray):
            from repro_torch.bridge import to_tensor

            leaf = to_tensor(leaf, dev)
        spec = specs.get(path)
        if not spec or not isinstance(leaf, torch.Tensor):
            return leaf
        return lay_out_leaf(leaf, spec, mesh)

    return tree_mod.unflatten(tree, (one(p, l) for p, l in tree_mod.flatten_with_path(tree)))


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`, with no tensor made."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        # a mesh over the dry run's fake group lives on a card it does not need
        return torch.device("cuda", 0 if fake_group() else torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _trivial(x) -> bool:
    """A DTensor whose every sharded mesh dim has one rank: its local
    tensor is the whole tensor."""
    mesh = x.device_mesh
    return all(p.is_replicate() or mesh.size(i) == 1 for i, p in enumerate(x.placements))


def full(x: Any) -> Any:
    """The whole tensor of a DTensor (gathered; no copy when nothing is
    split); anything else as it is."""
    if not is_dtensor(x):
        return x
    return x.to_local() if _trivial(x) else x.full_tensor()


def full_tree(tree: Any) -> Any:
    return tree_mod.tree_map(full, tree)


def to_numpy(tree: Any) -> Any:
    """A laid-out tree gathered back to numpy leaves (bf16 widened to f32)."""
    from repro_torch.bridge import to_array

    return tree_mod.tree_map(
        lambda t: to_array(full(t)) if isinstance(t, torch.Tensor) else t, tree)


def local(x: Any) -> Any:
    """A DTensor's local shard; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def dp_rows(x: Any, mesh, split: bool) -> torch.Tensor:
    """This rank's DP block of x's leading dim when `split`, else the whole
    of x; x is a DTensor (whatever its layout) or the whole tensor every
    rank holds."""
    x = torch.as_tensor(full(x))
    if not split:
        return x
    return local_slice(x, ((batch_axes(mesh) if split else None),) + (None,) * (x.ndim - 1),
                       mesh)


def gathered_except(x, keep: Sequence[str]) -> torch.Tensor:
    """A DTensor's local tensor with every mesh dim outside `keep` gathered
    (the DP shard of a cache leaf with its sequence dim whole)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    names = axis_names(mesh)
    new = [p if (names[i] in keep or mesh.size(i) == 1) else Replicate()
           for i, p in enumerate(x.placements)]
    if all(a == b for a, b in zip(new, x.placements)):
        return x.to_local()
    return x.redistribute(mesh, new).to_local()


# ---------------------------------------------------------------------------
# collectives on local tensors
# ---------------------------------------------------------------------------

def fake_group() -> bool:
    """Whether the current process group is a fake one (backend "fake", as
    the dry run starts: no communication, no card)."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def _groups(mesh, axes: AxisName):
    """(axis, group, size) for each axis of `axes` with more than one rank."""
    sizes = _sizes(mesh)
    return [(a, mesh.get_group(a), sizes[a]) for a in as_axes(axes) if sizes.get(a, 1) > 1]


def all_reduce_sum_(t: torch.Tensor, mesh, axes: AxisName) -> torch.Tensor:
    for _, g, _ in _groups(mesh, axes):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


def all_reduce_mean_(t: torch.Tensor, mesh, axes: AxisName) -> torch.Tensor:
    """In place: the mean of `t` over the ranks of `axes` (sum, then divide:
    gloo has no AVG)."""
    n = 1
    for _, g, size in _groups(mesh, axes):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        n *= size
    if n > 1:
        t.div_(n)
    return t


def all_gather_cat(t: torch.Tensor, mesh, axes: AxisName, dim: int) -> torch.Tensor:
    """The blocks of `axes` concatenated along `dim` in block order (the
    inverse of `local_slice`)."""
    for _, g, size in reversed(_groups(mesh, axes)):
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts, dim=dim)
    return t


def block(t: torch.Tensor, mesh, axes: AxisName, dim: int) -> torch.Tensor:
    i, n = shard_index(mesh, axes)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


# Autograd over collectives for compute that the ranks of an axis repeat
# (every rank of `model` runs the same loss on the same rows) except where
# it is split on purpose (the MoE tokens of expert parallelism).  Moving
# between the two forms, the backward of a split is a gather and the
# backward of a gather is a split, so each piece of gradient is counted
# exactly once.

class SplitRepl(torch.autograd.Function):
    """Repeated → split: this rank's block along `dim` (backward: gather)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return all_gather_cat(g, mesh, axes, dim), None, None, None


class GatherRepl(torch.autograd.Function):
    """Split → repeated: the blocks gathered along `dim` (backward: this
    rank's block of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_gather_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return block(g, mesh, axes, dim).contiguous(), None, None, None


# Across the DP axes every rank holds its own loss, so moving between the
# forms needs the true adjoints: the backward of a gather sums the ranks'
# gradients of the whole and keeps this rank's block (a reduce-scatter), and
# the backward of taking a block puts the gradient back among zeros.

class GatherRows(torch.autograd.Function):
    """Split → whole over ranks with their own losses: the blocks gathered
    along `dim` (backward: the ranks' gradients summed, this rank's block)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_gather_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        summed = all_reduce_sum_(g.contiguous().clone(), mesh, axes)
        return block(summed, mesh, axes, dim).contiguous(), None, None, None


class BlockRows(torch.autograd.Function):
    """Whole → this rank's block along `dim` of ranks with their own losses
    (backward: the gradient in its block, zeros elsewhere)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim, x.shape)
        return block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, shape = ctx.args
        out = g.new_zeros(shape)
        block(out, mesh, axes, dim).copy_(g)
        return out, None, None, None


class SumGrad(torch.autograd.Function):
    """A repeated tensor read by split compute: identity forward, the
    partial gradients summed over `axes` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce_sum_(g.contiguous().clone(), mesh, axes), None, None


class MeanRepl(torch.autograd.Function):
    """The mean over `axes` of per-rank values (the reference's pmean).
    Backward divides by the ranks of `shared` — the axes whose ranks share
    one loss; the DP axes' own mean is the gradient sync's."""

    @staticmethod
    def forward(ctx, x, mesh, axes, shared):
        ctx.n = axis_size(mesh, shared)
        return all_reduce_mean_(x.detach().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None, None


class AllToAll(torch.autograd.Function):
    """`all_to_all_single` along dim 0 with equal splits over `axis`; it is
    its own transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_to_all(g, mesh, axis), None, None


def _all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis))
    return out
