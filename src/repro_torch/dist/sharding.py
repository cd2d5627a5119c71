"""Mesh sharding rules, and the layouts and collectives they drive.

The JAX package's `dist/sharding.py` over a `torch.distributed`
`DeviceMesh` (`repro_torch.launch.mesh`).  Axis semantics:

  pod    — cross-pod data parallelism (gradient sync only)
  data   — in-pod data parallelism, sharded param storage
  model  — tensor / expert / sequence parallelism (and the KV cache's
           sequence dim)

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

Compute never sees a DTensor, and computes on the shards a rank stores.
`compute_params` hands the model code a rank's local params: every stacked
`layers` leaf as a `LayerShard`, which a layer body reads for that layer
alone — whole (`LayerShard.whole`), or in the layout its tensor-parallel
product computes in (`block`, `cols`, `rows`: the rank's `model` block
gathered over the DP axes only, moved between dims by one all-to-all, or
the columns it reads — the K/V heads its query heads read, Mamba-2's
z / xs / dt of its heads and the B / C every rank reads) — Zamba-2's
shared block likewise, and every other leaf gathered once per step.  The
gathers are `GatherParam`, whose backward is the true adjoint of the
step's loss, so gradients come out of the backward as local shards in
`param_specs`' layout and `global_norm` sums their squares over the axes
each is split on.  Where the residual stream is
split over `model` by sequence (`seq_splits`; `compute_params(seq=True)`),
or Zamba-2's training carry by feature, each rank of `model` holds its own
share of the loss: a gather of the stream is `GatherRows` (backward:
reduce-scatter), the row-parallel products' partial sums meet in
`ScatterSeq` (backward: gather), along the split dim, and a leaf the split
compute reads whole sums its gradient over `model`.  With the stream whole
(decode; RWKV-6), row-parallel products meet in `ReduceModel`.
A K/V cache keeps its sequence dim split over `model` (`kv_seq_shard`:
decode scores a rank's own slots and merges over `model` through the
log-sum-exp).  `use_mesh` is the counterpart of the reference's `with
mesh:` — the ambient mesh the serving steps read for a K/V cache's slot
split (the rest of the model code reads the mesh from its shards).  The
reference's `constrain` (a layout hint inside its model code) has no
counterpart: on local tensors it pins nothing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

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


def is_kv_leaf(path: str, leaf) -> bool:
    """Whether a cache leaf is an attention K / V cache (layers, batch, slots, heads, dh)."""
    return (path.endswith("['k']") or path.endswith("['v']")) and leaf.ndim >= 4


def kv_splits(slots: int, mesh) -> bool:
    """Whether a K/V cache of `slots` slots keeps them split over "model"."""
    return "model" in axis_names(mesh) and _divisible(slots, mesh, "model")


def seq_splits(s: int, mesh) -> bool:
    """Whether a residual stream of `s` positions splits over "model" by
    sequence: the mesh has more than one `model` rank and their count
    divides `s` (the reference's `constrain(x, "batch", "model", None)`)."""
    n = axis_size(mesh, "model") if mesh is not None and "model" in axis_names(mesh) else 1
    return n > 1 and s % n == 0


def model_rank(mesh) -> Tuple[int, int]:
    """(this rank's index, rank count) along "model" (0, 1 without it)."""
    if mesh is None or "model" not in axis_names(mesh):
        return 0, 1
    return mesh.get_local_rank("model"), axis_size(mesh, "model")


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
        if is_kv_leaf(name, leaf) and kv_splits(leaf.shape[2], mesh):
            spec[2] = "model"
        out[name] = tuple(spec)
    return out


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, *, kv_split: bool = False) -> Iterator[Any]:
    """Make `mesh` the ambient mesh of this thread (the reference's
    `with mesh:`).  `kv_split`: whether the K/V cache the serving step makes
    or holds keeps its slots split over "model" (`kv_seq_shard`)."""
    prev = getattr(_AMBIENT, "ctx", None)
    _AMBIENT.ctx = (mesh, kv_split)
    try:
        yield mesh
    finally:
        _AMBIENT.ctx = prev


def ambient_mesh():
    """The mesh of the enclosing `use_mesh` block, or None outside one."""
    ctx = getattr(_AMBIENT, "ctx", None)
    return None if ctx is None else ctx[0]


def kv_seq_shard() -> Tuple[Any, int, int]:
    """(mesh, this rank's block, block count) of the K/V cache's slot dim
    in the enclosing `use_mesh` block: split over "model" when the block
    says so, else (mesh, 0, 1); (None, 0, 1) outside a mesh."""
    ctx = getattr(_AMBIENT, "ctx", None)
    if ctx is None or not ctx[1]:
        return (None if ctx is None else ctx[0]), 0, 1
    mesh = ctx[0]
    return mesh, mesh.get_local_rank("model"), axis_size(mesh, "model")


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


def all_reduce_max_(t: torch.Tensor, mesh, axes: AxisName) -> torch.Tensor:
    for _, g, _ in _groups(mesh, axes):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
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


# torch 2.13 calls it `reduce_scatter_single` (`reduce_scatter_tensor` a
# deprecated alias that warns); torch 2.11 has only `reduce_scatter_tensor`
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reduce_scatter_sum(t: torch.Tensor, mesh, axes: AxisName, dim: int) -> torch.Tensor:
    """The sum of `t` over the ranks of `axes`, this rank's block of it
    along `dim` (the first axis major, as `local_slice` blocks)."""
    for _, g, size in _groups(mesh, axes):
        front = t.movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] // size,) + tuple(front.shape[1:]))
        _REDUCE_SCATTER(out, front, op=dist.ReduceOp.SUM, group=g)
        t = out.movedim(0, dim)
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
    """Split → whole over ranks with their own losses (or shares of one):
    the blocks gathered along `dim` (backward: the ranks' gradients summed,
    this rank's block — a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_gather_cat(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return reduce_scatter_sum(g, mesh, axes, dim).contiguous(), None, None, None


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


def move_split(t: torch.Tensor, mesh, axis: str, from_dim: int, to_dim: int) -> torch.Tensor:
    """`t`, this rank's block along `from_dim` of a tensor split over
    `axis`, resharded to this rank's block along `to_dim`, whole along
    `from_dim`: one all-to-all (`AllToAll`, so the backward is the inverse
    exchange)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    fd, td = from_dim % t.ndim, to_dim % t.ndim
    shape = tuple(t.shape)
    parts = t.reshape(shape[:td] + (n, shape[td] // n) + shape[td + 1:]).movedim(td, 0)
    recv = AllToAll.apply(parts.contiguous(), mesh, axis).movedim(0, fd)
    merged = list(recv.shape)
    merged[fd:fd + 2] = [merged[fd] * merged[fd + 1]]
    return recv.reshape(merged)


# Compute split over "model" by sequence and by feature: each rank of
# `model` holds its own share of the step's loss (its sequence block's
# tokens), so a value every rank computes whole carries only its own share
# of the gradient, and each collective's backward is its true adjoint (a
# gather of the stream is `GatherRows` over "model").

class ScatterSeq(torch.autograd.Function):
    """Partial sums (a row-parallel product's, every position) → this
    rank's block along `dim` of their sum over `model`: a reduce-scatter
    (backward: the blocks' gradients gathered)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.args = (mesh, dim)
        return reduce_scatter_sum(x, mesh, "model", dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.args
        return all_gather_cat(g, mesh, "model", dim), None, None


class ReduceModel(torch.autograd.Function):
    """Partial sums over `model` → their sum on every rank, for a stream
    that every rank of `model` holds whole (decode; a stream its ranks
    cannot split), after which they repeat one loss: backward the
    identity (with `SumGrad` on the product's input, Megatron's pair)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum_(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def exchange(send: Sequence[torch.Tensor], recv_shapes: Sequence[Tuple[int, ...]], mesh,
             axis: str) -> List[torch.Tensor]:
    """Point to point over `axis`: `send[j]` goes to rank j, and the
    result's entry s is what rank s sent here, shaped `recv_shapes[s]`.
    One `all_to_all_single` over flat buffers with uneven splits (a piece
    may be empty)."""
    if axis_size(mesh, axis) == 1:
        return [send[0].reshape(recv_shapes[0])]
    sizes = [int(np.prod(sh)) for sh in recv_shapes]
    buf = torch.cat([p.reshape(-1) for p in send])
    out = buf.new_empty((sum(sizes),))
    dist.all_to_all_single(out, buf, sizes, [p.numel() for p in send],
                           group=mesh.get_group(axis))
    return [o.view(sh) for o, sh in zip(out.split(sizes), recv_shapes)]


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo = max(a[0], b[0])
    return lo, max(lo, min(a[1], b[1]))


def _col_ranges(rg) -> Tuple[Tuple[int, int], ...]:
    """A rank's columns: one [lo, hi) range, or a sequence of them."""
    return (tuple(rg),) if isinstance(rg[0], int) else tuple(tuple(x) for x in rg)


class TakeCols(torch.autograd.Function):
    """The columns `ranges[r]` (a tuple of [lo, hi) ranges, concatenated in
    their order) of a tensor whose last dim is split over "model" in equal
    blocks, from this rank's block `t`; `ranges[j]` is what rank j takes.
    Each rank sends every peer the parts of its block that the peer takes
    (`exchange`).  Backward: each taken column's gradient goes back to its
    owner, which sums what its peers return (a column several ranks read
    gets each one's share)."""

    @staticmethod
    def forward(ctx, t, mesh, ranges):
        r, n = model_rank(mesh)
        w = t.shape[-1]
        lead = tuple(t.shape[:-1])
        owned = [(j * w, (j + 1) * w) for j in range(n)]
        send = [torch.cat([t[..., a - r * w:b - r * w]
                           for a, b in (_overlap(owned[r], rg) for rg in ranges[j])], dim=-1)
                for j in range(n)]
        # per owner s: how many of its columns each of this rank's ranges takes
        lens = [[b - a for a, b in (_overlap(owned[s], rg) for rg in ranges[r])] for s in range(n)]
        parts = exchange(send, [lead + (sum(ln),) for ln in lens], mesh, "model")
        pieces = [p.split(ln, dim=-1) for p, ln in zip(parts, lens)]
        ctx.args = (mesh, ranges, w, lead, lens)
        return torch.cat([pieces[s][i] for i in range(len(ranges[r])) for s in range(n)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        mesh, ranges, w, lead, lens = ctx.args
        r, n = model_rank(mesh)
        k = len(ranges[r])
        owned = (r * w, (r + 1) * w)
        g_pieces = g.split([lens[s][i] for i in range(k) for s in range(n)], dim=-1)
        send = [torch.cat([g_pieces[i * n + s] for i in range(k)], dim=-1) for s in range(n)]
        back = [[_overlap(owned, rg) for rg in ranges[j]] for j in range(n)]
        parts = exchange(send, [lead + (sum(b - a for a, b in bk),) for bk in back], mesh,
                         "model")
        out = g.new_zeros(lead + (w,))
        for bk, p in zip(back, parts):
            for (a, b), piece in zip(bk, p.split([b - a for a, b in bk], dim=-1)):
                if b > a:
                    out[..., a - r * w:b - r * w] += piece
        return out, None, None


# ---------------------------------------------------------------------------
# compute on shards: the params a step reads, and their gradients
# ---------------------------------------------------------------------------

def split_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The axes of `mesh` with more than one rank that `spec` splits a
    tensor over, in the mesh's order."""
    if mesh is None:
        return ()
    named = {a for ax in spec for a in as_axes(ax)}
    sizes = _sizes(mesh)
    return tuple(a for a in axis_names(mesh) if a in named and sizes[a] > 1)


def _syncs(spec: Spec, mesh, rows_split: bool, model_sum: bool = False) -> bool:
    """Whether a leaf under `spec` needs a gather, or its gradient a sum
    over the DP axes (each rank with its own rows and loss) or over
    "model" (each rank with its own share of the loss)."""
    if mesh is None:
        return False
    return bool(split_axes(spec, mesh)) or (
        rows_split and axis_size(mesh, batch_axes(mesh)) > 1) or (
        model_sum and model_rank(mesh)[1] > 1)


class GatherParam(torch.autograd.Function):
    """A param's local shard → the whole param, gathered over every axis its
    spec names.  The backward is the adjoint of the step's loss: the DP
    axes' ranks each hold their own rows and loss when `rows_split`, and the
    step takes the mean of their losses, so there the gradient is summed
    over the DP axes and divided by their size — a reduce-scatter along the
    dim a DP axis splits, an all-reduce over a DP axis that splits nothing.
    Over "model" with `model_sum` (the stream split by sequence, or compute
    that reads only its own part of the leaf) each rank holds its own share
    of the gradient, so it is summed the same way, undivided; otherwise the
    ranks of `model`, and of the DP axes when the rows are not split, repeat
    one loss, so there the gradient is this rank's block."""

    @staticmethod
    def forward(ctx, x, mesh, spec, rows_split, model_sum=False):
        ctx.args = (mesh, spec, rows_split, model_sum)
        out = x
        for dim, ax in enumerate(spec):
            if ax is not None:
                out = all_gather_cat(out, mesh, ax, dim)
        return out if out is not x else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, spec, split, model_sum = ctx.args
        dax = as_axes(batch_axes(mesh))
        split = split and axis_size(mesh, dax) > 1
        summed = (list(dax) if split else []) + (["model"] if model_sum else [])
        for dim, ax in enumerate(spec):
            if ax is not None and not set(as_axes(ax)) <= set(summed):
                g = block(g, mesh, ax, dim)
        if summed:
            spread = set()
            for dim, ax in enumerate(spec):
                if ax is not None and set(as_axes(ax)) <= set(summed):
                    g = reduce_scatter_sum(g, mesh, ax, dim)
                    spread |= set(as_axes(ax))
            rest = tuple(a for a in summed if a not in spread)
            if rest:
                g = all_reduce_sum_(g.contiguous().clone(), mesh, rest)
            if split:
                g = g / axis_size(mesh, dax)
        return g.contiguous(), None, None, None, None


def gather_param(local: torch.Tensor, spec: Spec, mesh, rows_split: bool,
                 model_sum: bool = False) -> torch.Tensor:
    """The whole param of a rank's `local` shard under `spec` (`GatherParam`),
    or `local` itself where nothing is gathered or summed."""
    if not _syncs(spec, mesh, rows_split, model_sum):
        return local
    return GatherParam.apply(local, mesh, tuple(spec), rows_split, model_sum)


class LayerShard:
    """A rank's local shard of a stacked `[L, ...]` layer leaf (or of one
    layer's slice of it), gathered only where a layer body reads it.
    `unstacked` / `layer_params` hand these out layer by layer; a layer
    body reads one layer's leaf inside its checkpointed body (under
    `blocks.remat` the backward's recompute reads it again, so no gathered
    layer lives from forward to backward): `whole()` gathers it; `block()`,
    `cols()` and `rows()` hand it out in the layout a tensor-parallel
    product over "model" computes in, gathered over the DP axes only.
    `seq`: the stream is split over "model" by sequence, so a whole read
    sums its gradient over "model".  `to(dtype)` defers a cast to after
    the gather, so the gradient is reduced in the leaf's own dtype;
    `dtype` / `ndim` are the gathered tensor's, so the cast rules read it
    as a tensor."""

    __slots__ = ("local", "spec", "mesh", "rows_split", "cast", "seq")

    def __init__(self, local: torch.Tensor, spec: Spec, mesh, rows_split: bool, cast=None,
                 seq: bool = False):
        self.local, self.spec, self.mesh = local, tuple(spec), mesh
        self.rows_split, self.cast, self.seq = rows_split, cast, seq

    @property
    def dtype(self) -> torch.dtype:
        return self.cast or self.local.dtype

    @property
    def ndim(self) -> int:
        return self.local.ndim

    @property
    def requires_grad(self) -> bool:
        return self.local.requires_grad

    def _like(self, local, spec, cast=None):
        return LayerShard(local, spec, self.mesh, self.rows_split, cast, self.seq)

    def to(self, dtype: torch.dtype) -> "LayerShard":
        return self._like(self.local, self.spec, None if dtype == self.local.dtype else dtype)

    def unbind(self, dim: int = 0) -> List["LayerShard"]:
        """One shard per entry of the leading dim (one `unbind`: the
        backward stacks their gradients once)."""
        if dim != 0:
            raise ValueError("a LayerShard unbinds its leading dim only")
        return [self._like(t, self.spec[1:], self.cast) for t in self.local.unbind(0)]

    def __getitem__(self, i: int) -> "LayerShard":
        return self._like(self.local[i], self.spec[1:], self.cast)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.cast is None else t.to(self.cast)

    def _gather(self, spec: Spec, model_sum: bool) -> torch.Tensor:
        return gather_param(self.local, spec, self.mesh, self.rows_split, model_sum=model_sum)

    def _dp_spec(self) -> Spec:
        return tuple(None if ax == "model" else ax for ax in self.spec)

    def whole(self, model_sum: Optional[bool] = None) -> torch.Tensor:
        """The gathered tensor, cast where `to` asked.  `model_sum`: whether
        each rank's gradient of it is a share to sum over "model" (default
        `seq`), as where compute split over "model" reads it whole."""
        return self._cast(self._gather(self.spec, self.seq if model_sum is None else model_sum))

    @property
    def model_split(self) -> bool:
        """Whether "model" splits the stored leaf (its last dim, by the rules)."""
        return "model" in split_axes(self.spec, self.mesh)

    def block(self) -> torch.Tensor:
        """This rank's stored block over "model", gathered over the DP axes
        only (the whole leaf where "model" does not split it); its gradient
        is this rank's alone."""
        return self._cast(self._gather(self._dp_spec(), False))

    def cols(self, ranges) -> torch.Tensor:
        """Columns `ranges[r]` of the leaf's last dim, whole in the others,
        where rank j of "model" takes `ranges[j]`: one [lo, hi) range, or
        several, concatenated in their order.  The stored block itself where
        the ranges are the storage blocks, else the block gathered over the
        DP axes and the columns exchanged over "model" (`TakeCols`; a column
        several ranks take sums their gradients); a leaf "model" does not
        split is read whole and cut (each rank's gradient a share, summed
        over "model")."""
        r, _ = model_rank(self.mesh)
        ranges = tuple(_col_ranges(rg) for rg in ranges)
        if not self.model_split:
            t = self._gather(self.spec, True)
            return self._cast(torch.cat([t[..., lo:hi] for lo, hi in ranges[r]], dim=-1))
        t = self._gather(self._dp_spec(), False)
        w = t.shape[-1]
        if any(rg != ((j * w, (j + 1) * w),) for j, rg in enumerate(ranges)):
            t = TakeCols.apply(t, self.mesh, ranges)
        return self._cast(t)

    def rows(self) -> torch.Tensor:
        """This rank's block of the second-to-last dim, whole in the last
        (a row-parallel product's input split): the stored block gathered
        over the DP axes, then one all-to-all over "model" moving the split
        from the last dim (`move_split`); a leaf "model" does not split is
        read whole and cut (each rank's gradient a share, summed)."""
        if not self.model_split:
            t = self._gather(self.spec, True)
            return self._cast(block(t, self.mesh, "model", t.ndim - 2))
        t = self._gather(self._dp_spec(), False)
        return self._cast(move_split(t, self.mesh, "model", t.ndim - 1, t.ndim - 2))


def model_split_of(leaf: Any) -> Optional[Tuple[Any, int, int, bool]]:
    """(mesh, this rank's index along "model", "model" ranks, `seq`) of a
    meshed step's layer leaf (a `LayerShard`); None without a mesh or with
    one `model` rank, where a model family computes as on one rank."""
    if not isinstance(leaf, LayerShard):
        return None
    r, n = model_rank(leaf.mesh)
    return None if n == 1 else (leaf.mesh, r, n, leaf.seq)


def read_whole(x: Any) -> Any:
    """A `LayerShard` gathered whole; anything else as it is."""
    return x.whole() if isinstance(x, LayerShard) else x


def compute_params(params: Any, specs: Specs, mesh, rows_split: bool, seq: bool = False,
                   lazy: bool = False) -> Any:
    """The params a meshed step's model code reads, from a rank's local
    shards `params` (nested dicts) laid out by `specs` ({path: spec}): each
    stacked `layers` leaf and each leaf of Zamba-2's `shared` block a
    `LayerShard` (read in the layouts its products compute in), every
    other leaf (embedding, head, norms, front-end projections) gathered
    whole (`gather_param`), once a step.  `lazy` (a step with no backward: the
    serving steps): every leaf that a gather would make whole is handed
    out as a `LayerShard`, and the model code reads it in the layout it
    computes in (`read_whole` where whole).  `seq`: the stream is split
    over "model" by sequence (`seq_splits`), so each rank's gradient of a
    whole-read leaf is its share, summed over "model".  `params` as it is
    without a mesh."""
    if mesh is None:
        return params

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = f"{path}[{k!r}]"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            else:
                spec = specs.get(p) or (None,) * v.ndim
                out[k] = (LayerShard(v, spec, mesh, rows_split, seq=seq)
                          if p.startswith(("['layers']", "['shared']"))
                          or (lazy and split_axes(spec, mesh))
                          else gather_param(v, spec, mesh, rows_split, model_sum=seq))
        return out

    return walk(params, "")


def local_specs(tree: Any) -> Tuple[Any, Specs]:
    """(the tree with each DTensor leaf's local shard, {path: spec} of its
    DTensor leaves)."""
    specs = {p: spec_of(l) for p, l in tree_mod.flatten_with_path(tree) if is_dtensor(l)}
    return tree_mod.tree_map(local, tree), specs


def global_norm(grads: Any, specs: Specs, mesh) -> torch.Tensor:
    """The global L2 norm of a tree of local gradient shards laid out by
    `specs`: each leaf's sum of squares, summed over exactly the axes it is
    split on (never over one it is replicated on), then over the leaves.
    Without a mesh, or where nothing is split, the arithmetic and order of
    `optimizer.global_norm`."""
    partial: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, g in tree_mod.flatten_with_path(grads):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        axes = split_axes(specs.get(path, ()), mesh)
        partial[axes] = sq if axes not in partial else partial[axes] + sq
    total = None
    for axes, sq in partial.items():
        if axes:
            sq = all_reduce_sum_(sq, mesh, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)
