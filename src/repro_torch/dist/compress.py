"""Ternary random-projection sketches of state deltas, for fleet merges.

A serving fleet (`repro_torch.serve.fleet_merge`) has no collective: hosts
ship their staged-state deltas to the leader over the replication
transport.  Each host sketches its delta (plus its error-feedback carry)
with a shared sparse ternary R (p × c, P[±1] = 1/(2s), s = p), the leader
sums the sketches and decodes once:

    host i:   y_i = (d_i + e_i) Rᵀ         sketch + error-feedback carry-in
              e_i' = (d_i + e_i) − P(d_i + e_i)   residual stays LOCAL
    leader:   Σ d̂ = P-decode(Σ y_i)        one least-squares decode; R is
                                           shared per (seed, salt, leaf), so
                                           sketches sum coherently

where P = Rᵀ(RRᵀ)⁻¹R is the orthogonal projection onto rowspace(R).  The
decode is the projection, not the unbiased (s/p)·yR back-projection: under
error feedback the residual is re-compressed every round, and the unbiased
decode's variance (≈ ratio·‖v‖²) makes that iteration diverge.  The
projection gives ‖v − Pv‖ ≤ ‖v‖, and a fresh R per round (the `salt`; all
parties of a round must agree on it) removes the residual's component in a
new random p-dim subspace each time: E‖e'‖² = (1 − 1/ratio)·‖e‖², so K
merge rounds converge to the uncompressed merge.

Deltas from disjoint traffic shards SUM (they are independent first-order
contributions against the same promoted base), so the leader adds
sketches.  Small leaves, integer leaves (the int8 ternary RP stage, the
int32 step counter) and `ratio == 1` ride the raw path — bit-exact, no
residual.  An all-zero contribution (a static stage whose delta never
moves) ships a "zero" marker instead of its bytes.

What the port does its own way:

  * R's draw.  torch cannot draw JAX's threefry, so R comes from one fixed
    rule: `numpy.random.SeedSequence([seed, salt & 0x7FFFFFFF, leaf])`
    seeds a CPU `torch.Generator`, R is drawn on the CPU and then moved to
    the device.  Every host, on the CPU or on a card, draws the same R.
    The density is the reference's.
  * The sketch runs on the kernel built for the paper's RP: y = chunks Rᵀ
    is `ternary_matmul` (B3) with R held as int8 — on the card the CUDA
    kernel, on the CPU its plain version.  `backend="torch"` takes the
    plain product on any device (a torch-backend fleet's reference).
  * The decode is plain torch in f32: y (RRᵀ + 1e-6 I)⁻¹ R, a p × p solve.
  * Bundles hold CPU tensors (host copies): they cross the transport and
    land in the WAL.

`compress_sync`, the in-collective gradient sync of the mesh path, is not
ported yet (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ternary_matmul_ref

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    ratio: int = 4          # sketch compression factor c → c/ratio
    chunk: int = 4096       # flatten leaves into chunks of this many floats
    min_size: int = 1024    # leaves with fewer elements ship uncompressed
    seed: int = 0           # base seed for the shared R draws

    def __post_init__(self):
        if self.ratio < 1:
            raise ValueError(f"ratio must be >= 1, got {self.ratio}")
        if self.chunk < self.ratio:
            raise ValueError(f"chunk must be >= ratio, got {self.chunk}")


def _merge_key(cfg: CompressConfig, salt: int, leaf: int) -> Tuple[int, int, int]:
    """R's key for merge-round sketches: (seed, salt, leaf index).  The
    salt varies per round so repeated rounds project residuals onto fresh
    subspaces (a fixed R cannot contract)."""
    return (int(cfg.seed), int(salt) & 0x7FFFFFFF, int(leaf))


def _rp_matrix(key: Tuple[int, ...], p: int, c: int, s: int) -> torch.Tensor:
    """Sparse ternary R (p, c) as int8 on the CPU, entries {−1, 0, +1},
    P[+1] = P[−1] = 1/(2s), drawn from a CPU generator seeded by
    `SeedSequence(key)`: the same R on every host and every device."""
    words = np.random.SeedSequence(list(key)).generate_state(2, np.uint32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(words[0]) << 32 | int(words[1]))
    u = torch.rand((p, c), generator=gen, dtype=torch.float32)
    half = 1.0 / (2.0 * s)
    r = torch.zeros((p, c), dtype=torch.int8)
    r[u < 2.0 * half] = -1
    r[u < half] = 1
    return r


def _chunk_dims(size: int, cfg: CompressConfig) -> Tuple[int, int, int]:
    """(chunk_len, n_chunks, sketch_dim) for a flat leaf of `size` elements."""
    c = min(cfg.chunk, size)
    n_chunks = -(-size // c)  # ceil
    p = max(1, c // cfg.ratio)
    return c, n_chunks, p


def _sketch(chunks: torch.Tensor, r_int8: torch.Tensor, backend: str) -> torch.Tensor:
    """y (n_chunks, p) = chunks Rᵀ in f32: B3 (`ternary_matmul`) under the
    kernel backend, the plain product under the torch backend."""
    if backend == "kernel":
        return ops.ternary_matmul(chunks, r_int8)
    return ternary_matmul_ref(chunks, r_int8)


def _ls_decode(y: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Least-squares decode of sketch rows: y (RRᵀ)⁻¹ R — the orthogonal
    projection of the sketched chunks onto rowspace(R).  ‖v − Pv‖ ≤ ‖v‖
    always, which is what makes per-round error feedback a contraction."""
    r = r.to(torch.float32)
    g = r @ r.T
    # ternary R rows have ≈ c/ratio nonzeros; the tiny ridge only matters
    # when a row draws all-zero (possible at small p), keeping G invertible
    g = g + 1e-6 * torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return y @ torch.linalg.solve(g, r)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def residual_init(state_like: PyTree) -> PyTree:
    """A zero error-feedback tree mirroring `state_like` — one per host
    per model name, threaded through `delta_sketch` calls and persisted
    via the replication WAL between merge rounds."""
    return tree_mod.tree_map(torch.zeros_like, state_like)


def residual_nonzero(ef: PyTree) -> bool:
    """Does this error-feedback tree carry any signal worth flushing?"""
    return any(bool(torch.any(torch.as_tensor(leaf) != 0)) for leaf in tree_mod.leaves(ef))


def delta_sketch(delta: PyTree, ef: PyTree, cfg: CompressConfig, salt: int = 0, *,
                 backend: str = "kernel") -> Tuple[Dict[str, Any], PyTree]:
    """Compress one host's staged-state delta for a fleet merge round.

    Returns `(bundle, new_ef)`.  The bundle is a picklable dict of per-leaf
    entries in tree order — `("zero", None)` for an all-zero contribution,
    `("raw", tensor)` for exact small / integer / ratio-1 leaves (their
    residual flushes to zero), `("sketch", tensor)` for ternary-RP sketched
    leaves (residual = what the projection decode of the host's own sketch
    missed, carried into the next round); every tensor in it is a host
    copy.  `salt` keys this round's R draw and must match the
    `merge_deltas` call that decodes the bundle.  `new_ef` lies where
    `delta` does."""
    flat_d = tree_mod.leaves(delta)
    flat_e = tree_mod.leaves(ef)
    if len(flat_e) != len(flat_d):
        raise ValueError("error-feedback tree must mirror the delta tree")
    entries: List[Tuple[str, Any]] = []
    out_e = []
    for i, (d, e) in enumerate(zip(flat_d, flat_e)):
        exact = (cfg.ratio == 1 or d.numel() < max(1, cfg.min_size)
                 or not d.dtype.is_floating_point)
        if exact:
            v = d + e
            out_e.append(torch.zeros_like(e))
            entries.append(("raw", _host(v)) if bool(torch.any(v != 0)) else ("zero", None))
            continue
        v = (d + e).to(torch.float32)
        if not bool(torch.any(v != 0)):
            entries.append(("zero", None))
            out_e.append(torch.zeros_like(e))
            continue
        c, n_chunks, p = _chunk_dims(d.numel(), cfg)
        flat = v.reshape(-1)
        pad = n_chunks * c - flat.numel()
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        chunks = flat.reshape(n_chunks, c)
        # the SAME (seed, salt, leaf index) keying on every host and the
        # leader: all parties of a round regenerate an identical R, so
        # sketches from different hosts add coherently and decode with
        # one projection
        r = _rp_matrix(_merge_key(cfg, salt, i), p, c, p).to(v.device)
        y = _sketch(chunks, r, backend)                 # (n_chunks, p)
        est = _ls_decode(y, r).reshape(-1)[:d.numel()].reshape(d.shape)
        entries.append(("sketch", _host(y)))
        out_e.append((v.reshape(d.shape) - est).to(e.dtype))
    return ({"leaves": entries, "salt": int(salt)}, tree_mod.unflatten(ef, out_e))


def merge_deltas(base: PyTree, bundles: Sequence[Dict[str, Any]],
                 cfg: CompressConfig, salt: int = 0) -> PyTree:
    """Leader-side all-reduce: decode and SUM per-host delta bundles into
    one delta tree shaped, typed and placed like `base`.  Sketched leaves
    sum in sketch space first — one projection decode total, and the same
    as decoding each then adding (the decode is linear).  Every bundle must
    have been sketched with this round's `salt`."""
    flat_b = tree_mod.leaves(base)
    for bundle in bundles:
        if len(bundle["leaves"]) != len(flat_b):
            raise ValueError(
                f"delta bundle has {len(bundle['leaves'])} leaves; the base "
                f"state has {len(flat_b)} — mismatched model structure")
        if int(bundle.get("salt", salt)) != int(salt):
            raise ValueError(
                f"delta bundle sketched with salt {bundle['salt']}, round "
                f"decodes with salt {salt} — mixed rounds cannot merge")
    out = []
    for i, b in enumerate(flat_b):
        raw_sum = None
        y_sum = None
        for bundle in bundles:
            kind, arr = bundle["leaves"][i]
            if kind == "zero":
                continue
            if kind == "raw":
                raw_sum = arr if raw_sum is None else raw_sum + arr
            elif kind == "sketch":
                y_sum = arr if y_sum is None else y_sum + arr
            else:
                raise ValueError(f"unknown bundle entry kind {kind!r}")
        floating = b.dtype.is_floating_point
        merged = torch.zeros(b.shape, device=b.device,
                             dtype=torch.promote_types(b.dtype, torch.float32) if floating
                             else b.dtype)
        if raw_sum is not None:
            merged = merged + raw_sum.to(b.device).reshape(b.shape)
        if y_sum is not None:
            c, n_chunks, p = _chunk_dims(b.numel(), cfg)
            r = _rp_matrix(_merge_key(cfg, salt, i), p, c, p).to(b.device)
            est = _ls_decode(y_sum.to(b.device), r).reshape(-1)[:b.numel()]
            merged = merged + est.reshape(b.shape)
        out.append(merged.to(b.dtype))
    return tree_mod.unflatten(base, out)


def apply_delta(base: PyTree, delta: PyTree) -> PyTree:
    """`base + delta`, leaf-wise, preserving base leaf dtypes — how a
    merged delta becomes the next promoted state."""
    return tree_mod.tree_map(lambda b, d: (b + d).to(b.dtype), base, delta)


def _nbytes(arr: Any) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def bundle_bytes(bundle: Dict[str, Any]) -> int:
    """Bytes on the wire of one host's delta bundle (zero markers are free;
    raw and sketch entries cost their array bytes)."""
    return sum(_nbytes(arr) for _, arr in bundle["leaves"] if arr is not None)


def tree_bytes(tree: PyTree) -> int:
    """Uncompressed byte size of a tree's leaves (the 1x wire cost)."""
    return int(sum(_nbytes(leaf) for leaf in tree_mod.leaves(tree)))


def collective_bytes_saved(grads: PyTree, cfg: CompressConfig) -> Dict[str, float]:
    """Accounting: bytes on the wire with vs without the sketch."""
    orig = comp = 0.0
    n_skipped = 0
    for leaf in tree_mod.leaves(grads):
        b = _nbytes(leaf)
        orig += b
        if leaf.numel() < max(1, cfg.min_size):
            comp += b
            n_skipped += 1
        else:
            c, n_chunks, p = _chunk_dims(leaf.numel(), cfg)
            comp += n_chunks * p * leaf.element_size()
    return {"orig_bytes": orig, "compressed_bytes": comp,
            "ratio": orig / max(comp, 1.0), "skipped_leaves": n_skipped}


def compress_sync(grads: PyTree, ef: PyTree, cfg: CompressConfig, axes) -> Tuple[PyTree, PyTree]:
    """The in-collective gradient sync of the mesh path."""
    raise NotImplementedError(
        "compress_sync (the sketch-synced gradients of a data-parallel mesh) is not "
        "ported yet (ROADMAP A10); the fleet merge's delta_sketch / merge_deltas are")
