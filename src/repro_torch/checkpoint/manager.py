"""Fault-tolerant checkpointing: atomic, async, keep-N, corruption quarantine.

The JAX package's `checkpoint/manager.py` for trees of tensors, with its
on-disk format unchanged, so a checkpoint written by either package
restores in the other:

    <dir>/step_00000100/
        manifest.json       # step, leaf paths, shapes, dtypes, sha256, config_hash
        leaf_00000.npy ...  # one file per leaf (numpy format), in the tree's order

Leaf paths are the strings `jax.tree_util.keystr` gives for the same
nesting: `.params['layers']['wq']` for a NamedTuple field and a dict key,
`[0]` for a list item; dict keys are visited sorted, as a pytree flattens
them, and `None` holds no leaf.  Guarantees, as in the reference:

  * atomicity — writes go to `tmp_step_X`, the manifest is fsync'd, then
    `os.rename` (POSIX atomic) to `step_X`; a partial tmp dir is
    garbage-collected on the next start.
  * async — `save()` copies every leaf to the host synchronously and
    writes the files on a background thread; `wait()` blocks on it.
  * keep-N — older checkpoints are removed after a successful save.
  * corruption quarantine — a checkpoint that fails to load (unreadable
    manifest, missing leaf, wrong shape, or a leaf whose sha256 over dtype,
    shape and bytes differs from the manifest's) is renamed `*.corrupt`,
    and restore falls back to the previous step.  Manifests without hashes
    restore unverified.
  * restore places each leaf on `device`, or where the target's leaf lies
    (the reference's `shardings`); a DTensor target leaf is laid out as it
    is, on its own mesh — an elastic restore onto whatever mesh the caller
    runs now.
  * a laid-out (DTensor) state saves from every rank of its process group:
    each leaf is gathered, rank 0 writes synchronously, and every rank waits
    for the write before `save` returns.

Leaves are f32, int8 or int32 tensors (every leaf a train state holds);
bfloat16 has no numpy dtype without a package the port does not need, so
it is refused.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod
from repro_torch.dist import sharding as shard_rules


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def leaf_hash(arr: np.ndarray) -> str:
    """Content hash of one checkpoint leaf: dtype, shape, raw bytes —
    computed over the array (not the file), so save-side and restore-side
    hash exactly what the training loop will consume."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def flatten_with_path(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in pytree order, with `jax.tree_util.keystr`'s
    path strings (`repro_torch.tree`)."""
    return tree_mod.flatten_with_path(tree)


def unflatten_like(tree: Any, leaves: dict) -> Any:
    """`tree`'s nesting with each leaf replaced by `leaves[path]`."""
    return tree_mod.unflatten(tree, (leaves[path] for path, _ in flatten_with_path(tree)))


def _to_host(path: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {path}: bfloat16 is not supported")
        return shard_rules.full(leaf).detach().cpu().numpy().copy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3, async_save: bool = True,
                 config_tag: str = ""):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self.config_tag = config_tag
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # ---- helpers ----
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if name.startswith("tmp_step_"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def steps(self) -> Sequence[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".corrupt"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ---- save ----
    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        flat = flatten_with_path(state)
        host = [(path, _to_host(path, leaf)) for path, leaf in flat]
        meshed = any(shard_rules.is_dtensor(leaf) for _, leaf in flat) and \
            dist.is_initialized() and dist.get_world_size() > 1

        def write():
            tmp = os.path.join(self.dir, f"tmp_step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "config_hash": self.config_tag, "leaves": []}
            for i, (path, arr) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"path": path, "file": fn, "shape": list(arr.shape),
                     "dtype": str(arr.dtype), "sha256": leaf_hash(arr)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc_old()

        if meshed:
            if dist.get_rank() == 0:
                write()
            dist.barrier()
        elif self.async_save and not blocking:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc_old(self):
        steps = self.steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----
    def restore(self, target: Any, *, step: Optional[int] = None,
                device: Any = None) -> Tuple[Optional[int], Any]:
        """Restore into the structure of `target` (a tree of tensors), each
        leaf on `device`, or where the target's leaf lies.  Falls back
        across corrupt checkpoints; (None, target) when none is valid."""
        self.wait()
        candidates = [step] if step is not None else list(reversed(self.steps()))
        for s in candidates:
            if s is None:
                continue
            d = self._step_dir(s)
            try:
                return s, self._load(d, target, device)
            except (OSError, EOFError, ValueError, KeyError, TypeError):
                os.rename(d, d + ".corrupt")
        return None, target

    def _load(self, d: str, target: Any, device: Any):
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        loaded = {}
        for path, leaf in flatten_with_path(target):
            entry = by_path[path]
            arr = np.load(os.path.join(d, entry["file"]))
            expect = tuple(leaf.shape)
            if tuple(arr.shape) != expect:
                raise ValueError(f"shape mismatch for {path}: {arr.shape} vs {expect}")
            want = entry.get("sha256")      # absent in pre-hash manifests
            if want is not None and leaf_hash(arr) != want:
                raise ValueError(f"checksum mismatch for {path}: leaf bytes corrupt on disk — "
                                 f"quarantining this checkpoint")
            if shard_rules.is_dtensor(leaf):
                loaded[path] = shard_rules.lay_out_leaf(
                    torch.from_numpy(arr.copy(order="C")).to(leaf.to_local().device),
                    shard_rules.spec_of(leaf), leaf.device_mesh)
                continue
            dev = leaf.device if device is None else torch.device(device)
            loaded[path] = torch.from_numpy(arr.copy(order="C")).to(dev)
        return unflatten_like(target, loaded)
