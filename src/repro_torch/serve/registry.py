"""Model registry: named models with versioned, hot-swappable state.

One `DRService` owns one registry.  Each entry is a `DRModel` (or its
k-member ensemble) plus an append-only list of state versions with a
`live` pointer:

    v = reg.register("waveform", model, state)      # v0, live
    v = reg.push("waveform", retrained_state)       # v1, NOT live yet
    reg.promote("waveform")                         # v1 goes live atomically
    reg.rollback("waveform")                        # back to v0

Entries are keyed by name for routing and by `config_hash(model)` for
identity: re-registering a name with a *different* model config is an
error unless `replace=True` (a silently swapped architecture under a live
name is how serving fleets eat mis-shaped traffic).  `get()` returns one
consistent `(model, state, version)` snapshot under the lock, so a
concurrent promote can never hand a caller a torn pair.

This registry is single-host.  The JAX package's replicated registry,
which wraps one of these per host and replicates mutations fleet-wide, is
not ported yet (ROADMAP A8); `DRService(registry=...)` takes anything with
this surface.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint import config_hash

PyTree = Any


def model_config_hash(model: Any) -> str:
    """Registry identity of a model config — the `Execution` policy is
    folded in EXPLICITLY, not just via the model's repr.  Serving identity
    must distinguish "same stages, torch backend" from "same stages, kernel
    backend" (they build different programs), and the same stages on
    device="cpu" from device="cuda" (a plain callable against a captured
    CUDA graph), even for model types whose repr omits their execution
    attribute — otherwise a kernel re-register dedupes onto the torch
    entry and the service silently serves plain torch."""
    return config_hash((model, getattr(model, "execution", None)))


@dataclasses.dataclass
class _Entry:
    model: Any                      # a DRModel
    chash: str
    versions: List[PyTree]          # append-only state history
    live: int                       # index into versions
    prev_live: Optional[int] = None # for rollback
    ensemble: Optional[int] = None  # k if serving an ensemble state


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One consistent view of a live entry."""
    name: str
    model: Any
    state: PyTree
    version: int
    chash: str
    ensemble: Optional[int]


class ModelRegistry:
    def __init__(self):
        self._entries: Dict[str, _Entry] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    # ---- listing -----------------------------------------------------------
    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def n_versions(self, name: str) -> int:
        with self._lock:
            return len(self._entry(name).versions)

    def live_version(self, name: str) -> int:
        """The version id `get()` would serve right now (fleet probes read
        this to compare epochs across replicated hosts)."""
        with self._lock:
            return self._entry(name).live

    # ---- lifecycle ---------------------------------------------------------
    def register(self, name: str, model: Any, state: PyTree, *,
                 ensemble: Optional[int] = None, replace: bool = False) -> int:
        """Add `name` with `state` as version 0 (live).  Registering an
        existing name requires the same config hash unless `replace=True`."""
        chash = model_config_hash(model)
        with self._lock:
            old = self._entries.get(name)
            if old is not None and old.chash != chash and not replace:
                raise ValueError(
                    f"model {name!r} already registered with config "
                    f"{old.chash}; refusing {chash} without replace=True")
            self._entries[name] = _Entry(model=model, chash=chash,
                                         versions=[state], live=0,
                                         ensemble=ensemble)
            return 0

    def push(self, name: str, state: PyTree) -> int:
        """Append a new state version WITHOUT making it live; returns its id."""
        with self._lock:
            e = self._entry(name)
            e.versions.append(state)
            return len(e.versions) - 1

    def promote(self, name: str, version: Optional[int] = None) -> int:
        """Atomically point live at `version` (default: newest)."""
        with self._lock:
            e = self._entry(name)
            v = len(e.versions) - 1 if version is None else version
            if not 0 <= v < len(e.versions):
                raise IndexError(f"{name!r} has no version {v}")
            if v != e.live:
                e.prev_live, e.live = e.live, v
            return v

    def rollback(self, name: str) -> int:
        """Revert live to the version it pointed at before the last promote."""
        with self._lock:
            e = self._entry(name)
            if e.prev_live is None:
                raise RuntimeError(f"{name!r} has no previous live version")
            e.live, e.prev_live = e.prev_live, e.live
            return e.live

    def remove(self, name: str) -> None:
        """Drop an entry outright (no-op if absent).  Replication's
        anti-entropy uses this to evict a phantom name a deposed leader
        registered while partitioned — an entry no other host has."""
        with self._lock:
            self._entries.pop(name, None)

    def adopt(self, name: str, other: "ModelRegistry") -> None:
        """Atomically install `name`'s entry from another registry.
        Anti-entropy's reset-replay rebuilds a diverged name in a scratch
        registry off to the side and adopts the result in one step, so a
        concurrent reader never observes a partially-replayed entry (e.g.
        the live pointer rewound to version 0 mid-replay)."""
        with other._lock:
            entry = other._entries[name]
        with self._lock:
            self._entries[name] = entry

    # ---- reads -------------------------------------------------------------
    def get(self, name: str) -> Snapshot:
        with self._lock:
            e = self._entry(name)
            return Snapshot(name=name, model=e.model, state=e.versions[e.live],
                            version=e.live, chash=e.chash, ensemble=e.ensemble)

    def state(self, name: str, version: int) -> PyTree:
        with self._lock:
            return self._entry(name).versions[version]

    def _entry(self, name: str) -> _Entry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"no model registered as {name!r}; "
                           f"have {sorted(self._entries)}") from None
