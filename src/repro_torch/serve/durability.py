"""Durable fleet persistence: content addressing, a checksummed WAL and
compacted snapshots.

Each host's replicated state is made crash-safe by three pieces, composed
by `DurableStore` and wired into `ReplicatedRegistry(data_dir=...)`:

  * **`WriteAheadLog`** — an append-only file of length-prefixed,
    CRC32-checksummed records.  Every committed registry mutation (and
    every election term bump / vote grant, and every fleet-merge carry) is
    one record, fsync'd before the caller proceeds — so an op acked to the
    fleet is an op on disk.  On open the log is scanned front to back; the
    first torn or corrupt record (truncated frame, CRC mismatch, impossible
    length — the tail a `kill -9` mid-append leaves behind) ends the valid
    prefix, and the file is physically truncated there.
  * **`BlobStore`** — content-addressed state payloads keyed by
    `state_hash`: `blobs/<hash>.bin`, written tmp + fsync + rename, stored
    once however many versions, hosts or snapshots refer to them.
    `get(verify=True)` re-hashes what it loaded, so a silently corrupted
    blob raises instead of serving wrong bytes.
  * **Snapshots + compaction** — `DurableStore.compact()` folds the op log
    into `snapshots/snap_<k>/` (pickled per-name op lists + election
    metadata + carries, sha256-checksummed, tmp-dir + fsync + rename), then
    truncates the WAL and drops the blobs no retained op refers to.

Recovery (`DurableStore.recover()`) is snapshot ∘ WAL: the newest intact
snapshot (a corrupt one is quarantined `*.corrupt` and the one before is
tried), then the WAL suffix folded over it record by record.

What lands on disk is a host copy (`host_state`): the port's own classes
(`ModelState`, `replication.Op`) with CPU-tensor or numpy leaves, pickled.
A data directory written by the JAX package holds that package's classes,
so the port does not read one (nor the JAX package the port's); the hashes
agree on equal bytes all the same.

Content addressing: `state_hash` walks a state in the order and with the
key strings of JAX's `tree_flatten_with_path` over the reference's
`ModelState` (`repro_torch.tree`): `.stages[0]`, `.stages[1]`, …, `.steps`.
Each leaf contributes its key string, its numpy dtype string (`bfloat16`
included), `repr` of its shape (a scalar's is `(1,)`, as
`numpy.ascontiguousarray` leaves it) and its bytes, so a port state and a
reference state holding the same bytes hash the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_mod

PyTree = Any

# one WAL record frame: payload length + CRC32 of the payload, then the
# pickled payload itself.  Big-endian, fixed width — a partial header is
# detectably torn by length alone.
_FRAME = struct.Struct(">II")
# a length beyond this is garbage, not a record (a torn header whose
# bytes happen to parse): treat it as corruption, not an allocation.
_MAX_RECORD = 1 << 30


class CorruptBlobError(RuntimeError):
    """A content-addressed blob's bytes no longer match its hash."""


# ---------------------------------------------------------------------------
# content addressing
# ---------------------------------------------------------------------------

def _host_leaf(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def host_state(state: PyTree) -> PyTree:
    """Device → host copy of a state (CPU tensor leaves, never sharing
    memory with the source): what persistence and replication handle."""
    return tree_mod.tree_map(_host_leaf, state)


def state_hash(state: PyTree) -> str:
    """Content address of a state: key paths, dtypes, shapes, bytes.
    Stable across processes, and across torch and numpy leaves."""
    h = hashlib.sha256()
    for path, leaf in tree_mod.flatten_with_path(state):
        dtype, a = _host_array(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _host_array(leaf: Any) -> Tuple[str, np.ndarray]:
    """(numpy dtype string, host array holding the leaf's bytes), through
    `numpy.ascontiguousarray` as the reference does — which gives a scalar
    the shape (1,)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", np.ascontiguousarray(t.view(torch.int16).numpy())
        a = np.ascontiguousarray(t.numpy())
        return str(a.dtype), a
    a = np.ascontiguousarray(np.asarray(leaf))
    return str(a.dtype), a


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss —
    best effort (not every filesystem supports O_DIRECTORY opens)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

class WriteAheadLog:
    """Append-only, checksummed, length-prefixed record log.

    `append(record)` pickles the record, frames it with (length, CRC32),
    writes, flushes, and (by default) fsyncs — when it returns, the
    record is committed.  Opening the log recovers the valid committed
    prefix: scanning stops at the first torn frame (partial header or
    payload), CRC mismatch, unpicklable payload, or impossible length,
    and the file is truncated to the end of the last valid record — a
    `kill -9` mid-append or an injected torn tail costs at most the one
    record that never finished, never anything before it.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()  # coarse-lock: append+fsync serialize so ack order == durable order
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.records: List[Any] = self._recover()  # guarded-by: _lock
        self._f = open(path, "ab")  # guarded-by: _lock

    def _recover(self) -> List[Any]:
        """Parse the committed prefix; physically truncate anything after
        it (a torn tail must not poison the next append)."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            blob = f.read()
        records: List[Any] = []
        off = 0
        while True:
            if off + _FRAME.size > len(blob):
                break                               # torn/absent header
            length, crc = _FRAME.unpack_from(blob, off)
            start, end = off + _FRAME.size, off + _FRAME.size + length
            if length > _MAX_RECORD or end > len(blob):
                break                               # impossible or torn body
            payload = blob[start:end]
            if zlib.crc32(payload) != crc:
                break                               # corrupt record
            try:
                records.append(pickle.loads(payload))
            except Exception:                       # noqa: BLE001 — corrupt
                break
            off = end
        if off < len(blob):
            with open(self.path, "r+b") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
        return records

    def append(self, record: Any) -> None:
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            self._f.write(frame)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self.records.append(record)

    def truncate(self) -> None:
        """Reset to an empty log (compaction folded the prefix away)."""
        with self._lock:
            self._f.close()
            self._f = open(self.path, "wb")
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = open(self.path, "ab")
            self.records = []

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# content-addressed blob store
# ---------------------------------------------------------------------------

class BlobStore:
    """State payloads keyed by `state_hash`: `<dir>/<hash>.bin`, each
    written tmp + fsync + rename so a crash never leaves a half-written
    blob under a final name.  Identical states are stored once — `put`
    of a hash already present is a no-op, which is what makes a snapshot
    "a manifest + blob refs" instead of a copy of every version."""

    def __init__(self, directory: str, *, fsync: bool = True):
        self.dir = directory
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    def _path(self, h: str) -> str:
        return os.path.join(self.dir, f"{h}.bin")

    def _gc_tmp(self) -> None:
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    def __contains__(self, h: str) -> bool:
        return os.path.exists(self._path(h))

    def hashes(self) -> Tuple[str, ...]:
        return tuple(sorted(n[:-4] for n in os.listdir(self.dir)
                            if n.endswith(".bin")))

    def put(self, h: str, state: PyTree) -> bool:
        """Store `state` under `h`; returns False if already present
        (dedup — the common case for replayed and re-promoted states)."""
        final = self._path(h)
        if os.path.exists(final):
            return False
        tmp = os.path.join(self.dir, f".tmp-{h}-{os.getpid()}")
        with open(tmp, "wb") as f:
            pickle.dump(host_state(state), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.rename(tmp, final)
        if self.fsync:
            _fsync_dir(self.dir)
        return True

    def get(self, h: str, *, verify: bool = True) -> PyTree:
        """Load the state stored under `h`.  Raises KeyError if absent;
        `CorruptBlobError` if the loaded bytes no longer hash to `h`
        (verify=True) — content addressing makes silent corruption
        detectable, so detect it."""
        path = self._path(h)
        if not os.path.exists(path):
            raise KeyError(f"no blob {h}")
        try:
            with open(path, "rb") as f:
                state = pickle.load(f)
        except Exception as e:                      # noqa: BLE001
            raise CorruptBlobError(f"blob {h} unreadable: {e!r}") from e
        if verify and state_hash(state) != h:
            raise CorruptBlobError(
                f"blob {h} content hashes to {state_hash(state)} — "
                f"corrupt on disk")
        return state

    def gc(self, live: set) -> int:
        """Remove every blob whose hash is not in `live`; returns the
        number removed.  Called by compaction with the set of hashes the
        retained op history still references."""
        removed = 0
        for h in self.hashes():
            if h not in live:
                try:
                    os.remove(self._path(h))
                    removed += 1
                except OSError:
                    pass
        return removed


# ---------------------------------------------------------------------------
# snapshots + the composed store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveredState:
    """What `DurableStore.recover()` hands the registry: per-name ordered
    op lists (payloads live in the blob store), election metadata, and
    the per-name fleet-merge error-feedback residuals (last write wins —
    a residual record fully supersedes the previous one for its name)."""
    ops: Dict[str, List[Any]]
    term: int
    voted: Dict[int, str]                           # term -> candidate
    residuals: Dict[str, Any] = dataclasses.field(  # name -> ef pytree
        default_factory=dict)


class DurableStore:
    """WAL + blob store + compacted snapshots for one host's registry.

    Record kinds in the WAL (each a `(kind, payload)` tuple):
        ("op", Op)            — a committed registry mutation
        ("reset", name)       — anti-entropy rewound this name's log
        ("term", t)           — the election term advanced to t
        ("vote", (t, host))   — this host granted its term-t vote to host
        ("residual", (name, ef)) — this host's fleet-merge error-feedback
                              tree after a collect, fsync'd BEFORE the
                              sketch is acked to the leader (a crash
                              between WAL and ack re-folds idempotently)

    `compact(dump)` folds everything into `snapshots/snap_<k>/`:
        state.pkl         — pickled {"ops": .., "term": .., "voted": ..}
        manifest.json     — snapshot id, sha256 of state.pkl, blob refs
    written into a tmp dir, fsync'd, then os.rename'd (atomic, the
    `repro_torch.checkpoint.manager` discipline) — a crash mid-compact leaves
    the previous snapshot intact and the WAL untouched.  Only after the
    rename is the WAL truncated and the blob store GC'd, so recovery at
    ANY intermediate point sees a consistent (snapshot, WAL) pair; a
    duplicate op replayed from a pre-truncate WAL is folded idempotently
    by seq.
    """

    def __init__(self, data_dir: str, *, fsync: bool = True,
                 compact_every: int = 256, keep_snapshots: int = 2):
        if compact_every < 1:
            raise ValueError("compact_every must be >= 1")
        self.dir = data_dir
        self.fsync = fsync
        self.compact_every = compact_every
        self.keep_snapshots = keep_snapshots
        os.makedirs(data_dir, exist_ok=True)
        self.snap_dir = os.path.join(data_dir, "snapshots")
        os.makedirs(self.snap_dir, exist_ok=True)
        self._gc_tmp_snaps()
        self.blobs = BlobStore(os.path.join(data_dir, "blobs"), fsync=fsync)
        self.wal = WriteAheadLog(os.path.join(data_dir, "wal.log"),
                                 fsync=fsync)
        self._appends = len(self.wal.records)
        self.compactions = 0

    # ---- logging ----------------------------------------------------------
    def _log(self, kind: str, payload: Any) -> None:
        self.wal.append((kind, payload))
        self._appends += 1

    def log_op(self, op: Any) -> None:
        self._log("op", op)

    def log_reset(self, name: str) -> None:
        self._log("reset", name)

    def log_term(self, term: int) -> None:
        self._log("term", int(term))

    def log_vote(self, term: int, candidate: str) -> None:
        self._log("vote", (int(term), candidate))

    def log_residual(self, name: str, ef: PyTree) -> None:
        """Persist a fleet-merge error-feedback tree (host leaves — call
        `host_state` first).  Residuals ride the WAL inline rather than
        the blob store: they are per-name last-write-wins, so compaction
        keeps only the newest and blob GC never has to reason about them."""
        self._log("residual", (name, ef))

    def should_compact(self) -> bool:
        return self._appends >= self.compact_every

    # ---- recovery ---------------------------------------------------------
    def recover(self) -> RecoveredState:
        """Newest intact snapshot folded with the WAL suffix."""
        snap = self._load_snapshot()
        ops: Dict[str, List[Any]] = {} if snap is None else \
            {n: list(lst) for n, lst in snap["ops"].items()}
        term = 0 if snap is None else int(snap["term"])
        voted: Dict[int, str] = {} if snap is None else dict(snap["voted"])
        residuals: Dict[str, Any] = {} if snap is None else \
            dict(snap.get("residuals", {}))
        dead: set = set()               # names with a seq gap: unrecoverable
        for kind, payload in self.wal.records:
            if kind == "op":
                name = payload.name
                if name in dead:
                    continue
                lst = ops.setdefault(name, [])
                if lst and payload.seq <= lst[-1].seq:
                    continue            # pre-truncate WAL replay: idempotent
                if payload.seq != (lst[-1].seq + 1 if lst else 0):
                    dead.add(name)      # gap — drop the name's suffix;
                    continue            # anti-entropy re-pulls it on join
            elif kind == "reset":
                ops.pop(payload, None)
                dead.discard(payload)
                continue
            elif kind == "term":
                term = max(term, int(payload))
                continue
            elif kind == "vote":
                t, cand = payload
                voted[int(t)] = cand
                term = max(term, int(t))
                continue
            elif kind == "residual":
                rname, ef = payload
                residuals[rname] = ef   # last write wins per name
                continue
            else:
                continue                # unknown kind: forward-compat skip
            ops.setdefault(payload.name, []).append(payload)
        return RecoveredState(ops=ops, term=term, voted=voted,
                              residuals=residuals)

    # ---- snapshots / compaction -------------------------------------------
    def _snap_ids(self) -> List[int]:
        out = []
        for name in os.listdir(self.snap_dir):
            if name.startswith("snap_") and not name.endswith(".corrupt"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def _snap_path(self, sid: int) -> str:
        return os.path.join(self.snap_dir, f"snap_{sid:08d}")

    def _gc_tmp_snaps(self) -> None:
        for name in os.listdir(self.snap_dir):
            if name.startswith("tmp_snap_"):
                shutil.rmtree(os.path.join(self.snap_dir, name),
                              ignore_errors=True)

    def _load_snapshot(self) -> Optional[Dict[str, Any]]:
        """Newest snapshot whose manifest checks out; corrupt ones are
        quarantined `*.corrupt` and the previous snapshot is tried."""
        for sid in reversed(self._snap_ids()):
            d = self._snap_path(sid)
            try:
                with open(os.path.join(d, "manifest.json")) as f:
                    manifest = json.load(f)
                with open(os.path.join(d, "state.pkl"), "rb") as f:
                    blob = f.read()
                if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
                    raise ValueError("state.pkl sha256 mismatch")
                return pickle.loads(blob)
            except Exception:                       # noqa: BLE001
                try:
                    os.rename(d, d + ".corrupt")
                except OSError:
                    pass
        return None

    def compact(self, dump: Dict[str, Any]) -> None:
        """Fold `dump` ({"ops": per-name op lists, "term": int,
        "voted": {term: host}, "residuals": {name: ef}}) into a fresh
        snapshot, truncate the WAL, GC unreferenced blobs and stale
        snapshots."""
        sid = (self._snap_ids()[-1] + 1) if self._snap_ids() else 0
        blob = pickle.dumps(
            {"ops": dump["ops"], "term": int(dump["term"]),
             "voted": dict(dump["voted"]),
             "residuals": dict(dump.get("residuals", {}))},
            protocol=pickle.HIGHEST_PROTOCOL)
        live = {op.state_hash for lst in dump["ops"].values() for op in lst
                if op.state_hash is not None}
        tmp = os.path.join(self.snap_dir, f"tmp_snap_{sid:08d}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"snapshot": sid,
                    "sha256": hashlib.sha256(blob).hexdigest(),
                    "n_names": len(dump["ops"]),
                    "n_ops": sum(len(l) for l in dump["ops"].values()),
                    "blobs": sorted(live)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self._snap_path(sid))
        if self.fsync:
            _fsync_dir(self.snap_dir)
        # the snapshot is durable — now (and only now) fold the WAL away
        self.wal.truncate()
        self._appends = 0
        for old in self._snap_ids()[: -self.keep_snapshots]:
            shutil.rmtree(self._snap_path(old), ignore_errors=True)
        self.blobs.gc(live)
        self.compactions += 1

    # ---- introspection ----------------------------------------------------
    def size_bytes(self) -> int:
        """Total on-disk footprint (WAL + blobs + snapshots)."""
        total = 0
        for root, _, files in os.walk(self.dir):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
        return total

    def stats(self) -> Dict[str, Any]:
        return {"wal_bytes": self.wal.size_bytes(),
                "wal_records": len(self.wal.records),
                "blobs": len(self.blobs.hashes()),
                "snapshots": self._snap_ids(),
                "compactions": self.compactions,
                "total_bytes": self.size_bytes()}

    def close(self) -> None:
        self.wal.close()
