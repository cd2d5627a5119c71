"""The serving engine's bounded compile cache.

Only `BoundedCompileCache` of the JAX package's `serve/batching.py` is
ported so far (the bucket policy and the micro-batcher follow with the
single-host engine, ROADMAP A7).  The class is copied as it is: an LRU over
built callables with hit / miss / eviction counters, so tests can pin how
many step programs a serving scenario builds.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Hashable


class BoundedCompileCache:
    """LRU cache over compiled callables with hit/miss/eviction counters.

    Replaces the ad-hoc `functools.lru_cache` serving used to keep per
    (model, mesh, layout) jits in: same O(1) lookup, but eviction actually
    drops the jitted closure (and with it the mesh / executable), and the
    counters let tests pin the compile count of a serving scenario.
    """

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._d: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.races = 0      # guarded-by: _lock (lost build races, discarded)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._d

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
        # build outside the lock (jit tracing can be slow / re-entrant)
        fn = build()
        with self._lock:
            if key not in self._d:
                self.misses += 1
                self._d[key] = fn
                while len(self._d) > self.maxsize:
                    self._d.popitem(last=False)
                    self.evictions += 1
            else:
                # another thread built the same key first: our compile work
                # was real, so this is a MISS (misses == programs actually
                # built), tracked as a race — booking it a hit would make
                # compile-count assertions blind to duplicated trace work
                self.misses += 1
                self.races += 1
            self._d.move_to_end(key)
            return self._d[key]

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    @property
    def compiles(self) -> int:
        """Programs built through this cache (== misses)."""
        return self.misses

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._d), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "races": self.races}
