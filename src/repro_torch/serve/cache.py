"""Thread-safe LRU result cache for the serving engine.

Keys are built by the engine from ``(query bytes, k, index fingerprint,
effective operating point)`` — see
:meth:`repro_torch.serve.engine.SearchEngine._cache_key`. A hot index swap
invalidates implicitly (new fingerprint), and so does a knob change
(``set_operating_point`` / a new ``target_recall`` mapping): the resolved
``SearchParams`` and escalation policy are part of the key, so an answer
computed under one operating point can never be replayed under another.
Old entries stay in the map until evicted but can never match a lookup
made under the new key. Hit/miss counters feed ``engine.stats()``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional


class LRUCache:
    """Bounded mapping with least-recently-used eviction.

    ``maxsize=0`` disables caching entirely (every ``get`` is a miss,
    ``put`` is a no-op) — the serving engine exposes that as
    ``cache_size=0``.
    """

    def __init__(self, maxsize: int = 1024):
        if maxsize < 0:
            raise ValueError(f"maxsize must be >= 0, got {maxsize}")
        self.maxsize = maxsize
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: Hashable, value: Any) -> None:
        if self.maxsize == 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"size": len(self._data), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": self.hits / total if total else 0.0}
