"""Hot-state caches for persistent operators and the tier plane.

The port's copy of ``windflow_tpu/persistent/cache.py`` (parity:
``wf/persistent/cache/*.hpp``: the reference keeps an LRU/LFU cache of
hot window buffers in front of RocksDB, chosen per operator,
``p_window_replica.hpp:121``). ``LRUStore`` is a MutableMapping the window
engine and the keyed persistent operators use directly: hot entries live
in memory, evictions spill to the ``DBHandle``, lookups fall back to it.
The eviction policy is pluggable (``policy="lru"|"lfu"``). The tier plane
(``state/tiered.py``) keeps the caches as pure recency / frequency
trackers through ``make_cache``.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Dict, Iterator, MutableMapping

from ..basic import WindFlowError
from .db_handle import DBHandle

_MISSING = object()


class LRUCache:
    """Plain bounded LRU with an eviction callback."""

    def __init__(self, capacity: int, on_evict=None) -> None:
        self.capacity = max(1, capacity)
        self.on_evict = on_evict
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        v = self._d.get(key, _MISSING)
        if v is _MISSING:
            self.misses += 1
            return default
        self.hits += 1
        self._d.move_to_end(key)
        return v

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            k, v = self._d.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(k, v)

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def eviction_order(self):
        """Keys in the order the policy would evict them (LRU first).
        Snapshot before mutating — this iterates the live structure."""
        return iter(self._d.keys())


class LFUCache:
    """Bounded LFU with LRU tie-break inside a frequency class (the
    classic O(1) two-level structure: value dict + per-frequency ordered
    key buckets). Same surface as LRUCache so ``LRUStore`` can host
    either policy."""

    def __init__(self, capacity: int, on_evict=None) -> None:
        self.capacity = max(1, capacity)
        self.on_evict = on_evict
        self._vals: Dict[Any, Any] = {}
        self._freq: Dict[Any, int] = {}
        # freq -> ordered set of keys (OrderedDict keys; LRU order inside
        # the class so equal-frequency eviction is deterministic)
        self._buckets: Dict[int, OrderedDict] = defaultdict(OrderedDict)
        # lower bound of the minimum live frequency (never above it; the
        # eviction scan advances it past emptied buckets)
        self._minf = 1
        self.hits = 0
        self.misses = 0

    def _touch(self, key) -> None:
        f = self._freq[key]
        bucket = self._buckets[f]
        del bucket[key]
        if not bucket:
            del self._buckets[f]
        self._freq[key] = f + 1
        self._buckets[f + 1][key] = None

    def get(self, key, default=None):
        if key not in self._vals:
            self.misses += 1
            return default
        self.hits += 1
        self._touch(key)
        return self._vals[key]

    def put(self, key, value) -> None:
        if key in self._vals:
            self._vals[key] = value
            self._touch(key)
            return
        while len(self._vals) >= self.capacity:
            self._evict_one()
        self._vals[key] = value
        self._freq[key] = 1
        self._buckets[1][key] = None
        self._minf = 1

    def _evict_one(self) -> None:
        while self._minf not in self._buckets:
            self._minf += 1
        bucket = self._buckets[self._minf]
        key, _ = bucket.popitem(last=False)  # LRU within the class
        if not bucket:
            del self._buckets[self._minf]
        del self._freq[key]
        v = self._vals.pop(key)
        if self.on_evict is not None:
            self.on_evict(key, v)

    def pop(self, key, default=None):
        if key not in self._vals:
            return default
        f = self._freq.pop(key)
        bucket = self._buckets[f]
        del bucket[key]
        if not bucket:
            del self._buckets[f]
        return self._vals.pop(key)

    def __contains__(self, key) -> bool:
        return key in self._vals

    def __len__(self) -> int:
        return len(self._vals)

    def keys(self):
        return self._vals.keys()

    def items(self):
        return self._vals.items()

    def eviction_order(self):
        """Keys in the order the policy would evict them (ascending
        frequency, LRU inside each class). Snapshot before mutating."""
        for f in sorted(self._buckets):
            yield from self._buckets[f].keys()


_CACHE_POLICIES = {"lru": LRUCache, "lfu": LFUCache}


def make_cache(policy: str, capacity: int, on_evict=None):
    """Cache factory shared by the store and the builders (ONE place
    that knows the policy names)."""
    cls = _CACHE_POLICIES.get(str(policy).lower())
    if cls is None:
        raise WindFlowError(
            f"unknown cache policy {policy!r} (expected one of "
            f"{sorted(_CACHE_POLICIES)})")
    return cls(capacity, on_evict=on_evict)


class LRUStore(MutableMapping):
    """Dict-like keyed-state store: a bounded hot cache (LRU by default,
    LFU via ``policy="lfu"``) over a DBHandle. Satisfies the access
    pattern of the window engine and keyed operators (get/setitem/items),
    so persistent variants reuse the exact same processing logic with
    out-of-core state."""

    def __init__(self, db: DBHandle, capacity: int = 1024,
                 policy: str = "lru") -> None:
        self.db = db
        self.cache = make_cache(policy, capacity, on_evict=self._spill)

    def _spill(self, key, value) -> None:
        self.db.put(key, value)

    # -- MutableMapping ----------------------------------------------------
    def __getitem__(self, key):
        v = self.cache.get(key, _MISSING)
        if v is not _MISSING:
            return v
        v = self.db.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        self.cache.put(key, v)
        return v

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value) -> None:
        self.cache.put(key, value)

    def __delitem__(self, key) -> None:
        self.cache.pop(key, None)
        self.db.delete(key)

    def __iter__(self) -> Iterator:
        seen = set()
        for k in list(self.cache.keys()):
            seen.add(k)
            yield k
        for k in self.db.keys():
            if k not in seen:
                yield k

    def __len__(self) -> int:
        n = len(self.cache)
        for k in self.db.keys():
            if k not in self.cache:
                n += 1
        return n

    def items(self):
        for k in list(self):
            yield k, self[k]

    def flush(self) -> None:
        """Spill every cached entry so the DB is complete (EOS/checkpoint)."""
        for k, v in list(self.cache.items()):
            self.db.put(k, v)
        self.db.commit()
