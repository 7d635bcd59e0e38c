"""Eviction-order trackers for the tier plane.

Trimmed copy of ``windflow_tpu/persistent/cache.py`` (parity:
``wf/persistent/cache/*.hpp``): the LRU and LFU caches and the
``make_cache`` factory, with the surface the tiered key store uses: it
keeps them as pure recency/frequency trackers (``get`` / ``put`` /
``pop`` / ``eviction_order()``), never relying on their auto-eviction.
The persistent operators' ``LRUStore`` is not ported.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Dict

from ..basic import WindFlowError

_MISSING = object()


class LRUCache:
    """Plain bounded LRU with an eviction callback."""

    def __init__(self, capacity: int, on_evict=None) -> None:
        self.capacity = max(1, capacity)
        self.on_evict = on_evict
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        v = self._d.get(key, _MISSING)
        if v is _MISSING:
            return default
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

    def eviction_order(self):
        """Keys in the order the policy would evict them (LRU first).
        Snapshot before mutating — this iterates the live structure."""
        return iter(self._d.keys())


class LFUCache:
    """Bounded LFU with LRU tie-break inside a frequency class (value dict
    + per-frequency ordered key buckets). Same surface as LRUCache."""

    def __init__(self, capacity: int, on_evict=None) -> None:
        self.capacity = max(1, capacity)
        self.on_evict = on_evict
        self._vals: Dict[Any, Any] = {}
        self._freq: Dict[Any, int] = {}
        # freq -> ordered set of keys (LRU order inside the class so
        # equal-frequency eviction is deterministic)
        self._buckets: Dict[int, OrderedDict] = defaultdict(OrderedDict)
        # lower bound of the minimum live frequency (never above it; the
        # eviction scan advances it past emptied buckets)
        self._minf = 1

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
            return default
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

    def eviction_order(self):
        """Keys in the order the policy would evict them (ascending
        frequency, LRU inside each class). Snapshot before mutating."""
        for f in sorted(self._buckets):
            yield from self._buckets[f].keys()


_CACHE_POLICIES = {"lru": LRUCache, "lfu": LFUCache}


def make_cache(policy: str, capacity: int, on_evict=None):
    """Cache factory: the ONE place that knows the policy names."""
    cls = _CACHE_POLICIES.get(str(policy).lower())
    if cls is None:
        raise WindFlowError(
            f"unknown cache policy {policy!r} (expected one of "
            f"{sorted(_CACHE_POLICIES)})")
    return cls(capacity, on_evict=on_evict)
