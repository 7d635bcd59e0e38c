"""Per-replica runtime context and local storage.

Parity: ``wf/context.hpp:53-160`` (RuntimeContext passed to "riched" functor
variants) and ``wf/local_storage.hpp:57+`` (typed per-replica KV store whose
``get`` default-constructs on miss).
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class LocalStorage:
    """Per-replica key-value store. ``get(name, factory)`` default-constructs
    on miss like the reference's ``get<T>(name)``."""

    def __init__(self) -> None:
        self._store: Dict[str, Any] = {}

    def is_contained(self, name: str) -> bool:
        return name in self._store

    def get(self, name: str, factory: Callable[[], Any] = dict) -> Any:
        if name not in self._store:
            self._store[name] = factory()
        return self._store[name]

    def put(self, name: str, value: Any) -> None:
        self._store[name] = value

    def remove(self, name: str) -> None:
        self._store.pop(name, None)

    @property
    def size(self) -> int:
        return len(self._store)


class RuntimeContext:
    """Visible to user functors in their "riched" form: operator parallelism,
    replica index, metadata of the tuple being processed, and local storage."""

    def __init__(self, parallelism: int, replica_index: int) -> None:
        self.parallelism = parallelism
        self.replica_index = replica_index
        self.local_storage = LocalStorage()
        # metadata of the message currently being processed (set by replicas)
        self._current_ts = 0
        self._current_wm = 0

    # -- metadata accessors (wf/context.hpp getCurrentTimestamp/Watermark) --
    def get_current_timestamp(self) -> int:
        return self._current_ts

    def get_current_watermark(self) -> int:
        return self._current_wm

    def _set_meta(self, ts: int, wm: int) -> None:
        self._current_ts = ts
        self._current_wm = wm

    def get_parallelism(self) -> int:
        return self.parallelism

    def get_replica_index(self) -> int:
        return self.replica_index

    def get_local_storage(self) -> LocalStorage:
        return self.local_storage
