"""P_Keyed_Windows: keyed windows with out-of-core per-key window state.

The port's copy of ``windflow_tpu/persistent/p_keyed_windows.py``
(parity: ``wf/persistent/p_window_replica.hpp:69-659``, window content in
RocksDB behind an LRU cache of hot buffers). The SAME ``WindowEngine`` as
``Keyed_Windows`` (the port's ``operators/windows.py:_WindowReplica``)
runs with its per-key descriptor map replaced by an ``LRUStore``: hot keys
stay in memory, cold key descriptors (open windows and archives) spill to
the replica's sqlite file and reload on access. The window semantics are
``Keyed_Windows``' by construction; only where the state lives differs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..basic import WinType
from ..operators.windows import Keyed_Windows, _WindowReplica
from .cache import LRUStore
from .db_handle import DBHandle


class P_Keyed_Windows(Keyed_Windows):
    def __init__(self, win_func: Callable, key_extractor, win_len: int,
                 slide_len: int, win_type: WinType = WinType.CB,
                 lateness: int = 0, incremental: bool = False,
                 initial_value: Any = None, name: str = "p_keyed_windows",
                 parallelism: int = 1, output_batch_size: int = 0,
                 db_dir: Optional[str] = None, cache_capacity: int = 256,
                 serialize=None, deserialize=None,
                 cache_policy: str = "lru") -> None:
        super().__init__(win_func, key_extractor, win_len, slide_len,
                         win_type, lateness, incremental, initial_value,
                         name, parallelism, output_batch_size)
        self.db_dir = db_dir
        self.cache_capacity = cache_capacity
        self.cache_policy = cache_policy
        self.serialize = serialize
        self.deserialize = deserialize

    def build_replicas(self) -> None:
        self.replicas = [PKeyedWindowsReplica(self, i)
                         for i in range(self.parallelism)]


class PKeyedWindowsReplica(_WindowReplica):
    def __init__(self, op: P_Keyed_Windows, idx: int) -> None:
        super().__init__(op, idx)
        self.db = DBHandle(f"{op.name}_r{idx}", op.serialize, op.deserialize,
                           op.db_dir)
        # swap the engine's key map for the cache-backed store
        self.engine.key_map = LRUStore(self.db, op.cache_capacity,
                                       policy=op.cache_policy)

    def flush_on_termination(self) -> None:
        super().flush_on_termination()
        self.engine.key_map.flush()
        self.db.close()

    # -- checkpointing -----------------------------------------------------
    # The engine's key map is the cache-backed store: spill it and ship
    # the DB image instead of materializing every cold key into the blob.
    # Restore replaces the DB contents (a crashed run's file holds
    # post-checkpoint descriptors that must roll back).
    def snapshot_state(self) -> dict:
        from ..operators.base import BasicReplica
        st = BasicReplica.snapshot_state(self)
        self.engine.key_map.flush()
        st["db"] = self.db.snapshot_bytes()
        st["engine_meta"] = {"ignored_tuples": self.engine.ignored_tuples,
                             "cur_wm": self.engine.cur_wm}
        return st

    def restore_state(self, state: dict) -> None:
        from ..operators.base import BasicReplica
        BasicReplica.restore_state(self, state)
        blob = state.get("db")
        if blob is not None:
            self.db.restore_bytes(blob)
        meta = state.get("engine_meta", {})
        self.engine.ignored_tuples = meta.get("ignored_tuples", 0)
        self.engine.cur_wm = meta.get("cur_wm", 0)
