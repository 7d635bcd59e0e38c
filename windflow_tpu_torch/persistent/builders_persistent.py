"""Builders of the persistent operators.

The port's copy of ``windflow_tpu/persistent/builders_persistent.py``
(parity: ``wf/persistent/builders_rocksdb.hpp``: withDBPath,
withSerializer/Deserializer and withCacheCapacity on top of the usual
surface; the cache POLICY mirrors the reference's pluggable hot-buffer
cache, ``p_window_replica.hpp:121``: LRU by default, LFU for skewed key
distributions with ``with_cache_policy("lfu")``). ``P_Sink_Builder``
takes ``with_exactly_once``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..basic import WindFlowError, WinType
from ..builders import BasicBuilder
from .p_basic_ops import P_Filter, P_FlatMap, P_Map, P_Reduce, P_Sink
from .p_keyed_windows import P_Keyed_Windows


class _PersistentBuilder(BasicBuilder):
    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._key_extractor = None
        self._initial_state: Any = None
        self._db_dir: Optional[str] = None
        self._cache_capacity = 1024
        self._cache_policy = "lru"
        self._serialize = None
        self._deserialize = None

    def with_key_by(self, key_extractor):
        self._key_extractor = key_extractor
        return self

    def with_initial_state(self, state: Any):
        self._initial_state = state
        return self

    def with_db_path(self, path: str):
        self._db_dir = path
        return self

    def with_cache_capacity(self, n: int):
        self._cache_capacity = n
        return self

    def with_cache_policy(self, policy: str):
        """Hot-cache eviction policy: "lru" (default) or "lfu" (keeps a
        stable hot set under skewed key distributions). Validated here
        so a typo fails at build time, not at the first eviction."""
        from .cache import make_cache
        make_cache(policy, 1)  # raises WindFlowError on unknown policy
        self._cache_policy = policy
        return self

    def with_serializers(self, serialize: Callable, deserialize: Callable):
        self._serialize = serialize
        self._deserialize = deserialize
        return self

    op_cls: type = None

    def build(self):
        if self._key_extractor is None:
            raise WindFlowError(f"{type(self).__name__}: withKeyBy mandatory")
        return self._finish(self.op_cls(
            self._func, self._key_extractor, self._initial_state, self._name,
            self._parallelism, self._output_batch_size, self._db_dir,
            self._cache_capacity, self._serialize, self._deserialize,
            cache_policy=self._cache_policy))


class P_Map_Builder(_PersistentBuilder):
    _default_name = "p_map"
    op_cls = P_Map


class P_Filter_Builder(_PersistentBuilder):
    _default_name = "p_filter"
    op_cls = P_Filter


class P_FlatMap_Builder(_PersistentBuilder):
    _default_name = "p_flatmap"
    op_cls = P_FlatMap


class P_Reduce_Builder(_PersistentBuilder):
    _default_name = "p_reduce"
    op_cls = P_Reduce


class P_Sink_Builder(_PersistentBuilder):
    _default_name = "p_sink"
    op_cls = P_Sink

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._exactly_once = False

    def with_exactly_once(self):
        """Exactly-once via the epoch-fenced sqlite writer: data and the
        ``epoch`` marker commit in one sqlite transaction at the barrier,
        the ``finalized`` marker advances only on coordinator finalize,
        and a stale (pre-rescale zombie) replica generation is refused by
        the in-DB fence before it can commit anything."""
        self._exactly_once = True
        return self

    def build(self):
        op = super().build()
        op.exactly_once = self._exactly_once
        return op


class P_Keyed_Windows_Builder(_PersistentBuilder):
    _default_name = "p_keyed_windows"

    def __init__(self, win_func: Callable) -> None:
        super().__init__(win_func)
        self._win_len = 0
        self._slide_len = 0
        self._win_type = None
        self._lateness = 0
        self._incremental = False
        self._initial = None

    def with_cb_windows(self, win_len: int, slide_len: int):
        self._win_type = WinType.CB
        self._win_len, self._slide_len = win_len, slide_len
        return self

    def with_tb_windows(self, win_usec: int, slide_usec: int):
        self._win_type = WinType.TB
        self._win_len, self._slide_len = win_usec, slide_usec
        return self

    def with_lateness(self, lateness_usec: int):
        self._lateness = lateness_usec
        return self

    def incremental(self, initial_value=None):
        self._incremental = True
        self._initial = initial_value
        return self

    def build(self) -> P_Keyed_Windows:
        if self._win_type is None:
            raise WindFlowError("P_Keyed_Windows_Builder: call "
                                "with_cb_windows()/with_tb_windows()")
        if self._key_extractor is None:
            raise WindFlowError("P_Keyed_Windows_Builder: withKeyBy "
                                "mandatory")
        return self._finish(P_Keyed_Windows(
            self._func, self._key_extractor, self._win_len, self._slide_len,
            self._win_type, self._lateness, self._incremental, self._initial,
            self._name, self._parallelism, self._output_batch_size,
            self._db_dir, self._cache_capacity, self._serialize,
            self._deserialize, cache_policy=self._cache_policy))
