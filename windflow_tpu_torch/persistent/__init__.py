"""Out-of-core keyed state: the port of ``windflow_tpu.persistent``.

``DBHandle`` (one sqlite file per owner) and the hot caches in front of it
(``LRUCache``, ``LFUCache``, the dict-like ``LRUStore``) back the
persistent operators (``P_Map``, ``P_Filter``, ``P_FlatMap``,
``P_Reduce``, ``P_Sink``, ``P_Keyed_Windows``) and the tier plane's cold
store (``state/tiered.py``).
"""

from .builders_persistent import (P_Filter_Builder, P_FlatMap_Builder,
                                  P_Keyed_Windows_Builder, P_Map_Builder,
                                  P_Reduce_Builder, P_Sink_Builder)
from .cache import LFUCache, LRUCache, LRUStore, make_cache
from .db_handle import DBHandle
from .p_basic_ops import P_Filter, P_FlatMap, P_Map, P_Reduce, P_Sink
from .p_keyed_windows import P_Keyed_Windows

__all__ = [
    "DBHandle", "LFUCache", "LRUCache", "LRUStore", "make_cache",
    "P_Map", "P_Filter", "P_FlatMap", "P_Reduce", "P_Sink",
    "P_Keyed_Windows",
    "P_Map_Builder", "P_Filter_Builder", "P_FlatMap_Builder",
    "P_Reduce_Builder", "P_Sink_Builder", "P_Keyed_Windows_Builder",
]
