"""Host-side keyed-state storage the tier plane's cold store is built on
(the counterpart of ``windflow_tpu.persistent``, trimmed to what
``state/tiered.py`` uses: ``make_cache`` and ``DBHandle``)."""

from .cache import LFUCache, LRUCache, make_cache
from .db_handle import DBHandle

__all__ = ["DBHandle", "LFUCache", "LRUCache", "make_cache"]
