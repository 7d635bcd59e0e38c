"""General windowing engine: triggerers, per-key descriptors, window
assignment, firing, lateness, EOS flush.

The port's copy of ``windflow_tpu/operators/window_engine.py`` (host
Python in both packages; the parity map is the reference's):

- Triggerer_CB / Triggerer_TB (``wf/window_structure.hpp:49-116``):
  window ``lwid`` covers the index range ``[initial + lwid*slide_local,
  initial + lwid*slide_local + win)``, the index being the per-key
  arrival counter (CB) or the timestamp (TB).
- Window distribution (``wf/window_replica.hpp:253-283``): replica
  ``id_inner`` of ``num_inner`` owns the global window ids ``gwid ≡
  (id_inner - hash(key)) mod num_inner``, with a local slide of ``slide *
  num_inner``.
- MAP role: every replica evaluates EVERY window but folds only the tuples
  with ``ts % map_parallelism == replica_index``
  (``window_replica.hpp:286``); result ids step by ``map_parallelism``
  from the replica index, so the REDUCE stage's count-based windows
  gather the partials of one window (``window_replica.hpp:333-336``).
- PLQ role: pane results carry their global pane id
  (``window_replica.hpp:337-341``) for the WLQ's id-sequencing collector.
- Firing: CB windows fire by count; TB windows in DEFAULT mode once
  ``watermark > window_end + lateness`` (``window_replica.hpp:304-311``);
  a fired result carries ts = watermark in DEFAULT mode and the trigger ts
  otherwise (``window_replica.hpp:330-332``).
- Tuples older than the last fired window boundary are dropped and
  counted (``window_replica.hpp:258-268``); EOS flushes every open window
  with its partial content (``window_replica.hpp:356-408``).

A TB key's windows start at the first window that can hold its first
tuple (PARITY.md §2.3); ``tb_origin`` anchors them at a time origin
instead and fires the empty windows in between. ``snapshot_state`` copies
the key map, so a blob owns its data while the worker runs on.
"""

from __future__ import annotations

import bisect
import copy
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..basic import ExecutionMode, WinRole, WinType


@dataclass
class WinResult:
    """Result of one window evaluation (the reference constructs the user's
    result type with (key, gwid) via ``create_win_result_t``,
    ``wf/basic.hpp:331-342``)."""

    key: Any
    wid: int
    value: Any
    ts: int = 0


@dataclass
class _OpenWindow:
    lwid: int
    gwid: int
    start: int  # first index (count or ts) covered
    end: int  # one past the last index covered
    acc: Any = None  # incremental accumulator
    n_tuples: int = 0


@dataclass
class _KeyDesc:
    next_input_id: int = 0  # per-key arrival counter (CB index)
    next_lwid: int = 0
    last_fired_lwid: int = -1
    next_res_id: int = 0
    wins: List[_OpenWindow] = field(default_factory=list)
    # archive for non-incremental queries: parallel sorted lists
    arch_idx: List[int] = field(default_factory=list)
    arch_payload: List[Any] = field(default_factory=list)


class WindowEngine:
    """Per-replica window machinery; usable in roles SEQ/PLQ/WLQ/MAP/REDUCE.

    The host replica supplies ``emit(result_payload, ts, wm, msg_id)`` and a
    key extractor; the engine owns assignment, accumulation and firing.
    """

    def __init__(self,
                 win_type: WinType,
                 win_len: int,
                 slide_len: int,
                 lateness: int,
                 key_extractor: Callable[[Any], Any],
                 win_func: Callable,
                 incremental: bool,
                 initial_value: Any,
                 role: WinRole,
                 id_inner: int,
                 num_inner: int,
                 map_parallelism: int = 1,
                 map_index: int = 0,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT,
                 riched: bool = False,
                 context: Any = None,
                 tb_origin: Optional[int] = None) -> None:
        assert win_len > 0 and slide_len > 0
        self.win_type = win_type
        self.win_len = win_len
        # non-MAP distributed roles stretch the local slide by num_inner
        self.slide_local = slide_len * num_inner
        self.slide_global = slide_len
        self.lateness = lateness
        self.key_extractor = key_extractor
        self.win_func = win_func
        self.incremental = incremental
        self.initial_value = initial_value
        self.role = role
        self.id_inner = id_inner
        self.num_inner = num_inner
        self.map_parallelism = map_parallelism
        self.map_index = map_index
        self.execution_mode = execution_mode
        self.riched = riched
        self.context = context
        self.key_map: Dict[Any, _KeyDesc] = {}
        self.ignored_tuples = 0
        self.cur_wm = 0
        # unified late accounting (event-time health plane): the owning
        # replica wires its StatsRecord here; None (bare engine in unit
        # tests) keeps the engine standalone
        self.stats = None
        # Reference-compat TB numbering (wf/window_replica.hpp:253-283):
        # when set, a key's windows are anchored at this time origin (not
        # its first tuple), and every window between the origin and the
        # first tuple is created and fired with the identity/empty value.
        # None (default) keeps the first-tuple anchoring documented in
        # PARITY.md §2.3 (epoch-scale timestamps would otherwise create
        # ~ts/slide empty windows — the origin bounds that blowup).
        self.tb_origin = tb_origin if win_type is WinType.TB else None

    # ------------------------------------------------------------------
    def _first_gwid(self, key: Any) -> int:
        h = hash(key) % self.num_inner
        return (self.id_inner - h + self.num_inner) % self.num_inner

    def _new_acc(self, key: Any, gwid: int) -> Any:
        if callable(self.initial_value):
            return self.initial_value(key, gwid)
        return copy.deepcopy(self.initial_value)

    # ------------------------------------------------------------------
    def process(self, payload: Any, ts: int, wm: int,
                emit: Callable[[Any, int, int, Optional[int]], None]) -> None:
        if wm > self.cur_wm:
            self.cur_wm = wm
        key = self.key_extractor(payload)
        kd = self.key_map.get(key)
        if kd is None:
            kd = self.key_map[key] = _KeyDesc(
                next_res_id=(self.map_index if self.role is WinRole.MAP else 0))
        is_new_key = kd.next_input_id == 0
        ident = kd.next_input_id
        kd.next_input_id += 1
        index = ident if self.win_type is WinType.CB else ts
        first_gwid = self._first_gwid(key)
        initial = first_gwid * (self.slide_local // self.num_inner)
        if self.tb_origin is not None:
            # reference-compat numbering: anchor every key's windows at
            # the configured time origin; windows between the origin and
            # the key's first tuple open below and fire empty (identity
            # value) as the watermark passes them
            initial += self.tb_origin
        elif is_new_key and self.win_type is WinType.TB:
            # a key first seen at a large timestamp starts at the first
            # window that can contain it — creating (and empty-firing) every
            # window since the time origin would blow up with epoch-scale
            # timestamps. Global window ids stay aligned.
            rel = index - initial
            kd.next_lwid = max(0, (rel - self.win_len) // self.slide_local + 1)
        # late-tuple guard: before the first still-open window => ignored
        min_boundary = (self.win_len + kd.last_fired_lwid * self.slide_local
                        if kd.last_fired_lwid >= 0 else 0)
        if index < initial + min_boundary:
            # count real drops: fired-past tuples, and (origin mode) tuples
            # before the configured origin — NOT pre-`initial` tuples that
            # simply belong to another replica's windows (broadcast roles)
            if kd.last_fired_lwid >= 0 or (self.tb_origin is not None
                                           and index < self.tb_origin):
                self.ignored_tuples += 1
                st = self.stats
                if st is not None:
                    st.note_late(1, 1, float(wm - ts)
                                 if self.win_type is WinType.TB and wm > ts
                                 else None)
            return
        # admitted-late: a TB tuple behind the watermark that still lands
        # in an open window (within the allowed lateness). Dropped late
        # tuples returned above, so the two sites classify disjointly and
        # inputs == on_time + late_admitted + late_dropped holds exactly
        st = self.stats
        if st is not None and self.win_type is WinType.TB and ts < wm:
            st.note_late(1, 0, float(wm - ts))
        # open every window whose range has been reached
        if self.win_len >= self.slide_local:  # sliding / tumbling
            last_w = math.ceil((index + 1 - initial) / self.slide_local) - 1
        else:  # hopping (gaps between windows)
            last_w = (index - initial) // self.slide_local
        for lwid in range(kd.next_lwid, last_w + 1):
            gwid = first_gwid + lwid * self.num_inner
            start = initial + lwid * self.slide_local
            w = _OpenWindow(lwid, gwid, start, start + self.win_len)
            if self.incremental:
                w.acc = self._new_acc(key, gwid)
            kd.wins.append(w)
            kd.next_lwid = lwid + 1
        # MAP role: fold only this replica's tuple partition
        if (self.role is WinRole.MAP
                and ts % self.map_parallelism != self.map_index):
            return
        if not self.incremental:
            pos = bisect.bisect_right(kd.arch_idx, index)
            kd.arch_idx.insert(pos, index)
            kd.arch_payload.insert(pos, payload)
        cnt_fired = 0
        for w in kd.wins:
            if index < w.start:
                continue  # OLD for this window
            if index < w.end:  # IN
                if self.incremental:
                    out = (self.win_func(payload, w.acc, self.context)
                           if self.riched else self.win_func(payload, w.acc))
                    if out is not None:
                        w.acc = out
                w.n_tuples += 1
            else:  # FIRED by index
                if (self.win_type is WinType.CB
                        or self.execution_mode is not ExecutionMode.DEFAULT
                        or w.end - 1 + self.lateness < wm):
                    self._fire(key, kd, w, ts, wm, emit)
                    cnt_fired += 1
        if cnt_fired:
            del kd.wins[:cnt_fired]

    # ------------------------------------------------------------------
    def on_watermark(self, wm: int,
                     emit: Callable[[Any, int, int, Optional[int]], None]) -> None:
        """Fire TB windows whose end passed the watermark. The reference only
        fires lazily on the next tuple/EOS; firing on punctuations too is a
        liveness improvement with identical results."""
        if wm > self.cur_wm:
            self.cur_wm = wm
        if self.win_type is not WinType.TB \
                or self.execution_mode is not ExecutionMode.DEFAULT:
            return
        for key, kd in self.key_map.items():
            cnt = 0
            for w in kd.wins:
                if w.end - 1 + self.lateness < wm:
                    self._fire(key, kd, w, wm, wm, emit)
                    cnt += 1
                else:
                    break
            if cnt:
                del kd.wins[:cnt]

    # ------------------------------------------------------------------
    def _window_content(self, kd: _KeyDesc, w: _OpenWindow) -> List[Any]:
        lo = bisect.bisect_left(kd.arch_idx, w.start)
        hi = bisect.bisect_left(kd.arch_idx, w.end)
        return kd.arch_payload[lo:hi]

    def _purge_archive(self, kd: _KeyDesc, upto_index: int) -> None:
        lo = bisect.bisect_left(kd.arch_idx, upto_index)
        if lo:
            del kd.arch_idx[:lo]
            del kd.arch_payload[:lo]

    def _fire(self, key: Any, kd: _KeyDesc, w: _OpenWindow, ts: int, wm: int,
              emit: Callable[[Any, int, int, Optional[int]], None]) -> None:
        if self.incremental:
            value = w.acc
        else:
            content = self._window_content(kd, w)
            value = (self.win_func(content, self.context) if self.riched
                     else self.win_func(content))
            # later windows never need anything before the NEXT window's start
            self._purge_archive(kd, w.start + self.slide_local)
        kd.last_fired_lwid = w.lwid
        used_ts = wm if self.execution_mode is ExecutionMode.DEFAULT else ts
        used_wm = wm if self.execution_mode is ExecutionMode.DEFAULT else 0
        result = WinResult(key, w.gwid, value, used_ts)
        if self.role is WinRole.MAP:
            msg_id = kd.next_res_id
            kd.next_res_id += self.map_parallelism
        elif self.role is WinRole.PLQ:
            msg_id = self._first_gwid(key) + kd.next_res_id * self.num_inner
            kd.next_res_id += 1
        else:
            msg_id = None
        emit(result, used_ts, used_wm, msg_id)

    # ------------------------------------------------------------------
    def flush(self, emit: Callable[[Any, int, int, Optional[int]], None]) -> None:
        """EOS: fire all open windows with partial content
        (``window_replica.hpp:356-408``)."""
        for key, kd in self.key_map.items():
            for w in kd.wins:
                self._fire(key, kd, w, self.cur_wm, self.cur_wm, emit)
            kd.wins.clear()

    # ------------------------------------------------------------------
    # checkpointing: the engine's state is pure data (_KeyDesc trees of
    # open windows, archives, counters); functors and the context stay out
    # of the blob and come from the rebuilt operator on restore
    def snapshot_state(self) -> dict:
        return {"key_map": copy.deepcopy(dict(self.key_map.items())),
                "ignored_tuples": self.ignored_tuples,
                "cur_wm": self.cur_wm}

    def restore_state(self, state: dict) -> None:
        self.key_map = dict(state.get("key_map", {}))
        self.ignored_tuples = state.get("ignored_tuples", 0)
        self.cur_wm = state.get("cur_wm", 0)
