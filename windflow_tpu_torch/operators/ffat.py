"""Ffat_Windows: sliding-window aggregation with lift + combine over a
host FlatFAT tree (reference ``wf/ffat_windows.hpp`` +
``wf/ffat_replica.hpp``).

The port's copy of ``windflow_tpu/operators/ffat.py`` (host Python; the
device operator is ``gpu/ffat_gpu.py:Ffat_Windows_GPU``). The user gives
``lift(tuple) -> value`` and an associative ``combine(value, value) ->
value``; each fired window emits the ordered combine of the lifted values
it covers.

- CB: per key, a FlatFAT ring holds the current window's lifted values;
  window ``g`` fires when its last tuple arrives, then ``slide`` oldest
  values are evicted.
- TB: pane decomposition as in the reference GPU path
  (``wf/ffat_replica_gpu.hpp:638-642``): pane length = gcd(win, slide);
  tuples fold into per-pane partials; the bound completes panes (the
  watermark minus the lateness in DEFAULT mode, the tuple's own timestamp
  in the ordered modes, ``ffat_replica_gpu.hpp:875-881``), completed panes
  enter the FlatFAT (missing ones as identity placeholders) and window
  ``g`` fires once ``win/pane`` panes are present, evicting
  ``slide/pane``.

Late tuples behind the consumed-pane frontier are counted as ignored. A
window with no tuples fires with ``value None`` (the combine identity),
unlike the engine-based window operators, which call the window function
on an empty collection (the reference's GPU/CPU split).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, Optional

from ..basic import (ExecutionMode, OpType, RoutingMode, WinType,
                     WindFlowError)
from .base import BasicOperator, BasicReplica
from .flatfat import FlatFAT
from .window_engine import WinResult


class _FfatKeyState:
    __slots__ = ("fat", "count", "next_gwid", "pending_panes",
                 "next_pane_to_push")

    def __init__(self) -> None:
        self.fat = None  # lazily built (needs combine fn)
        self.count = 0  # CB arrival counter
        self.next_gwid = 0
        self.pending_panes: Dict[int, Any] = {}
        self.next_pane_to_push = 0


class Ffat_Windows(BasicOperator):
    op_type = OpType.WIN

    def __init__(self, lift_func: Callable, combine_func: Callable,
                 key_extractor: Callable, win_len: int, slide_len: int,
                 win_type: WinType = WinType.CB, lateness: int = 0,
                 name: str = "ffat_windows", parallelism: int = 1,
                 output_batch_size: int = 0) -> None:
        if key_extractor is None:
            raise WindFlowError("Ffat_Windows requires a key extractor")
        if win_len <= 0 or slide_len <= 0:
            raise WindFlowError("Ffat_Windows: win/slide must be > 0")
        super().__init__(name, parallelism, RoutingMode.KEYBY, key_extractor,
                         output_batch_size)
        self.lift = lift_func
        self.combine = combine_func
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.lateness = lateness
        self.pane_len = math.gcd(win_len, slide_len)

    @property
    def is_chainable(self) -> bool:
        return False

    def build_replicas(self) -> None:
        self.replicas = [FfatReplica(self, i) for i in range(self.parallelism)]


class FfatReplica(BasicReplica):
    def __init__(self, op: Ffat_Windows, idx: int) -> None:
        super().__init__(op, idx)
        self.keys: Dict[Any, _FfatKeyState] = {}
        if op.win_type is WinType.CB:
            self._fat_cap = op.win_len
            self._win_units = op.win_len
            self._slide_units = op.slide_len
        else:
            self._win_units = op.win_len // op.pane_len
            self._slide_units = op.slide_len // op.pane_len
            self._fat_cap = self._win_units
        self.ignored = 0

    def _key_state(self, key: Any) -> _FfatKeyState:
        ks = self.keys.get(key)
        if ks is None:
            ks = self.keys[key] = _FfatKeyState()
            ks.fat = FlatFAT(self._fat_cap, self.op.combine)
        return ks

    # ------------------------------------------------------------------
    def process(self, payload, ts, wm, tag):
        op = self.op
        key = op.key_extractor(payload)
        ks = self._key_state(key)
        value = op.lift(payload)
        if op.win_type is WinType.CB:
            i = ks.count
            ks.count += 1
            if op.slide_len > op.win_len and (i % op.slide_len) >= op.win_len:
                return  # hopping windows: tuple falls in an inter-window gap
            ks.fat.push(value)
            if ks.fat.size >= op.win_len:
                self._fire(key, ks, wm, ts)
        else:
            pane_id = ts // op.pane_len
            if ks.count == 0:
                # first tuple of this key: align the ring to the first
                # window that can contain it (epoch-scale ts safety)
                w0 = max(0, (pane_id - self._win_units) // self._slide_units + 1)
                ks.next_pane_to_push = w0 * self._slide_units
                ks.next_gwid = w0
            ks.count += 1
            if pane_id < ks.next_pane_to_push:
                self.ignored += 1  # behind the consumed-pane frontier
                self.stats.note_late(1, 1,
                                     float(wm - ts) if wm > ts else None)
                return
            if ts < wm:
                # admitted-late: behind the watermark but ahead of the
                # consumed-pane frontier (within the allowed lateness)
                self.stats.note_late(1, 0, float(wm - ts))
            cur = ks.pending_panes.get(pane_id)
            ks.pending_panes[pane_id] = (value if cur is None
                                         else op.combine(cur, value))
            self._advance_tb(key, ks, ts, wm)

    def _effective_bound(self, ts: int, wm: int) -> int:
        """First incomplete pane. DEFAULT: watermark-driven; other modes:
        inputs arrive in ts order, so ts itself is the frontier."""
        if self.op.execution_mode is ExecutionMode.DEFAULT:
            return max(0, (wm - self.op.lateness)) // self.op.pane_len
        return ts // self.op.pane_len

    def _advance_tb(self, key, ks: _FfatKeyState, ts: int, wm: int) -> None:
        bound = self._effective_bound(ts, wm)
        while ks.next_pane_to_push < bound:
            if ks.fat.size >= self._win_units:
                # FlatFAT full => the oldest window is complete; fire it
                self._fire(key, ks, wm, ts)
            pane_id = ks.next_pane_to_push
            ks.next_pane_to_push += 1
            if self._slide_units > self._win_units \
                    and (pane_id % self._slide_units) >= self._win_units:
                ks.pending_panes.pop(pane_id, None)
                continue  # hopping windows: pane in an inter-window gap
            partial = ks.pending_panes.pop(pane_id, None)
            ks.fat.push(partial)  # None = identity placeholder (empty pane)
        while ks.fat.size >= self._win_units:
            self._fire(key, ks, wm, ts)

    def _fire(self, key, ks: _FfatKeyState, wm: int, ts: int,
              partial_len: Optional[int] = None) -> None:
        length = partial_len if partial_len is not None else self._win_units
        value = ks.fat.query_logical(0, length)
        used_ts = wm if self.op.execution_mode is ExecutionMode.DEFAULT else ts
        res = WinResult(key, ks.next_gwid, value, used_ts)
        ks.next_gwid += 1
        self.emitter.emit(res, used_ts,
                          wm if self.op.execution_mode is ExecutionMode.DEFAULT else 0)
        ks.fat.pop(self._slide_units)

    # ------------------------------------------------------------------
    def on_punctuation(self, wm: int) -> None:
        if self.op.win_type is WinType.TB \
                and self.op.execution_mode is ExecutionMode.DEFAULT:
            for key, ks in self.keys.items():
                self._advance_tb(key, ks, 0, self.cur_wm)
        super().on_punctuation(wm)

    # -- checkpointing -----------------------------------------------------
    # The FlatFAT ring holds the user's combine callable, which stays out
    # of the pickle: snapshot the pure data (tree slots, head, size; deep
    # copies, so the blob owns them) and re-attach the combine on restore.
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["ignored"] = self.ignored
        st["keys"] = copy.deepcopy({
            key: {"count": ks.count, "next_gwid": ks.next_gwid,
                  "pending_panes": dict(ks.pending_panes),
                  "next_pane_to_push": ks.next_pane_to_push,
                  "fat": (ks.fat.capacity, ks.fat.head, ks.fat.size,
                          list(ks.fat.tree))}
            for key, ks in self.keys.items()})
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        self.ignored = state.get("ignored", 0)
        self.keys = {}
        for key, d in state.get("keys", {}).items():
            ks = _FfatKeyState()
            cap, head, size, tree = d["fat"]
            fat = FlatFAT(cap, self.op.combine)
            fat.tree = list(tree)
            fat.head = head
            fat.size = size
            ks.fat = fat
            ks.count = d["count"]
            ks.next_gwid = d["next_gwid"]
            ks.pending_panes = dict(d["pending_panes"])
            ks.next_pane_to_push = d["next_pane_to_push"]
            self.keys[key] = ks

    def flush_on_termination(self) -> None:
        op = self.op
        for key, ks in self.keys.items():
            if op.win_type is WinType.TB and ks.pending_panes:
                # push every remaining pane in order
                last = max(ks.pending_panes)
                while ks.next_pane_to_push <= last:
                    if ks.fat.size >= self._win_units:
                        self._fire(key, ks, self.cur_wm, self.cur_wm)
                    pane_id = ks.next_pane_to_push
                    ks.next_pane_to_push += 1
                    if self._slide_units > self._win_units \
                            and (pane_id % self._slide_units) >= self._win_units:
                        ks.pending_panes.pop(pane_id, None)
                        continue
                    partial = ks.pending_panes.pop(pane_id, None)
                    ks.fat.push(partial)
            # fire remaining (possibly partial) windows
            while ks.fat.size > 0:
                self._fire(key, ks, self.cur_wm, self.cur_wm,
                           partial_len=min(self._win_units, ks.fat.size))
        self.stats.inputs_ignored += self.ignored
