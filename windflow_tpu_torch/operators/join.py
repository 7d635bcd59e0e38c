"""Interval_Join: a stream join on key with a time-interval predicate.

The port's copy of ``windflow_tpu/operators/join.py`` (parity:
``wf/interval_join.hpp:60-558``). Streams A and B (tagged by the
collector from input-channel ranges) join on key where ``ts_b ∈ [ts_a -
lower, ts_a + upper]``; the user function makes the output tuple (None
drops the pair). Two parallelism modes (``wf/builders.hpp:1480-1538``):

- KP (key parallelism): KEYBY routing, a key's whole archive on one
  replica;
- DP (data parallelism): BROADCAST routing, every replica sees every
  tuple but STORES only every p-th tuple per stream (round-robin over a
  shared arrival order, ``interval_join.hpp:317-319``) and probes its own
  store with every arrival, so each matched pair is emitted by exactly
  the replica storing the earlier tuple. In DEFAULT mode a watermark-driven
  ordering collector (the reference's Join_Collector) gives every replica
  the same sequence.

Archives are ts-sorted per (key, stream); progress purges what no future
opposite tuple can match: A when ``ts_a < wm - upper``, B when ``ts_b <
wm - lower`` (``interval_join.hpp:155-165``). Results carry ``ts =
max(ts_a, ts_b)``.
"""

from __future__ import annotations

import bisect
import copy
from typing import Any, Callable, Dict, List, Tuple

from ..basic import (ExecutionMode, JoinMode, OpType, RoutingMode,
                     WindFlowError)
from .base import BasicOperator, BasicReplica, arity


class Interval_Join(BasicOperator):
    op_type = OpType.JOIN

    def __init__(self, join_func: Callable, key_extractor: Callable,
                 lower_bound: int, upper_bound: int,
                 join_mode: JoinMode = JoinMode.KP,
                 name: str = "interval_join", parallelism: int = 1,
                 output_batch_size: int = 0) -> None:
        if key_extractor is None:
            raise WindFlowError(f"{name}: requires a key extractor")
        if join_mode not in (JoinMode.KP, JoinMode.DP):
            raise WindFlowError(f"{name}: join mode must be KP or DP")
        routing = (RoutingMode.KEYBY if join_mode is JoinMode.KP
                   else RoutingMode.BROADCAST)
        super().__init__(name, parallelism, routing, key_extractor,
                         output_batch_size)
        self.join_func = join_func
        self.lower_bound = int(lower_bound)
        self.upper_bound = int(upper_bound)
        self.join_mode = join_mode
        self._riched = arity(join_func) >= 3

    @property
    def is_chainable(self) -> bool:
        return False

    def configure(self, execution_mode, time_policy, device) -> None:
        if (self.join_mode is JoinMode.DP
                and execution_mode is ExecutionMode.PROBABILISTIC):
            # K-slack reordering is arrival-dependent per replica, so
            # broadcast DP replicas would disagree on storage assignment
            raise WindFlowError(
                f"{self.name}: DP-mode Interval_Join is not supported in "
                "PROBABILISTIC mode (per-replica K-slack ordering diverges);"
                " use KP mode")
        super().configure(execution_mode, time_policy, device)

    def build_replicas(self) -> None:
        self.replicas = [IntervalJoinReplica(self, i)
                         for i in range(self.parallelism)]


class _KeyArchives:
    """Per-key ts-sorted archives for both streams + DP storage counters."""

    __slots__ = ("ts", "rows", "counters")

    def __init__(self) -> None:
        self.ts: Tuple[List[int], List[int]] = ([], [])
        self.rows: Tuple[List[Any], List[Any]] = ([], [])
        self.counters = [0, 0]  # DP round-robin per stream


class IntervalJoinReplica(BasicReplica):
    def __init__(self, op: Interval_Join, idx: int) -> None:
        super().__init__(op, idx)
        self.keys: Dict[Any, _KeyArchives] = {}

    def process(self, payload, ts, wm, tag):
        op = self.op
        if ts < wm:
            # admitted-late: the join never drops, but a KP-mode tuple
            # behind the watermark probes archives the purge frontier may
            # already have trimmed — matches can be missed; account it
            self.stats.note_late(1, 0, float(wm - ts))
        key = op.key_extractor(payload)
        ka = self.keys.get(key)
        if ka is None:
            ka = self.keys[key] = _KeyArchives()
        side = 1 if tag else 0
        other = 1 - side
        # probe the opposite archive: for an A arrival the matching B range
        # is [ts - lower, ts + upper]; for a B arrival it is the mirrored
        # [ts - upper, ts + lower]
        if side == 0:
            lo, hi = ts - op.lower_bound, ts + op.upper_bound
        else:
            lo, hi = ts - op.upper_bound, ts + op.lower_bound
        ots, orows = ka.ts[other], ka.rows[other]
        i = bisect.bisect_left(ots, lo)
        j = bisect.bisect_right(ots, hi)
        for p in range(i, j):
            stored = orows[p]
            a, b = (payload, stored) if side == 0 else (stored, payload)
            out = (op.join_func(a, b, self.context) if op._riched
                   else op.join_func(a, b))
            if out is not None:
                self.emitter.emit(out, max(ts, ots[p]), wm)
        # store (DP: only this replica's share of the shared sequence)
        store = True
        if op.join_mode is JoinMode.DP:
            store = (ka.counters[side] % op.parallelism) == self.idx
            ka.counters[side] += 1
        if store:
            pos = bisect.bisect_right(ka.ts[side], ts)
            ka.ts[side].insert(pos, ts)
            ka.rows[side].insert(pos, payload)
        # purge frontier: DP inputs are delivered in ts order by their
        # collector, so the current ts bounds every future arrival — the
        # watermark may run AHEAD of still-queued deliveries and must not
        # drive the purge. KP purges by watermark (reference
        # interval_join.hpp:155-165; late tuples may miss matches).
        frontier = ts if op.join_mode is JoinMode.DP else wm
        self._purge(ka, frontier)

    def _purge(self, ka: _KeyArchives, wm: int) -> None:
        for side, bound in ((0, self.op.upper_bound),
                            (1, self.op.lower_bound)):
            cutoff = wm - bound
            ts_list = ka.ts[side]
            k = bisect.bisect_left(ts_list, cutoff)
            if k:
                del ts_list[:k]
                del ka.rows[side][:k]

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["keys"] = copy.deepcopy({
            key: {"ts": (list(ka.ts[0]), list(ka.ts[1])),
                  "rows": (list(ka.rows[0]), list(ka.rows[1])),
                  "counters": list(ka.counters)}
            for key, ka in self.keys.items()})
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        self.keys = {}
        for key, d in state.get("keys", {}).items():
            ka = _KeyArchives()
            ka.ts = (list(d["ts"][0]), list(d["ts"][1]))
            ka.rows = (list(d["rows"][0]), list(d["rows"][1]))
            ka.counters = list(d["counters"])
            self.keys[key] = ka
