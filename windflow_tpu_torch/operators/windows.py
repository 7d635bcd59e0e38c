"""Window operators: Keyed_Windows, Parallel_Windows, Paned_Windows,
MapReduce_Windows.

The port's copy of ``windflow_tpu/operators/windows.py`` (host Python,
one ``WindowEngine`` per replica). Parity map:

- Keyed_Windows (``wf/keyed_windows.hpp``): KEYBY routing, each replica
  runs the engine in role SEQ over its key partition.
- Parallel_Windows (``wf/parallel_windows.hpp``): BROADCAST routing,
  windows dealt round-robin across replicas by global window id; CB
  windows in roles SEQ/PLQ/MAP are refused in DEFAULT mode (arrival order
  differs across broadcast replicas, ``parallel_windows.hpp:119-123``).
- Paned_Windows (``wf/paned_windows.hpp:140-141``): PLQ = Parallel_Windows
  over tumbling panes of gcd(win, slide); WLQ = count-based
  Parallel_Windows over the pane results (win/gcd, slide/gcd) behind an
  id-sequencing collector. Needs win > slide.
- MapReduce_Windows (``wf/mapreduce_windows.hpp:140-141``): MAP =
  Parallel_Windows with the same win/slide, each replica folding its
  ``ts % p`` share of every window; REDUCE = count-based Parallel_Windows
  with win = slide = map parallelism, combining the partials.

Composite operators expose ``sub_operators``; ``MultiPipe.add`` expands
them into two consecutive stages.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

from ..basic import (ExecutionMode, OpType, RoutingMode, WinRole, WinType,
                     WindFlowError)
from .base import BasicOperator, BasicReplica, arity
from .window_engine import WindowEngine, WinResult


class _WindowReplica(BasicReplica):
    """Hosts a WindowEngine; wires emission and punctuation-driven firing."""

    def __init__(self, op: "_WindowOperatorBase", idx: int) -> None:
        super().__init__(op, idx)
        self.engine = op._make_engine(idx, self.context)
        # unified late accounting: the engine classifies every tuple as
        # on-time / late-admitted / late-dropped against this record
        self.engine.stats = self.stats

    def _emit_cb(self, payload: Any, ts: int, wm: int,
                 msg_id: Optional[int]) -> None:
        self.emitter.emit(payload, ts, wm, msg_id)

    def process(self, payload, ts, wm, tag):
        if (self.engine.role in (WinRole.WLQ, WinRole.REDUCE)
                and self.op.execution_mode is ExecutionMode.DEFAULT):
            ts = wm  # reference window_replica.hpp:214-217
        self.engine.process(payload, ts, wm, self._emit_cb)

    def on_punctuation(self, wm: int) -> None:
        self.engine.on_watermark(self.cur_wm, self._emit_cb)
        super().on_punctuation(wm)

    def flush_on_termination(self) -> None:
        self.engine.flush(self._emit_cb)
        self.stats.inputs_ignored += self.engine.ignored_tuples

    # -- checkpointing -------------------------------------------------------
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["engine"] = self.engine.snapshot_state()
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        eng = state.get("engine")
        if eng is not None:
            self.engine.restore_state(eng)


class _WindowOperatorBase(BasicOperator):
    op_type = OpType.WIN

    def __init__(self, win_func: Callable, key_extractor: Callable,
                 win_len: int, slide_len: int, win_type: WinType,
                 lateness: int, incremental: bool, initial_value: Any,
                 name: str, parallelism: int, input_routing: RoutingMode,
                 output_batch_size: int, role: WinRole = WinRole.SEQ,
                 tb_origin=None) -> None:
        if win_len <= 0 or slide_len <= 0:
            raise WindFlowError(f"{name}: window length and slide must be > 0")
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.win_func = win_func
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.lateness = lateness
        self.incremental = incremental
        self.initial_value = initial_value
        self.role = role
        # reference-compat TB numbering (wf/window_replica.hpp:253-283):
        # origin-anchored windows with identity-valued empty fires
        self.tb_origin = tb_origin
        n_args = arity(win_func)
        self._riched = n_args >= (3 if incremental else 2)

    @property
    def is_chainable(self) -> bool:
        return False

    def build_replicas(self) -> None:
        self.replicas = [_WindowReplica(self, i) for i in range(self.parallelism)]

    def _make_engine(self, idx: int, context) -> WindowEngine:
        raise NotImplementedError


class Keyed_Windows(_WindowOperatorBase):
    def __init__(self, win_func: Callable, key_extractor: Callable,
                 win_len: int, slide_len: int,
                 win_type: WinType = WinType.CB, lateness: int = 0,
                 incremental: bool = False, initial_value: Any = None,
                 name: str = "keyed_windows", parallelism: int = 1,
                 output_batch_size: int = 0, tb_origin=None) -> None:
        if key_extractor is None:
            raise WindFlowError("Keyed_Windows requires a key extractor")
        super().__init__(win_func, key_extractor, win_len, slide_len, win_type,
                         lateness, incremental, initial_value, name,
                         parallelism, RoutingMode.KEYBY, output_batch_size,
                         WinRole.SEQ, tb_origin)

    def _make_engine(self, idx: int, context) -> WindowEngine:
        return WindowEngine(self.win_type, self.win_len, self.slide_len,
                            self.lateness, self.key_extractor, self.win_func,
                            self.incremental, self.initial_value, WinRole.SEQ,
                            0, 1, 1, 0, self.execution_mode, self._riched,
                            context, tb_origin=self.tb_origin)


class Parallel_Windows(_WindowOperatorBase):
    def __init__(self, win_func: Callable, key_extractor: Callable,
                 win_len: int, slide_len: int,
                 win_type: WinType = WinType.TB, lateness: int = 0,
                 incremental: bool = False, initial_value: Any = None,
                 name: str = "parallel_windows", parallelism: int = 1,
                 output_batch_size: int = 0,
                 role: WinRole = WinRole.SEQ, tb_origin=None) -> None:
        super().__init__(win_func, key_extractor, win_len, slide_len, win_type,
                         lateness, incremental, initial_value, name,
                         parallelism, RoutingMode.BROADCAST, output_batch_size,
                         role, tb_origin)

    def configure(self, execution_mode, time_policy, device) -> None:
        super().configure(execution_mode, time_policy, device)
        # The reference only rejects role SEQ (parallel_windows.hpp:119-123),
        # but PLQ and MAP have the same hazard: count-based assignment uses
        # each broadcast replica's own arrival order, which differs across
        # replicas in DEFAULT mode. All three are refused; WLQ and REDUCE
        # are safe behind the id-sequencing collector.
        if (self.win_type is WinType.CB
                and self.role in (WinRole.SEQ, WinRole.PLQ, WinRole.MAP)
                and execution_mode is ExecutionMode.DEFAULT):
            raise WindFlowError(
                f"{self.name}: count-based windows over BROADCAST "
                "distribution are nondeterministic in DEFAULT mode; use "
                "DETERMINISTIC mode or Keyed_Windows")

    def _make_engine(self, idx: int, context) -> WindowEngine:
        if self.role is WinRole.MAP:
            return WindowEngine(self.win_type, self.win_len, self.slide_len,
                                self.lateness, self.key_extractor,
                                self.win_func, self.incremental,
                                self.initial_value, WinRole.MAP, 0, 1,
                                self.parallelism, idx, self.execution_mode,
                                self._riched, context,
                                tb_origin=self.tb_origin)
        return WindowEngine(self.win_type, self.win_len, self.slide_len,
                            self.lateness, self.key_extractor, self.win_func,
                            self.incremental, self.initial_value, self.role,
                            idx, self.parallelism, 1, 0, self.execution_mode,
                            self._riched, context, tb_origin=self.tb_origin)


def _wrap_stage2_func(user_func: Callable, incremental: bool) -> Callable:
    """Second-stage (WLQ/REDUCE) functions consume the VALUES of first-stage
    WinResults (the reference feeds user result_t objects straight through).
    The wrapper's arity mirrors the user function's so riched (context-taking)
    variants are still detected downstream."""
    riched = arity(user_func) >= (3 if incremental else 2)
    if incremental:
        if riched:
            def wrapped(res, acc, ctx):
                return user_func(res.value, acc, ctx)
        else:
            def wrapped(res, acc):
                return user_func(res.value, acc)
    else:
        if riched:
            def wrapped(results, ctx):
                return user_func([r.value for r in results], ctx)
        else:
            def wrapped(results):
                return user_func([r.value for r in results])
    return wrapped


def _result_key(r: WinResult) -> Any:
    return r.key


class _CompositeWindows(BasicOperator):
    """Two internal Parallel_Windows stages expanded by MultiPipe.add."""

    op_type = OpType.WIN

    def __init__(self, name: str, stage1: Parallel_Windows,
                 stage2: Parallel_Windows) -> None:
        super().__init__(name, stage1.parallelism + stage2.parallelism,
                         RoutingMode.BROADCAST, stage1.key_extractor, 0)
        stage2.collector_override = "id"
        self.sub_operators = [stage1, stage2]

    def build_replicas(self) -> None:  # pragma: no cover - expanded before build
        raise WindFlowError(f"{self.name}: composite operator must be "
                            "expanded by MultiPipe.add")


class Paned_Windows(_CompositeWindows):
    """PLQ over gcd-panes + count-based WLQ over pane results
    (``wf/paned_windows.hpp:67-213``)."""

    def __init__(self, plq_func: Callable, wlq_func: Callable,
                 key_extractor: Callable, win_len: int, slide_len: int,
                 win_type: WinType = WinType.TB, lateness: int = 0,
                 plq_incremental: bool = False, plq_initial: Any = None,
                 wlq_incremental: bool = False, wlq_initial: Any = None,
                 name: str = "paned_windows", plq_parallelism: int = 1,
                 wlq_parallelism: int = 1, output_batch_size: int = 0,
                 tb_origin=None) -> None:
        if win_len <= slide_len:
            raise WindFlowError("Paned_Windows requires sliding windows "
                                "(win_len > slide_len)")
        pane = math.gcd(win_len, slide_len)
        plq = Parallel_Windows(plq_func, key_extractor, pane, pane, win_type,
                               lateness, plq_incremental, plq_initial,
                               name + "_plq", plq_parallelism, 0, WinRole.PLQ,
                               tb_origin)
        wlq = Parallel_Windows(_wrap_stage2_func(wlq_func, wlq_incremental),
                               _result_key, win_len // pane, slide_len // pane,
                               WinType.CB, 0, wlq_incremental, wlq_initial,
                               name + "_wlq", wlq_parallelism,
                               output_batch_size, WinRole.WLQ)
        super().__init__(name, plq, wlq)


class MapReduce_Windows(_CompositeWindows):
    """MAP partitions each window's tuples across replicas by ``ts % p``;
    REDUCE merges the p partials per window
    (``wf/mapreduce_windows.hpp:140-141``)."""

    def __init__(self, map_func: Callable, reduce_func: Callable,
                 key_extractor: Callable, win_len: int, slide_len: int,
                 win_type: WinType = WinType.TB, lateness: int = 0,
                 map_incremental: bool = False, map_initial: Any = None,
                 reduce_incremental: bool = False, reduce_initial: Any = None,
                 name: str = "mapreduce_windows", map_parallelism: int = 1,
                 reduce_parallelism: int = 1,
                 output_batch_size: int = 0, tb_origin=None) -> None:
        map_stage = Parallel_Windows(map_func, key_extractor, win_len,
                                     slide_len, win_type, lateness,
                                     map_incremental, map_initial,
                                     name + "_map", map_parallelism, 0,
                                     WinRole.MAP, tb_origin)
        reduce_stage = Parallel_Windows(
            _wrap_stage2_func(reduce_func, reduce_incremental), _result_key,
            map_parallelism, map_parallelism, WinType.CB, 0,
            reduce_incremental, reduce_initial, name + "_reduce",
            reduce_parallelism, output_batch_size, WinRole.REDUCE)
        super().__init__(name, map_stage, reduce_stage)
