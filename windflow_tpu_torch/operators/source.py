"""Source operators and the Source_Shipper.

Trimmed copy of ``windflow_tpu/operators/source.py`` (no admission gate,
no latency stamps). Parity:
``wf/source.hpp:55-163`` and ``wf/source_shipper.hpp``: ``push`` for
INGRESS_TIME, ``push_with_timestamp``/``set_next_watermark`` for
EVENT_TIME, plus the columnar ``push_columns`` fast path and the block
source ``Columnar_Source`` whose functor yields column blocks (without the
JAX package's block re-chunking and dtype declaration). With
checkpointing on, a source replica injects the checkpoint barrier at its
next push boundary (before the tuple, or before the block: a columnar
source's barriers land only between blocks), and its snapshot records the
functor's replay position (``snapshot_position()`` / ``restore(pos)``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ..basic import (ExecutionMode, OpType, RoutingMode, TimePolicy,
                     WindFlowError, current_time_usecs)
from .base import BasicOperator, BasicReplica, arity


class SourceShipper:
    """User-visible push API for Source functors."""

    def __init__(self, replica: "SourceReplica") -> None:
        self._r = replica
        self._next_wm = 0
        self._epoch = current_time_usecs()

    def push(self, payload: Any) -> None:
        if self._r.op.time_policy is not TimePolicy.INGRESS_TIME:
            raise WindFlowError("push() requires INGRESS_TIME; use "
                                "push_with_timestamp() under EVENT_TIME")
        ts = current_time_usecs() - self._epoch
        wm = ts if self._r.op.execution_mode is ExecutionMode.DEFAULT else 0
        self._r.ship(payload, ts, wm)

    def push_with_timestamp(self, payload: Any, ts: int) -> None:
        if self._r.op.time_policy is not TimePolicy.EVENT_TIME:
            raise WindFlowError("push_with_timestamp() requires EVENT_TIME")
        ts = int(ts)
        st = self._r.stats
        if ts > st.wm_max_source_ts:
            st.wm_max_source_ts = ts
        self._r.ship(payload, ts, self._next_wm)

    def set_next_watermark(self, wm: int) -> None:
        if wm < self._next_wm:
            raise WindFlowError("watermarks must be non-decreasing")
        self._next_wm = int(wm)

    def push_columns(self, cols, ts=None) -> None:
        """Push a whole COLUMN BATCH (dict of equal-length 1-D numpy
        arrays) in one call; on a device edge no per-tuple Python runs.
        EVENT_TIME requires ``ts`` (int64 array, same length)."""
        n = -1
        for v in cols.values():
            if n < 0:
                n = len(v)
            elif len(v) != n:
                raise WindFlowError("push_columns: ragged columns")
        if n <= 0:
            return
        if self._r.op.time_policy is TimePolicy.INGRESS_TIME:
            if ts is not None:
                raise WindFlowError("push_columns(ts=...) requires "
                                    "EVENT_TIME")
            now = current_time_usecs() - self._epoch
            ts_arr = np.full(n, now, dtype=np.int64)
            wm = (now if self._r.op.execution_mode is ExecutionMode.DEFAULT
                  else 0)
        else:
            if ts is None:
                raise WindFlowError("push_columns under EVENT_TIME needs a "
                                    "ts array")
            ts_arr = np.asarray(ts, dtype=np.int64)
            if len(ts_arr) != n:
                raise WindFlowError("push_columns: ts length mismatch")
            st = self._r.stats
            m = int(ts_arr.max())
            if m > st.wm_max_source_ts:
                st.wm_max_source_ts = m
            wm = self._next_wm
        self._r.ship_columns(cols, ts_arr, wm)

    # -- checkpointing -----------------------------------------------------
    def request_checkpoint(self) -> Optional[int]:
        """Force an aligned checkpoint NOW (at this tuple boundary) instead
        of waiting for the coordinator's interval. Returns the new
        checkpoint id, or None when checkpointing is not enabled."""
        return self._r.request_checkpoint()

    @property
    def current_watermark(self) -> int:
        return self._next_wm


class Source(BasicOperator):
    """Parallel replicas are independent generators; ``func(shipper[, ctx])``
    is called once per replica and runs its own loop."""

    op_type = OpType.SOURCE

    def __init__(self, func: Callable, name: str = "source",
                 parallelism: int = 1, output_batch_size: int = 0) -> None:
        super().__init__(name, parallelism, RoutingMode.NONE,
                         output_batch_size=output_batch_size)
        self.func = func
        self._riched = arity(func) >= 2

    def build_replicas(self) -> None:
        self.replicas = [SourceReplica(self, i)
                         for i in range(self.parallelism)]


class SourceReplica(BasicReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        # aligned checkpointing: the coordinator bumps an epoch; we notice
        # at the next push boundary, snapshot our replay position and
        # inject the barrier downstream
        self._coord = None
        self._inject_cb = None  # Worker.checkpoint_now (chain-wide)
        self._last_ckpt = 0
        self._restore_position = None

    def process(self, payload, ts, wm, tag):  # pragma: no cover
        raise WindFlowError("Source has no input")

    # -- checkpointing -----------------------------------------------------
    def bind_checkpoint(self, coordinator, inject_cb) -> None:
        """Wired by the source Worker when checkpointing is enabled."""
        self._coord = coordinator
        self._inject_cb = inject_cb
        self._last_ckpt = coordinator.requested_id

    def request_checkpoint(self) -> Optional[int]:
        if self._coord is None:
            return None
        cid = self._coord.trigger(force=True)
        self._maybe_inject()
        return cid

    def _maybe_inject(self) -> None:
        from ..message import Barrier
        cid = self._coord.requested_id
        if cid > self._last_ckpt:
            self._last_ckpt = cid
            self._inject_cb(Barrier(cid))

    def final_checkpoint(self) -> None:
        """Called by the worker when the generation loop ends, before the
        EOS cascade: an epoch opened while we were finishing still gets
        this source's barrier and (final) position snapshot."""
        if self._coord is not None:
            self._maybe_inject()

    def snapshot_state(self) -> dict:
        """Base state plus the functor's replay position when it speaks
        the replayable protocol: ``snapshot_position([ctx])`` returning any
        picklable cursor, and ``restore(position[, ctx])`` on restart. The
        position must describe exactly the tuples pushed so far — barriers
        inject at push boundaries, so a one-tuple-per-increment cursor
        gives an exact resume."""
        st = super().snapshot_state()
        st["shipped"] = self.stats.inputs_received
        snap = getattr(self.op.func, "snapshot_position", None)
        if snap is not None:
            st["position"] = (snap(self.context) if arity(snap) >= 1
                              else snap())
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        self._restore_position = state.get("position")
        self.stats.inputs_received = state.get("shipped", 0)

    def run_source(self) -> None:
        """Run the user generation loop to completion (the worker then
        triggers the EOS cascade, ``wf/source.hpp:114-129``), after
        moving a restored functor back to its snapshot position."""
        if self._restore_position is not None:
            restore = getattr(self.op.func, "restore", None)
            if restore is None:
                raise WindFlowError(
                    f"{self.op.name}: checkpoint restore needs a replayable "
                    "source functor (snapshot_position()/restore(position)); "
                    "this one has no restore()")
            if arity(restore) >= 2:
                restore(self._restore_position, self.context)
            else:
                restore(self._restore_position)
        self._drive(SourceShipper(self))

    def _drive(self, shipper: SourceShipper) -> None:
        if self.op._riched:
            self.op.func(shipper, self.context)
        else:
            self.op.func(shipper)

    def ship(self, payload: Any, ts: int, wm: int) -> None:
        # barrier BEFORE the tuple: the functor's cursor has not advanced
        # past the tuple being pushed (the natural ``v = pos; push(v);
        # pos += 1`` style), so the snapshot position covers exactly the
        # tuples already emitted and this one replays after a restore
        if self._coord is not None \
                and self._coord.requested_id != self._last_ckpt:
            self._maybe_inject()
        self._advance_wm(wm)
        self.stats.inputs_received += 1
        self.emitter.emit(payload, ts, self.cur_wm)

    def ship_columns(self, cols, ts_arr, wm: int) -> None:
        # before the block, like ship(): a block is never split by a
        # barrier, so a block-granular cursor stays exact
        if self._coord is not None \
                and self._coord.requested_id != self._last_ckpt:
            self._maybe_inject()
        self._advance_wm(wm)
        n = len(ts_arr)
        self.stats.inputs_received += n
        self.emitter.emit_columns(cols, ts_arr, self.cur_wm)
        self.stats.note_ingest_block(n)


class Columnar_Source(Source):
    """BLOCK source: the functor, called as ``func([ctx])``, is a generator
    of column blocks: ``cols`` (INGRESS_TIME), ``(cols, ts)`` (EVENT_TIME)
    or ``(cols, ts, wm)`` (also advances the watermark before the push)."""

    def __init__(self, func: Callable, name: str = "columnar_source",
                 parallelism: int = 1, output_batch_size: int = 0) -> None:
        super().__init__(func, name, parallelism, output_batch_size)
        self._riched = arity(func) >= 1

    def build_replicas(self) -> None:
        self.replicas = [ColumnarSourceReplica(self, i)
                         for i in range(self.parallelism)]


class ColumnarSourceReplica(SourceReplica):
    def _drive(self, shipper: SourceShipper) -> None:
        op = self.op
        it = op.func(self.context) if op._riched else op.func()
        if it is None:
            return
        for block in it:
            cols, ts, wm = _normalize_block(block)
            if wm is not None:
                shipper.set_next_watermark(int(wm))
            shipper.push_columns(cols, ts)


def _normalize_block(block):
    """(cols, ts_or_None, wm_or_None) from a block functor yield."""
    if isinstance(block, dict):
        return block, None, None
    if isinstance(block, tuple):
        if len(block) == 2:
            return block[0], block[1], None
        if len(block) == 3:
            return block
    raise WindFlowError(
        "Columnar_Source functor must yield cols dicts or "
        "(cols, ts[, wm]) tuples, got " + type(block).__name__)
