"""Source operators and the Source_Shipper.

Copy of ``windflow_tpu/operators/source.py``. Parity:
``wf/source.hpp:55-163`` and ``wf/source_shipper.hpp``: ``push`` for
INGRESS_TIME, ``push_with_timestamp``/``set_next_watermark`` for
EVENT_TIME, plus the columnar ``push_columns`` fast path and the block
source ``Columnar_Source`` whose functor yields column blocks, re-chunked
to its ``block_size`` and cast to its ``schema``. With checkpointing on, a
source replica injects the checkpoint barrier at its next push boundary
(before the tuple, or before the block: a columnar source's barriers land
only between the functor's yields), and its snapshot records the
functor's replay position (``snapshot_position()`` / ``restore(pos)``).
``ArrayBlockSource`` is a replayable block functor over numpy columns,
``arrow_block_source`` one over a pyarrow table (when pyarrow is
installed).

A source replica stamps every Nth shipped tuple with its latency-tracing
origin (``monitoring/tracing.py``; a block stamps the same cohort as the
row path would). While the overload governor sheds
(``PipeGraph.with_slo``), an ``AdmissionGate`` sits in ``ship`` /
``ship_columns`` BEFORE the emitter, the barriers and the exactly-once
plane, so a shed record never enters a channel, a snapshot or a sink
transaction; records the gate buffered ride the snapshot
(``gate_pending``) and re-emit on restore.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

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
        # sampled latency tracing: every Nth shipped tuple carries a
        # wall-clock origin stamp. One integer AND against this mask
        # (sample_every is a power of two; -1 = off never makes the AND
        # zero), so the gate costs the same with tracing off or on
        self._trace_mask = self.stats.sample_every - 1
        # overload admission control (overload/): the governor installs
        # an AdmissionGate here while shedding; one is-None check per push
        self._gate = None
        # records buffered in a gate at snapshot time: restore stashes
        # them, run_source re-emits them before the functor resumes
        self._restore_gate_pending = None
        # aligned checkpointing: the coordinator bumps an epoch; we notice
        # at the next push boundary, snapshot our replay position and
        # inject the barrier downstream
        self._coord = None
        self._inject_cb = None  # Worker.checkpoint_now (chain-wide)
        self._last_ckpt = 0
        self._restore_position = None
        # set between the chunks of one re-chunked yield: a barrier lands
        # only at a functor-yield boundary (Columnar_Source.block_size)
        self._inject_suppressed = False

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
        """Inject the barrier of EVERY epoch opened since the last one,
        in order, all at this boundary: the aligners downstream count a
        barrier per channel without reading its id, so a source that
        skipped an epoch another source injected would close that epoch's
        alignment with the wrong barrier, and the cut would mix epochs
        (overlapping forced epochs from several sources)."""
        from ..message import Barrier
        cid = self._coord.requested_id
        while self._last_ckpt < cid:
            self._last_ckpt += 1
            self._inject_cb(Barrier(self._last_ckpt))

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
        # shed accounting rides the snapshot: a restore must not zero the
        # counters of records that are gone for good
        st["shed_records"] = self.stats.shed_records
        st["shed_bytes"] = self.stats.shed_bytes
        snap = getattr(self.op.func, "snapshot_position", None)
        if snap is not None:
            st["position"] = (snap(self.context) if arity(snap) >= 1
                              else snap())
        gate = self._gate
        if gate is not None and gate.pending:
            # accepted into the gate, still awaiting tokens: the position
            # already covers them, so they ride the snapshot (dropping
            # them would lose records neither admitted nor shed)
            st["gate_pending"] = gate.snapshot_pending()
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        self._restore_position = state.get("position")
        self._restore_gate_pending = state.get("gate_pending")
        self.stats.inputs_received = state.get("shipped", 0)
        self.stats.shed_records = state.get("shed_records", 0)
        self.stats.shed_bytes = state.get("shed_bytes", 0)

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
        pend = self._restore_gate_pending
        if pend:
            # records a snapshot caught in a gate's buffer: the restored
            # cursor is past them, so they re-emit (with their accept-time
            # watermarks) ahead of everything the replay produces
            self._restore_gate_pending = None
            for p, t, w in pend:
                self._advance_wm(w)
                self._emit_admitted(p, t)
        self._drive(SourceShipper(self))
        gate = self._gate
        if gate is not None and gate.pending:
            # end of stream with records still buffered: they were
            # ACCEPTED (only awaiting tokens), so they emit
            for p, t, w in gate.drain_pending():
                self._advance_wm(w)
                self._emit_admitted(p, t)

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
        gate = self._gate
        if gate is not None:
            # the watermark rides each record through the gate: while
            # records wait in its buffer cur_wm must not pass them
            for p, t, w in gate.offer(payload, ts, wm):
                self._advance_wm(w)
                self._emit_admitted(p, t)
            if gate.released and not gate.pending:
                self._gate = None  # recovery: back to the ungated path
            return
        self._advance_wm(wm)
        self._emit_admitted(payload, ts)

    def _emit_admitted(self, payload: Any, ts: int) -> None:
        st = self.stats
        st.inputs_received += 1
        if not (st.inputs_received & self._trace_mask):
            self.emitter.trace_ts = current_time_usecs()
        self.emitter.emit(payload, ts, self.cur_wm)

    def ship_columns(self, cols, ts_arr, wm: int) -> None:
        t0_ns = time.perf_counter_ns()
        # before the block, like ship(): a block is never split by a
        # barrier, so a block-granular cursor stays exact
        if self._coord is not None and not self._inject_suppressed \
                and self._coord.requested_id != self._last_ckpt:
            self._maybe_inject()
        gate = self._gate
        if gate is not None:
            if gate.pending:
                # row-path records buffered in the gate precede this block
                for p, t, w in gate.drain_pending():
                    self._advance_wm(w)
                    self._emit_admitted(p, t)
            if gate.released:
                self._gate = None  # recovery: back to the ungated path
            else:
                cols, ts_arr, n = gate.offer_columns(cols, ts_arr)
                if n == 0:
                    return
        self._advance_wm(wm)
        st = self.stats
        n = len(ts_arr)
        base = st.inputs_received
        st.inputs_received = base + n
        trace_rows = None
        se = st.sample_every
        if se:
            # the traced rows are exactly the ones the row path would
            # stamp (global positions base+1+i that are multiples of
            # sample_every), sharing one stamp
            first = (-(base + 1)) % se
            if first < n:
                trace_rows = np.arange(first, n, se)
                self.emitter.trace_ts = current_time_usecs()
        self.emitter.emit_columns(cols, ts_arr, self.cur_wm, trace_rows)
        st.note_ingest_block(n, time.perf_counter_ns() - t0_ns)


class Columnar_Source(Source):
    """BLOCK source: the functor, called as ``func([ctx])``, is a generator
    of column blocks: ``cols`` (INGRESS_TIME), ``(cols, ts)`` (EVENT_TIME)
    or ``(cols, ts, wm)`` (also advances the watermark before the push).

    ``block_size`` (builder: ``with_block_size``; the JAX package's
    ``WF_INGEST_BLOCK_ROWS``; 0 = off) re-chunks oversized yields;
    barriers still land only at functor-yield boundaries, so a replayable
    functor's block-granular cursor stays exact. ``schema`` (name -> numpy
    dtype) casts each declared column at the edge."""

    def __init__(self, func: Callable, name: str = "columnar_source",
                 parallelism: int = 1, output_batch_size: int = 0,
                 block_size: int = 0,
                 schema: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(func, name, parallelism, output_batch_size)
        self.block_size = max(0, int(block_size))
        self.block_schema = ({k: np.dtype(v) for k, v in schema.items()}
                             if schema else None)
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
        bs = op.block_size
        schema = op.block_schema
        for block in it:
            cols, ts, wm = _normalize_block(block)
            if schema is not None:
                # asarray copies nothing when the dtype already matches
                cols = {k: (np.asarray(v, dtype=schema[k])
                            if k in schema else v)
                        for k, v in cols.items()}
            if wm is not None:
                shipper.set_next_watermark(int(wm))
            n = len(next(iter(cols.values()))) if cols else 0
            if not bs or n <= bs:
                shipper.push_columns(cols, ts)
                continue
            # re-chunk to the declared block size with barrier injection
            # suppressed between the chunks: the functor's cursor covers
            # whole yields, so a barrier between chunks would emit the
            # leading chunks twice after a restore
            try:
                for off in range(0, n, bs):
                    end = min(off + bs, n)
                    shipper.push_columns(
                        {k: v[off:end] for k, v in cols.items()},
                        ts[off:end] if ts is not None else None)
                    self._inject_suppressed = True
            finally:
                self._inject_suppressed = False


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


class ArrayBlockSource:
    """Replayable block functor over in-memory numpy columns: yields
    ``block_size``-row slices (with their timestamps when ``ts`` is
    given). The cursor advances AFTER each yield, so a barrier injected
    at the push snapshots a position covering exactly the blocks already
    shipped; the block in flight replays after a restore."""

    def __init__(self, cols: Dict[str, Any], ts: Optional[Any] = None,
                 block_size: int = 8192) -> None:
        if block_size <= 0:
            raise WindFlowError("ArrayBlockSource: block_size must be > 0")
        self._cols = {k: np.asarray(v) for k, v in cols.items()}
        n = -1
        for v in self._cols.values():
            if n < 0:
                n = len(v)
            elif len(v) != n:
                raise WindFlowError("ArrayBlockSource: ragged columns")
        self._ts = None if ts is None else np.asarray(ts, dtype=np.int64)
        if self._ts is not None and len(self._ts) != max(n, 0):
            raise WindFlowError("ArrayBlockSource: ts length mismatch")
        self._n = max(n, 0)
        self._bs = block_size
        self._pos = 0

    def __call__(self):
        while self._pos < self._n:
            lo = self._pos
            hi = min(lo + self._bs, self._n)
            cols = {k: v[lo:hi] for k, v in self._cols.items()}
            if self._ts is None:
                yield cols
            else:
                yield cols, self._ts[lo:hi]
            self._pos = hi

    # the replayable-source protocol (a block-granular cursor)
    def snapshot_position(self) -> int:
        return self._pos

    def restore(self, position: int) -> None:
        self._pos = int(position)


def arrow_block_source(table, ts_column: Optional[str] = None,
                       block_size: int = 8192) -> ArrayBlockSource:
    """Block functor over a pyarrow Table / RecordBatch: the columns
    convert to numpy once (zero-copy where the Arrow layout allows) and
    stream as ``ArrayBlockSource`` blocks. Needs pyarrow."""
    try:
        import pyarrow  # noqa: F401
    except Exception as exc:
        raise WindFlowError(
            "arrow_block_source requires pyarrow, which is not "
            "available in this environment") from exc
    tbl = table.combine_chunks() if hasattr(table, "combine_chunks") else table
    cols = {}
    for name in tbl.schema.names:
        col = tbl.column(name) if hasattr(tbl, "column") else tbl[name]
        try:
            cols[name] = col.to_numpy(zero_copy_only=True)
        except Exception:
            cols[name] = col.to_numpy(zero_copy_only=False)
    ts = cols.pop(ts_column) if ts_column else None
    return ArrayBlockSource(cols, ts, block_size)
