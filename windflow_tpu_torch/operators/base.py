"""Operator and replica base classes.

Copy of ``windflow_tpu/operators/base.py``. Parity:
``wf/basic_operator.hpp`` — an operator is metadata plus a vector of
replicas; each replica is one chain node with the ``svc()`` hot loop,
emitter wiring, punctuation handling and stats. Riched vs non-riched
functors are told apart by arity. The ``device`` an operator runs on, the
graph's latency sampling rate and watermark stall threshold are set by
the graph at build time (``configure``). A replica forwards a traced
message's origin stamp to its emitter and, on a sink, records the
end-to-end latency (``monitoring/tracing.py``).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, List, Optional

import torch

from ..basic import (ExecutionMode, OpType, RoutingMode, TimePolicy,
                     WindFlowError, as_key_fn, current_time_usecs,
                     key_field_name, key_fields_names)
from ..context import RuntimeContext
from ..message import Batch
from ..monitoring.stats import StatsRecord
from ..monitoring.tracing import resolve_sample_every
from ..runtime.emitters import BasicEmitter


def arity(fn: Callable) -> int:
    """Number of REQUIRED positional parameters of a user functor (drives
    the riched/non-riched variant choice); -1 for ``*args``."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return -1
    n = 0
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            if p.default is inspect.Parameter.empty:
                n += 1
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            return -1
    return n


class BasicOperator:
    """Metadata + replicas. Subclasses create their replica list in
    ``build_replicas`` (called by the topology layer at build time)."""

    op_type: OpType = OpType.BASIC

    def __init__(self, name: str, parallelism: int,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor: Optional[Callable[[Any], Any]] = None,
                 output_batch_size: int = 0) -> None:
        if parallelism < 1:
            raise WindFlowError(f"operator {name}: parallelism must be >= 1")
        self.name = name
        self.parallelism = parallelism
        self.input_routing = input_routing
        self.key_field = key_field_name(key_extractor)
        self.key_fields = key_fields_names(key_extractor)
        self.key_extractor = as_key_fn(key_extractor)
        self.output_batch_size = output_batch_size
        self.closing_func: Optional[Callable] = None
        # per-record error policy (supervision/errors.py; None = FAIL)
        self.error_policy = None
        # latency-tracing interval (with_latency_tracing; None = the
        # graph's latency_sample, set at configure) and flight-recorder
        # ring capacity (with_flight_recorder; None = the graph's)
        self.latency_sample: Optional[int] = None
        self.graph_latency_sample = 0
        self.flightrec_events: Optional[int] = None
        self.wm_stall_sec: Optional[float] = None
        self.replicas: List["BasicReplica"] = []
        self.execution_mode = ExecutionMode.DEFAULT
        self.time_policy = TimePolicy.INGRESS_TIME
        self.device = torch.device("cpu")
        self._used = False  # operators are claimed by one MultiPipe

    def build_replicas(self) -> None:
        raise NotImplementedError

    def configure(self, execution_mode: ExecutionMode,
                  time_policy: TimePolicy, device: torch.device) -> None:
        """Called by the topology layer before build_replicas."""
        self.execution_mode = execution_mode
        self.time_policy = time_policy
        self.device = device

    @property
    def is_chainable(self) -> bool:
        return self.input_routing in (RoutingMode.FORWARD, RoutingMode.NONE)


class BasicReplica:
    """One execution unit: ``handle_msg(ch, msg)`` / ``terminate()``."""

    def __init__(self, op: BasicOperator, idx: int) -> None:
        self.op = op
        self.idx = idx
        self.context = RuntimeContext(op.parallelism, idx)
        self.stats = StatsRecord(op.name, idx,
                                 sample_every=resolve_sample_every(op),
                                 wm_stall_sec=op.wm_stall_sec)
        self.emitter: Optional[BasicEmitter] = None
        # end-to-end recording hook: a SINK replica binds it to its stats
        # histogram when sampling is on; None keeps the per-message check
        # to one attribute load
        self._e2e = None
        self.terminated = False
        self.cur_wm = 0
        self.copy_on_write = False  # set when fed by a broadcast emitter
        # a non-FAIL error policy shadows ``process`` with a guarded
        # wrapper (an instance attribute); the FAIL default leaves the
        # class method untouched
        pol = op.error_policy
        if pol is not None and not pol.is_fail:
            from ..supervision.errors import make_guarded_process
            self.process = make_guarded_process(self, pol)

    def set_emitter(self, emitter: BasicEmitter) -> None:
        self.emitter = emitter
        emitter.set_stats(self.stats)

    def handle_msg(self, ch: int, msg: Any) -> None:
        self.stats.start_svc()
        n = 1
        if msg.is_punct:
            st = self.stats
            st.punct_received += 1
            self._advance_wm(msg.wm)
            # wm:advance spans ride punctuations only (bounded rate)
            if st.recorder is not None and msg.wm >= self.cur_wm:
                st.recorder.event("wm:advance", 0.0, self.cur_wm)
            self.on_punctuation(msg.wm)
        elif isinstance(msg, Batch):
            n = msg.size
            self.stats.inputs_received += n
            self._advance_wm(msg.wm)
            tag = msg.stream_tag
            t0 = msg.trace_min
            if t0:  # traced batch: forward the stamp / record at sinks
                self.stats._svc_rec = True
                if self._e2e is not None:
                    now = current_time_usecs()
                    self._e2e.record(now - msg.trace_max)
                    if msg.trace_max != t0:
                        self._e2e.record(now - t0)
                em = self.emitter
                if em is not None:
                    em.trace_ts = t0
            for payload, ts in msg.rows:
                self.context._set_meta(ts, self.cur_wm)
                self.process(payload, ts, self.cur_wm, tag)
            if t0:
                em = self.emitter
                if em is not None:
                    em.trace_ts = 0
        else:
            self.stats.inputs_received += 1
            self._advance_wm(msg.wm)
            t0 = msg.trace_ts
            if t0:  # traced tuple: forward the stamp / record at sinks
                self.stats._svc_rec = True
                if self._e2e is not None:
                    self._e2e.record(current_time_usecs() - t0)
                em = self.emitter
                if em is not None:
                    em.trace_ts = t0
            self.context._set_meta(msg.ts, self.cur_wm)
            self.process(msg.payload, msg.ts, self.cur_wm, msg.stream_tag)
            if t0:
                em = self.emitter
                if em is not None:
                    em.trace_ts = 0  # a dropped tuple stamps no later one
        self.stats.end_svc(n)

    def _advance_wm(self, wm: int) -> None:
        if wm > self.cur_wm:
            self.cur_wm = wm
            self.stats.wm_current = wm
            self.stats.wm_advances += 1

    def process(self, payload: Any, ts: int, wm: int, tag: int) -> None:
        raise NotImplementedError

    def on_punctuation(self, wm: int) -> None:
        """Default: forward the watermark downstream (the replica owns
        punctuation propagation, ``wf/basic_operator.hpp:180-189``)."""
        if self.emitter is not None:
            self.emitter.propagate_punctuation(self.cur_wm)

    def flush_on_termination(self) -> None:
        """Emit pending state at EOS (window operators override)."""

    # -- checkpointing (aligned snapshots, windflow_tpu_torch.checkpoint) ----
    def snapshot_state(self) -> dict:
        """This replica's processing state as a picklable dict of Python
        values and numpy arrays (never tensors: a checkpoint taken on a
        card restores on the CPU and the other way round). Called on the
        replica's own worker thread at an aligned barrier; stateful
        subclasses extend the base dict via ``super()``."""
        return {"cur_wm": self.cur_wm}

    def restore_state(self, state: dict) -> None:
        """Inverse of ``snapshot_state``; called after the graph is wired
        and before any worker starts."""
        self.cur_wm = state.get("cur_wm", 0)
        self.stats.wm_current = self.cur_wm

    def terminate(self) -> None:
        if self.terminated:
            return
        self.terminated = True
        self.flush_on_termination()
        if self.op.closing_func is not None:
            if arity(self.op.closing_func) >= 1:
                self.op.closing_func(self.context)
            else:
                self.op.closing_func()
        if self.emitter is not None:
            self.emitter.flush()
        self.stats.is_terminated = True
