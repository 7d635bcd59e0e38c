"""Sink operator (reference ``wf/sink.hpp``).

Trimmed copy of the ``Sink`` section of ``windflow_tpu/operators/
basic_ops.py`` (no exactly-once variants). A row sink's functor takes one
tuple (``None`` at EOS); a ``with_columns()`` sink's functor takes whole
host column batches, ``func(cols, ts)`` (``(None, None)`` at EOS), so a
device-plane exit never boxes rows.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..basic import OpType, RoutingMode, WindFlowError
from .base import BasicOperator, BasicReplica, arity


class Sink(BasicOperator):
    op_type = OpType.SINK

    def __init__(self, func: Callable, name: str = "sink",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor: Optional[Callable] = None,
                 accepts_columns: bool = False) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor, 0)
        self.func = func
        self.accepts_columns = accepts_columns
        self._riched = arity(func) >= (3 if accepts_columns else 2)

    def build_replicas(self) -> None:
        cls = ColumnarSinkReplica if self.accepts_columns else SinkReplica
        self.replicas = [cls(self, i) for i in range(self.parallelism)]


class SinkReplica(BasicReplica):
    def process(self, payload, ts, wm, tag):
        if self.op._riched:
            self.op.func(payload, self.context)
        else:
            self.op.func(payload)

    def flush_on_termination(self) -> None:
        if self.op._riched:
            self.op.func(None, self.context)
        else:
            self.op.func(None)


class ColumnarSinkReplica(BasicReplica):
    """Consumes whole device batches as host COLUMN dicts — one functor
    call per batch, no per-row Python objects on the exit path."""

    def handle_msg(self, ch: int, msg: Any) -> None:
        from ..gpu.batch import BatchGPU
        self.stats.start_svc()
        n = 1
        if msg.is_punct:
            self.stats.punct_received += 1
            self._advance_wm(msg.wm)
            self.on_punctuation(msg.wm)
        else:
            if not isinstance(msg, BatchGPU):
                raise WindFlowError(
                    f"{self.op.name}: with_columns sink received a row "
                    f"message ({type(msg).__name__}); columnar sinks "
                    "consume device batches")
            n = msg.size
            self.stats.inputs_received += n
            self._advance_wm(msg.wm)
            cols = {name: col[:n] for name, col in msg.host_columns().items()}
            ts = msg.ts_host[:n]
            self.context._set_meta(int(ts[-1]) if n else 0, self.cur_wm)
            if self.op._riched:
                self.op.func(cols, ts, self.context)
            else:
                self.op.func(cols, ts)
        self.stats.end_svc(n)

    def flush_on_termination(self) -> None:
        if self.op._riched:
            self.op.func(None, None, self.context)
        else:
            self.op.func(None, None)
