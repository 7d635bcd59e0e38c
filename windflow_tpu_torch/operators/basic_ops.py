"""Map / Filter / FlatMap / Reduce / Sink: the host-plane operators.

Copy of ``windflow_tpu/operators/basic_ops.py`` without exactly-once
sinks (parity: per-tuple semantics, functor variants by
arity):

- Map: ``wf/map.hpp:57-385``. A functor returning ``None`` is treated as
  in-place (the mutated payload is re-emitted); returning a value emits
  that value. ``copy_on_write`` shields broadcast-shared payloads
  (``wf/map.hpp:348``).
- Filter: ``wf/filter.hpp``: a predicate; dropped tuples are counted.
- FlatMap: ``wf/flatmap.hpp`` + ``wf/shipper.hpp:58-182``: the functor
  pushes 0..N results through a Shipper bound to the current (ts, wm).
- Reduce: ``wf/reduce.hpp:57-334``: keyed running state (KEYBY
  mandatory); the updated state is copied and emitted after every update.
- Sink: ``wf/sink.hpp``. A row sink's functor takes one tuple (``None`` at
  EOS); a ``with_columns()`` sink's functor takes whole host column
  batches, ``func(cols, ts)`` (``(None, None)`` at EOS), so a
  device-plane exit never boxes rows.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

from ..basic import OpType, RoutingMode, WindFlowError
from .base import BasicOperator, BasicReplica, arity


class Map(BasicOperator):
    def __init__(self, func: Callable, name: str = "map", parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor: Optional[Callable] = None,
                 output_batch_size: int = 0) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.func = func
        self._riched = arity(func) >= 2

    def build_replicas(self) -> None:
        self.replicas = [MapReplica(self, i) for i in range(self.parallelism)]


class MapReplica(BasicReplica):
    def process(self, payload, ts, wm, tag):
        if self.copy_on_write:
            payload = copy.copy(payload)
        out = (self.op.func(payload, self.context) if self.op._riched
               else self.op.func(payload))
        if out is None:  # in-place variant
            out = payload
        self.emitter.emit(out, ts, wm)


class Filter(BasicOperator):
    def __init__(self, predicate: Callable, name: str = "filter",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor: Optional[Callable] = None,
                 output_batch_size: int = 0) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.predicate = predicate
        self._riched = arity(predicate) >= 2

    def build_replicas(self) -> None:
        self.replicas = [FilterReplica(self, i)
                         for i in range(self.parallelism)]


class FilterReplica(BasicReplica):
    def process(self, payload, ts, wm, tag):
        keep = (self.op.predicate(payload, self.context) if self.op._riched
                else self.op.predicate(payload))
        if keep:
            self.emitter.emit(payload, ts, wm)
        else:
            self.stats.inputs_ignored += 1


class Shipper:
    """Bound to the in-flight tuple's (ts, wm); user pushes 0..N outputs."""

    __slots__ = ("_replica", "_ts", "_wm")

    def __init__(self, replica: "FlatMapReplica") -> None:
        self._replica = replica
        self._ts = 0
        self._wm = 0

    def push(self, payload: Any) -> None:
        self._replica.emitter.emit(payload, self._ts, self._wm)


class FlatMap(BasicOperator):
    def __init__(self, func: Callable, name: str = "flatmap",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor: Optional[Callable] = None,
                 output_batch_size: int = 0) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.func = func
        self._riched = arity(func) >= 3

    def build_replicas(self) -> None:
        self.replicas = [FlatMapReplica(self, i)
                         for i in range(self.parallelism)]


class FlatMapReplica(BasicReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        self.shipper = Shipper(self)

    def process(self, payload, ts, wm, tag):
        self.shipper._ts = ts
        self.shipper._wm = wm
        if self.op._riched:
            self.op.func(payload, self.shipper, self.context)
        else:
            self.op.func(payload, self.shipper)


class Reduce(BasicOperator):
    """``func(tuple, state) -> state`` (or mutate state and return None);
    requires KEYBY routing; not chainable (``wf/multipipe.hpp:1058-1060``)."""

    def __init__(self, func: Callable, key_extractor: Callable,
                 initial_state: Any = None, name: str = "reduce",
                 parallelism: int = 1, output_batch_size: int = 0) -> None:
        if key_extractor is None:
            raise WindFlowError("Reduce requires a key extractor (KEYBY)")
        super().__init__(name, parallelism, RoutingMode.KEYBY, key_extractor,
                         output_batch_size)
        self.func = func
        self.initial_state = initial_state
        self._riched = arity(func) >= 3

    @property
    def is_chainable(self) -> bool:
        return False

    def build_replicas(self) -> None:
        self.replicas = [ReduceReplica(self, i)
                         for i in range(self.parallelism)]


class ReduceReplica(BasicReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        self.key_state = {}

    def process(self, payload, ts, wm, tag):
        key = self.op.key_extractor(payload)
        state = self.key_state.get(key)
        if state is None:
            state = copy.deepcopy(self.op.initial_state)
        out = (self.op.func(payload, state, self.context) if self.op._riched
               else self.op.func(payload, state))
        if out is not None:
            state = out
        self.key_state[key] = state
        self.emitter.emit(copy.copy(state), ts, wm)

    # -- checkpointing -------------------------------------------------------
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["key_state"] = self.key_state
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        self.key_state = dict(state.get("key_state", {}))


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
