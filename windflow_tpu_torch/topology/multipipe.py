"""MultiPipe: the linear-pipeline builder.

Trimmed copy of ``windflow_tpu/topology/multipipe.py`` (parity:
``wf/multipipe.hpp`` ``add`` / ``chain`` / ``add_sink`` / ``chain_sink``).
The port runs linear graphs; split, select and merge are not ported yet
and raise.
"""

from __future__ import annotations

from ..basic import OpType, WindFlowError
from ..operators.base import BasicOperator
from .stage import Stage, UpstreamEdge


class MultiPipe:
    def __init__(self, graph: "PipeGraph") -> None:  # noqa: F821
        self.graph = graph
        self.tail: Stage = None  # the open tail stage
        self.has_sink = False

    def _check_open(self, what: str) -> None:
        if self.has_sink:
            raise WindFlowError(f"cannot {what}: MultiPipe already has a sink")
        if self.tail is None:
            raise WindFlowError(f"cannot {what}: empty MultiPipe")

    def _claim(self, op: BasicOperator) -> None:
        if op._used:
            raise WindFlowError(
                f"operator {op.name!r} was already added to a MultiPipe")
        op._used = True
        self.graph._register_op(op)

    def add(self, op: BasicOperator) -> "MultiPipe":
        """New stage connected from the open tail."""
        self._check_open("add")
        self._claim(op)
        stage = Stage(op)
        if self.tail.downstream is not None:
            raise WindFlowError("tail stage already connected")
        self.tail.downstream = stage
        stage.upstreams.append(UpstreamEdge(self.tail))
        self.graph._stages.append(stage)
        self.tail = stage
        if op.op_type == OpType.SINK:
            self.has_sink = True
        return self

    def chain(self, op: BasicOperator) -> "MultiPipe":
        """Chain into the tail stage's thread (for consecutive device
        operators: fuse into its replica, ``topology/stage.py`` rules)
        when legal, else ``add`` (reference behavior,
        ``wf/multipipe.hpp:1050-1100``). A refused chain records WHY on the
        fallback stage (``Stage.chain_refused``)."""
        self._check_open("chain")
        reason = self.tail.chain_refusal(op, self.graph.fusion)
        if reason is None:
            self._claim(op)
            self.tail.ops.append(op)
            if op.op_type == OpType.SINK:
                self.has_sink = True
            return self
        self.add(op)
        self.tail.chain_refused = reason
        return self

    def add_sink(self, op: BasicOperator) -> "MultiPipe":
        if op.op_type != OpType.SINK:
            raise WindFlowError("add_sink requires a Sink operator")
        return self.add(op)

    def chain_sink(self, op: BasicOperator) -> "MultiPipe":
        if op.op_type != OpType.SINK:
            raise WindFlowError("chain_sink requires a Sink operator")
        return self.chain(op)

    def split(self, *args, **kwargs):
        raise WindFlowError("split is not yet ported to windflow_tpu_torch")

    def select(self, *args, **kwargs):
        raise WindFlowError("select is not yet ported to windflow_tpu_torch")

    def merge(self, *others):
        raise WindFlowError("merge is not yet ported to windflow_tpu_torch")
