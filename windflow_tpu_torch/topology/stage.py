"""Internal graph IR: Stage = one (possibly chained) operator group.

Trimmed copy of ``windflow_tpu/topology/stage.py``. The topology is a plain
DAG of stages with the reference's semantics: same-parallelism FORWARD
edges are one-to-one (``wf/multipipe.hpp:481-496``), other edges connect
every producer replica to every consumer replica with the emitter chosen
by the consumer's routing; host operators with FORWARD input may chain
into their predecessor's thread. Device-chain fusion is not ported: device
and host operators never share a stage, and two device operators never
chain.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..basic import OpType, RoutingMode
from ..operators.base import BasicOperator


class UpstreamEdge:
    """Producer side of an edge into a stage."""

    __slots__ = ("stage",)

    def __init__(self, stage: "Stage") -> None:
        self.stage = stage


class Stage:
    _next_id = 0

    def __init__(self, op: BasicOperator) -> None:
        self.id = Stage._next_id
        Stage._next_id += 1
        self.ops: List[BasicOperator] = [op]  # chained operators, in order
        self.upstreams: List[UpstreamEdge] = []
        self.downstream: Optional["Stage"] = None
        self.chain_refused: Optional[str] = None
        self.channels: List[Any] = []  # one Channel per replica
        self.workers: List[Any] = []

    @property
    def first_op(self) -> BasicOperator:
        return self.ops[0]

    @property
    def last_op(self) -> BasicOperator:
        return self.ops[-1]

    @property
    def parallelism(self) -> int:
        return self.ops[0].parallelism

    @property
    def is_source(self) -> bool:
        return self.first_op.op_type == OpType.SOURCE

    @property
    def is_sink(self) -> bool:
        return self.last_op.op_type == OpType.SINK

    def chain_refusal(self, op: BasicOperator) -> Optional[str]:
        """Why ``op`` cannot join this stage's thread — None when chaining
        is legal (reference rule: FORWARD input, same parallelism,
        chain-compatible kind, ``wf/multipipe.hpp:537-590``)."""
        if self.is_sink:
            return "tail stage already ends in a sink"
        if op.parallelism != self.parallelism:
            return (f"mixed parallelism ({op.parallelism} vs "
                    f"{self.parallelism}) needs a re-shard between the "
                    "stages")
        if getattr(self.last_op, "is_gpu", False) \
                or getattr(op, "is_gpu", False):
            return "device operators own their stage (fusion not ported)"
        if op.input_routing is not RoutingMode.FORWARD:
            return (f"{op.input_routing.name} input routing needs its own "
                    "shuffle stage")
        if not op.is_chainable:
            return f"{op.name} is not chain-compatible"
        return None

    def describe(self) -> str:
        return "∘".join(o.name for o in self.ops)
