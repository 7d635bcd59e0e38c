"""Internal graph IR: Stage = one (possibly chained) operator group.

Trimmed copy of ``windflow_tpu/topology/stage.py``. The topology is a plain
DAG of stages with the reference's semantics: same-parallelism FORWARD
edges are one-to-one (``wf/multipipe.hpp:481-496``), other edges connect
every producer replica to every consumer replica with the emitter chosen
by the consumer's routing; host operators with FORWARD input may chain
into their predecessor's thread (``wf/multipipe.hpp:537-590``). Device
operators chain by FUSION: a chained device stage runs as one fused
replica per slot (``gpu/fused_ops.py``), under the legality rules of
``_gpu_fusion_refusal``. Device and host operators never share a stage.
A stage may end in a split (``split_logic`` and one consumer stage per
branch, in place of ``downstream``); an edge into a split branch records
its branch index on the consumer's ``UpstreamEdge``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

from ..basic import OpType, RoutingMode
from ..operators.base import BasicOperator


def _keys_compatible(a: BasicOperator, b: BasicOperator) -> bool:
    """Two keyed device ops partition identically: same key field(s), or
    the very same extractor callable. Under equal parallelism the KEYBY
    re-shard between them is then the identity, so fusing drops the
    shuffle without changing which replica owns a key. Names only: a
    fused prefix must not rewrite the key field."""
    if a.key_field is not None or b.key_field is not None:
        return a.key_field == b.key_field
    if a.key_fields or b.key_fields:
        return a.key_fields == b.key_fields
    return a.key_extractor is b.key_extractor


class UpstreamEdge:
    """Producer side of an edge into a stage."""

    __slots__ = ("stage", "branch")

    def __init__(self, stage: "Stage", branch: Optional[int] = None) -> None:
        self.stage = stage  # producer stage
        self.branch = branch  # split branch index on the producer, or None


class Stage:
    _next_id = 0

    def __init__(self, op: BasicOperator) -> None:
        self.id = Stage._next_id
        Stage._next_id += 1
        self.ops: List[BasicOperator] = [op]  # chained operators, in order
        self.upstreams: List[UpstreamEdge] = []
        self.downstream: Optional["Stage"] = None  # exclusive with split
        # MultiPipe.split: a callable payload -> branch index(es) or a
        # field name, and the first stage of each branch
        self.split_logic: Optional[Union[Callable, str]] = None
        self.split_branches: List[Optional["Stage"]] = []
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

    @property
    def is_split(self) -> bool:
        return self.split_logic is not None

    @property
    def split_gpu(self) -> bool:
        """A split after a device operator: the device splitting emitter
        routes whole device batches (``gpu/emitters_gpu.py``)."""
        return self.is_split and getattr(self.last_op, "is_gpu", False)

    @property
    def is_fused_gpu(self) -> bool:
        """A chained stage of device ops runs as ONE fused replica per
        slot (``gpu/fused_ops.py``), not as a thread chain."""
        return len(self.ops) > 1 and all(
            getattr(o, "is_gpu", False) for o in self.ops)

    def chain_refusal(self, op: BasicOperator,
                      fusion: bool) -> Optional[str]:
        """Why ``op`` cannot join this stage — None when chaining is
        legal. Host chaining follows the reference rule (FORWARD input,
        same parallelism, chain-compatible kind); device chaining follows
        the fusion rules (``_gpu_fusion_refusal``; ``fusion`` is the
        graph's ``PipeGraph(fusion=...)``)."""
        if self.is_split:
            return "tail stage was split"
        if self.is_sink:
            return "tail stage already ends in a sink"
        if op.parallelism != self.parallelism:
            return (f"mixed parallelism ({op.parallelism} vs "
                    f"{self.parallelism}) needs a re-shard between the "
                    "stages")
        tail_gpu = getattr(self.last_op, "is_gpu", False)
        cand_gpu = getattr(op, "is_gpu", False)
        if tail_gpu or cand_gpu:
            if not (tail_gpu and cand_gpu):
                return "device and host operators never share a stage"
            return self._gpu_fusion_refusal(op, fusion)
        if op.input_routing is not RoutingMode.FORWARD:
            return (f"{op.input_routing.name} input routing needs its own "
                    "shuffle stage")
        if not op.is_chainable:
            return f"{op.name} is not chain-compatible"
        return None

    def _gpu_fusion_refusal(self, op: BasicOperator,
                            fusion: bool) -> Optional[str]:
        """Device-chain fusion legality: consecutive FORWARD (or
        key-compatible KEYBY) same-parallelism device transforms fuse into
        one replica; a terminator (global or keyed Reduce_GPU, the FFAT
        window) may END the chain. The keyed and window terminators also
        need their KEYBY shuffle to be the identity (one replica, or a
        key-compatible keyed entry), and the window terminator a
        STATELESS prefix. The JAX package also refuses sub-ops with an
        error policy; the port has no error policies yet."""
        if not fusion:
            return "device-chain fusion disabled (PipeGraph(fusion=False))"
        last_role = getattr(self.last_op, "fusion_role", None)
        if last_role == "terminator":
            return (f"{self.last_op.name} (global Reduce_GPU) already "
                    "terminates the fused chain")
        if last_role == "keyed_terminator":
            return (f"{self.last_op.name} (keyed Reduce_GPU) already "
                    "terminates the fused chain")
        if last_role == "window_terminator":
            return (f"{self.last_op.name} is a window non-terminal "
                    "position — the window step already terminates the "
                    "fused chain (it changes the row domain: tuples -> "
                    "fired windows)")
        if any(getattr(o, "fusion_role", None) is None for o in self.ops):
            return (f"{self.first_op.name} has no composable device "
                    "kernel")
        role = getattr(op, "fusion_role", None)
        if role is None:
            return f"{op.name} has no composable device kernel"
        if role == "window_terminator":
            for o in self.ops:
                if getattr(o, "state_init", None) is not None:
                    # the prefix runs twice per batch (prep-time mask and
                    # in-step compose): a stateful one would advance twice
                    return (f"{op.name} (window terminator) needs a "
                            f"stateless map/filter prefix — {o.name} "
                            "carries per-key device state")
        routing = op.input_routing
        if routing is RoutingMode.KEYBY:
            if self.first_op.input_routing is RoutingMode.KEYBY:
                if not _keys_compatible(self.first_op, op):
                    return (f"{op.name} keys differ from the chain "
                            "entry's — fusing would skip a real re-shard")
            elif role in ("keyed_terminator", "window_terminator"):
                # one replica: the KEYBY shuffle sends every key to the
                # same place, so it reduces to the terminator's own sort
                if self.parallelism != 1:
                    return (f"{op.name} needs a cross-device KEYBY "
                            f"shuffle (parallelism {self.parallelism}) — "
                            "the re-shard owns its own stage boundary")
            else:
                return (f"{op.name} is keyed but the chain entry "
                        f"({self.first_op.name}) is not — the KEYBY "
                        "shuffle needs its own stage boundary")
        elif routing is not RoutingMode.FORWARD:
            return (f"{routing.name} input routing needs its own shuffle "
                    "stage")
        return None

    def describe(self, diagnostics: bool = False) -> str:
        label = "∘".join(o.name for o in self.ops)
        if diagnostics and self.chain_refused:
            label += f" [unchained: {self.chain_refused}]"
        return label
