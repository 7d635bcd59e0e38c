"""MultiPipe: the pipeline builder, with splits and merges.

Trimmed copy of ``windflow_tpu/topology/multipipe.py`` (no join, no
composite operators). Parity with ``wf/multipipe.hpp``:

- ``add`` / ``chain`` / ``add_sink`` / ``chain_sink`` (L952/1050);
- ``split(logic, n)`` + ``select(i)`` (L1178-1256);
- ``merge(*pipes)`` (via ``PipeGraph``, ``wf/pipegraph.hpp:265-460``).

A MultiPipe is a cursor over the PipeGraph's stage DAG: it tracks the open
tail stages that the next operator will consume from — one stage, or
several right after a merge.
"""

from __future__ import annotations

from typing import List, Optional

from ..basic import OpType, WindFlowError
from ..operators.base import BasicOperator
from .stage import Stage, UpstreamEdge


class MultiPipe:
    def __init__(self, graph: "PipeGraph") -> None:  # noqa: F821
        self.graph = graph
        # open tails, in merge order; one stage except right after a merge
        self.tail_groups: List[List[Stage]] = []
        self.has_sink = False
        self.was_split = False
        self.was_merged = False
        self._split_children: List["MultiPipe"] = []
        self._parent_split: Optional[tuple] = None  # (stage, branch idx)

    @property
    def _tails(self) -> List[Stage]:
        return [s for g in self.tail_groups for s in g]

    def _check_open(self, what: str) -> None:
        if self.has_sink:
            raise WindFlowError(f"cannot {what}: MultiPipe already has a sink")
        if self.was_split:
            raise WindFlowError(
                f"cannot {what}: MultiPipe was split; use select()")
        if not self.tail_groups and self._parent_split is None:
            raise WindFlowError(f"cannot {what}: empty MultiPipe")

    def _claim(self, op: BasicOperator) -> None:
        if op._used:
            raise WindFlowError(
                f"operator {op.name!r} was already added to a MultiPipe")
        op._used = True
        self.graph._register_op(op)

    def add(self, op: BasicOperator) -> "MultiPipe":
        """New stage connected from every open tail (one-to-one or a
        shuffle, chosen at wiring time: the reference's Case 2 / Case 3),
        or, as the first operator of a split branch, from the split
        stage."""
        self._check_open("add")
        self._claim(op)
        stage = Stage(op)
        if self._parent_split is not None and not self.tail_groups:
            ptail, branch = self._parent_split
            if ptail.split_branches[branch] is not None:
                raise WindFlowError("split branch already connected")
            ptail.split_branches[branch] = stage
            stage.upstreams.append(UpstreamEdge(ptail, branch))
        else:
            for t in self._tails:
                if t.downstream is not None or t.is_split:
                    raise WindFlowError("tail stage already connected")
                t.downstream = stage
                stage.upstreams.append(UpstreamEdge(t))
        self.graph._stages.append(stage)
        self.tail_groups = [[stage]]
        self.was_merged = False
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
        tails = self._tails
        if len(tails) == 1 and not self.was_merged:
            reason = tails[0].chain_refusal(op, self.graph.fusion)
            if reason is None:
                self._claim(op)
                tails[0].ops.append(op)
                if op.op_type == OpType.SINK:
                    self.has_sink = True
                return self
        elif self.was_merged:
            reason = "chain after a merge needs a shuffle stage"
        elif not tails:
            reason = "first operator of a split branch starts its own stage"
        else:
            reason = "multiple open tails need a merging stage"
        self.add(op)
        for stage in self._tails:
            stage.chain_refused = reason
        return self

    def add_sink(self, op: BasicOperator) -> "MultiPipe":
        if op.op_type != OpType.SINK:
            raise WindFlowError("add_sink requires a Sink operator")
        return self.add(op)

    def chain_sink(self, op: BasicOperator) -> "MultiPipe":
        if op.op_type != OpType.SINK:
            raise WindFlowError("chain_sink requires a Sink operator")
        return self.chain(op)

    # ------------------------------------------------------------------
    def split(self, splitting_logic, n_branches: int) -> "MultiPipe":
        """Split the pipe into ``n_branches`` children; ``splitting_logic``
        maps a tuple to a branch index (or an iterable of indices, or None
        to drop it), ``wf/multipipe.hpp:1178-1256``. A string names a tuple
        field holding the branch index — after a device operator that
        routes from one column read back, with no per-tuple Python
        (``wf/multipipe.hpp:698-708``)."""
        self._check_open("split")
        if n_branches < 2:
            raise WindFlowError("split requires at least 2 branches")
        tails = self._tails
        if len(tails) != 1:
            raise WindFlowError("split right after a merge is not supported; "
                                "add an operator first")
        tail = tails[0]
        if tail.downstream is not None or tail.is_split:
            raise WindFlowError("tail stage already connected")
        tail.split_logic = splitting_logic
        tail.split_branches = [None] * n_branches
        self.was_split = True
        self._split_children = []
        for b in range(n_branches):
            child = MultiPipe(self.graph)
            child._parent_split = (tail, b)
            self._split_children.append(child)
        return self

    def select(self, branch: int) -> "MultiPipe":
        """The MultiPipe of one split branch (``wf/multipipe.hpp``
        select)."""
        if not self.was_split:
            raise WindFlowError("select() requires a previous split()")
        if not (0 <= branch < len(self._split_children)):
            raise WindFlowError("select(): branch out of range")
        return self._split_children[branch]

    def get_split_branches(self) -> List["MultiPipe"]:
        if not self.was_split:
            raise WindFlowError("MultiPipe was not split")
        return list(self._split_children)

    # ------------------------------------------------------------------
    def merge(self, *others: "MultiPipe") -> "MultiPipe":
        """Merge this pipe with others into a new MultiPipe whose next
        operator consumes the union of the tails
        (``wf/pipegraph.hpp:265-460``)."""
        if not others:
            raise WindFlowError("merge requires at least one other MultiPipe")
        pipes = [self, *others]
        for p in pipes:
            p._check_open("merge")
            if p.graph is not self.graph:
                raise WindFlowError("cannot merge MultiPipes of different "
                                    "PipeGraphs")
        merged = MultiPipe(self.graph)
        merged.tail_groups = [list(p._tails) for p in pipes]
        merged.was_merged = True
        for p in pipes:
            p.tail_groups = []  # consumed
        return merged
