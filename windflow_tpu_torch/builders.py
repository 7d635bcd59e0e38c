"""Fluent builders of the host-plane operators of the ported slice.

Trimmed copy of ``windflow_tpu/builders.py`` (parity: ``wf/builders.hpp``):
``Source_Builder``, ``Columnar_Source_Builder``, ``Map_Builder``,
``Filter_Builder``, ``FlatMap_Builder``, ``Reduce_Builder`` and
``Sink_Builder``. The device operators' builders are in
``gpu.builders_gpu``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .basic import RoutingMode, WindFlowError
from .operators.basic_ops import FlatMap, Filter, Map, Reduce, Sink
from .operators.source import Columnar_Source, Source


class BasicBuilder:
    """withName / withParallelism / withOutputBatchSize /
    withClosingFunction (``wf/builders.hpp:79-124``)."""

    _default_name = "op"

    def __init__(self, func: Callable) -> None:
        self._func = func
        self._name = self._default_name
        self._parallelism = 1
        self._output_batch_size = 0
        self._closing: Optional[Callable] = None
        self._error_policy = None

    def with_name(self, name: str) -> "BasicBuilder":
        self._name = name
        return self

    def with_parallelism(self, parallelism: int) -> "BasicBuilder":
        if parallelism < 1:
            raise WindFlowError("parallelism must be >= 1")
        self._parallelism = parallelism
        return self

    def with_output_batch_size(self, size: int) -> "BasicBuilder":
        if size < 0:
            raise WindFlowError("output batch size must be >= 0")
        self._output_batch_size = size
        return self

    def with_closing_function(self, fn: Callable) -> "BasicBuilder":
        self._closing = fn
        return self

    def with_error_policy(self, policy) -> "BasicBuilder":
        """Per-record failure containment (``supervision/errors.py``):
        ``policy`` is an ``ErrorPolicy``: ``FAIL`` (default: a functor
        exception kills the worker), ``SKIP`` (drop and count),
        ``RETRY(n, backoff_s=...)`` (re-invoke with exponential backoff,
        then the ``on_exhausted`` fallback) or ``DEAD_LETTER``
        (quarantine the record and its exception in the graph's
        dead-letter queue, ``Dlq_*`` stats). On device operators a failing
        batch is bisected until the poison record is alone. A string is
        parsed (``"skip"`` / ``"dead_letter"`` / ``"retry:3"``)."""
        from .supervision.errors import ErrorPolicy
        if isinstance(policy, str):
            policy = ErrorPolicy.parse(policy)
        if not isinstance(policy, ErrorPolicy):
            raise WindFlowError(
                f"with_error_policy: expected an ErrorPolicy (or a spec "
                f"string), got {type(policy).__name__}")
        self._error_policy = policy
        return self

    def _finish(self, op):
        op.closing_func = self._closing
        if self._error_policy is not None:
            op.error_policy = self._error_policy
        return op


class _RoutableBuilder(BasicBuilder):
    """Adds withKeyBy / withRebalancing (``wf/builders.hpp:217-245``)."""

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._routing = RoutingMode.FORWARD
        self._key_extractor: Optional[Callable] = None

    def with_key_by(self, key_extractor: Callable[[Any], Any]
                    ) -> "_RoutableBuilder":
        self._routing = RoutingMode.KEYBY
        self._key_extractor = key_extractor
        return self

    def with_rebalancing(self) -> "_RoutableBuilder":
        if self._routing is RoutingMode.KEYBY:
            raise WindFlowError("withRebalancing is incompatible with "
                                "withKeyBy")
        self._routing = RoutingMode.REBALANCING
        return self

    def with_broadcast(self) -> "_RoutableBuilder":
        if self._routing is RoutingMode.KEYBY:
            raise WindFlowError("withBroadcast is incompatible with "
                                "withKeyBy")
        self._routing = RoutingMode.BROADCAST
        return self


class Source_Builder(BasicBuilder):
    _default_name = "source"

    def build(self) -> Source:
        return self._finish(Source(self._func, self._name, self._parallelism,
                                   self._output_batch_size))


class Columnar_Source_Builder(BasicBuilder):
    """Builder for BLOCK sources: the functor yields ``cols`` /
    ``(cols, ts)`` / ``(cols, ts, wm)`` column blocks (see
    ``Columnar_Source``)."""

    _default_name = "columnar_source"

    def build(self) -> Columnar_Source:
        return self._finish(Columnar_Source(
            self._func, self._name, self._parallelism,
            self._output_batch_size))


class Map_Builder(_RoutableBuilder):
    _default_name = "map"

    def build(self) -> Map:
        return self._finish(Map(self._func, self._name, self._parallelism,
                                self._routing, self._key_extractor,
                                self._output_batch_size))


class Filter_Builder(_RoutableBuilder):
    _default_name = "filter"

    def build(self) -> Filter:
        return self._finish(Filter(self._func, self._name, self._parallelism,
                                   self._routing, self._key_extractor,
                                   self._output_batch_size))


class FlatMap_Builder(_RoutableBuilder):
    _default_name = "flatmap"

    def build(self) -> FlatMap:
        return self._finish(FlatMap(self._func, self._name,
                                    self._parallelism, self._routing,
                                    self._key_extractor,
                                    self._output_batch_size))


class Reduce_Builder(_RoutableBuilder):
    """``withKeyBy`` is mandatory; ``withInitialState`` mirrors
    ``wf/builders.hpp:627``."""

    _default_name = "reduce"

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._initial_state: Any = None

    def with_initial_state(self, state: Any) -> "Reduce_Builder":
        self._initial_state = state
        return self

    def build(self) -> Reduce:
        if self._key_extractor is None:
            raise WindFlowError("Reduce_Builder: withKeyBy(...) is mandatory")
        return self._finish(Reduce(self._func, self._key_extractor,
                                   self._initial_state, self._name,
                                   self._parallelism,
                                   self._output_batch_size))


class Sink_Builder(_RoutableBuilder):
    _default_name = "sink"

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._columns = False

    def with_columns(self) -> "Sink_Builder":
        """Columnar consumer: the functor becomes ``sink(cols, ts)`` with
        host numpy columns; EOS delivers ``sink(None, None)``. Requires a
        device-plane producer."""
        self._columns = True
        return self

    def with_exactly_once(self, staging_dir: Optional[str] = None):
        raise WindFlowError("exactly-once sinks are not yet ported to "
                            "windflow_tpu_torch")

    def build(self) -> Sink:
        return self._finish(Sink(self._func, self._name, self._parallelism,
                                 self._routing, self._key_extractor,
                                 accepts_columns=self._columns))
