"""Fluent builders of the host-plane operators of the ported slice.

Copy of ``windflow_tpu/builders.py`` (parity: ``wf/builders.hpp``):
``Source_Builder``, ``Columnar_Source_Builder``, ``Map_Builder``,
``Filter_Builder``, ``FlatMap_Builder``, ``Reduce_Builder``,
``Sink_Builder``, the host window builders (``Keyed_Windows_Builder``,
``Parallel_Windows_Builder``, ``Paned_Windows_Builder``,
``MapReduce_Windows_Builder``, ``Ffat_Windows_Builder``) and
``Interval_Join_Builder``, with the JAX package's signatures, refusals and
messages. The device operators' builders are in ``gpu.builders_gpu``, the
Kafka ones in ``kafka.builders_kafka``, the persistent operators' in
``persistent.builders_persistent``. Every builder takes the monitoring
plane's ``with_latency_tracing(rate)`` / ``with_flight_recorder(events)``,
and the source builders the overload plane's ``with_slo(p99_ms)`` /
``with_priority(fn)``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .basic import JoinMode, RoutingMode, WinType, WindFlowError
from .operators.basic_ops import FlatMap, Filter, Map, Reduce, Sink
from .operators.ffat import Ffat_Windows
from .operators.join import Interval_Join
from .operators.source import Columnar_Source, Source
from .operators.windows import (Keyed_Windows, MapReduce_Windows,
                                Paned_Windows, Parallel_Windows)


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
        self._latency_sample: Optional[int] = None
        self._flightrec_events: Optional[int] = None
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

    def with_latency_tracing(self, rate=1) -> "BasicBuilder":
        """This operator's latency-tracing sample rate, over the graph's
        ``latency_sample``: ``1`` samples every tuple, ``"1/64"`` (or
        ``0.015625``) every 64th, ``0`` turns it off. Sources stamp the
        sampled tuples, sinks record end-to-end latency, every replica
        records sampled service and dispatch latencies into its
        histograms (``monitoring/tracing.py``)."""
        from .monitoring.tracing import parse_sample_rate
        self._latency_sample = parse_sample_rate(rate)
        return self

    def with_flight_recorder(self, events: int = 0) -> "BasicBuilder":
        """A flight-recorder ring of ``events`` span events for this
        operator's workers (0: the 4096 default). A chained stage takes
        the largest override among its operators; see
        ``PipeGraph.with_flight_recorder`` for the graph-wide switch and
        ``PipeGraph.dump_trace`` / ``GET /trace`` for the exports."""
        from .monitoring.flightrec import DEFAULT_EVENTS
        if events < 0:
            raise WindFlowError("with_flight_recorder: events must be >= 0")
        self._flightrec_events = int(events) if events > 0 \
            else DEFAULT_EVENTS
        return self

    def _finish(self, op):
        op.closing_func = self._closing
        if self._latency_sample is not None:
            op.latency_sample = self._latency_sample
        if self._flightrec_events is not None:
            op.flightrec_events = self._flightrec_events
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


class _SourceOverloadMixin:
    """``with_slo`` / ``with_priority`` of the source builders, the
    overload plane's surface (``overload/``); shared with the Kafka source
    builder."""

    _slo_p99_ms: Optional[float] = None
    _priority_fn: Optional[Callable] = None

    def with_slo(self, p99_ms: float):
        """This source's end-to-end p99 latency budget (milliseconds): the
        graph attaches the overload governor at ``start()``; of several
        declared budgets (the graph's ``with_slo`` and other sources') the
        TIGHTEST governs."""
        if p99_ms <= 0:
            raise WindFlowError("with_slo: p99_ms must be > 0")
        self._slo_p99_ms = float(p99_ms)
        return self

    def with_priority(self, fn: Callable[[Any], Any]):
        """Record priority (higher = more important) for the
        ``key_priority`` shed policy: when the admission gate must evict,
        the LOWEST-priority buffered record sheds. The other shed policies
        ignore it."""
        if not callable(fn):
            raise WindFlowError("with_priority: fn must be callable")
        self._priority_fn = fn
        return self

    def _finish_overload(self, op):
        op.slo_p99_ms = self._slo_p99_ms
        op.priority_fn = self._priority_fn
        return op


class Source_Builder(_SourceOverloadMixin, BasicBuilder):
    _default_name = "source"

    def build(self) -> Source:
        return self._finish_overload(self._finish(
            Source(self._func, self._name, self._parallelism,
                   self._output_batch_size)))


class Columnar_Source_Builder(_SourceOverloadMixin, BasicBuilder):
    """Builder for BLOCK sources: the functor yields ``cols`` /
    ``(cols, ts)`` / ``(cols, ts, wm)`` column blocks (see
    ``Columnar_Source``). ``with_block_size`` re-chunks oversized yields;
    ``with_schema`` declares column dtypes cast at the edge."""

    _default_name = "columnar_source"

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._block_size = 0
        self._block_schema: Optional[dict] = None

    def with_block_size(self, n: int) -> "Columnar_Source_Builder":
        if n <= 0:
            raise WindFlowError("with_block_size: block size must be >= 1")
        self._block_size = int(n)
        return self

    def with_schema(self, schema: dict) -> "Columnar_Source_Builder":
        if not isinstance(schema, dict) or not schema:
            raise WindFlowError(
                "with_schema: expected a non-empty {field: dtype} dict")
        self._block_schema = dict(schema)
        return self

    def build(self) -> Columnar_Source:
        return self._finish_overload(self._finish(Columnar_Source(
            self._func, self._name, self._parallelism,
            self._output_batch_size, self._block_size, self._block_schema)))


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
        self._exactly_once = False
        self._txn_dir: Optional[str] = None

    def with_columns(self) -> "Sink_Builder":
        """Columnar consumer: the functor becomes ``sink(cols, ts)`` with
        host numpy columns; EOS delivers ``sink(None, None)``. Requires a
        device-plane producer."""
        self._columns = True
        return self

    def with_exactly_once(self, staging_dir: Optional[str] = None
                          ) -> "Sink_Builder":
        """Exactly-once delivery (``sinks/transactional.py``): the output
        buffers per checkpoint epoch, pre-commits at the aligned barrier as
        a staged segment file under ``staging_dir`` (default the graph's,
        else ``wf_txn_sinks``) and becomes visible (one atomic rename, then
        the functor call) only when the coordinator finalizes the epoch.
        Requires ``PipeGraph.with_checkpointing``; the graph refuses
        otherwise."""
        self._exactly_once = True
        if staging_dir is not None:
            self._txn_dir = staging_dir
        return self

    def build(self) -> Sink:
        op = self._finish(Sink(self._func, self._name, self._parallelism,
                               self._routing, self._key_extractor,
                               accepts_columns=self._columns))
        op.exactly_once = self._exactly_once
        op.txn_dir = self._txn_dir
        return op


# ---------------------------------------------------------------------------
# Window builders (reference wf/builders.hpp:743-782 add withCBWindows /
# withTBWindows / withLateness on top of the basic surface)
# ---------------------------------------------------------------------------


class _WindowedBuilder(BasicBuilder):
    def __init__(self, func):
        super().__init__(func)
        self._key_extractor = None
        self._win_len = 0
        self._slide_len = 0
        self._win_type = None
        self._lateness = 0
        self._incremental = False
        self._initial = None
        self._tb_origin = None

    def with_key_by(self, key_extractor):
        self._key_extractor = key_extractor
        return self

    def with_cb_windows(self, win_len: int, slide_len: int):
        self._win_type = WinType.CB
        self._win_len, self._slide_len = win_len, slide_len
        return self

    def with_tb_windows(self, win_usec: int, slide_usec: int):
        self._win_type = WinType.TB
        self._win_len, self._slide_len = win_usec, slide_usec
        return self

    def with_lateness(self, lateness_usec: int):
        self._lateness = lateness_usec
        return self

    def with_tb_origin(self, origin_usec: int = 0):
        """Reference-compat TB window numbering
        (``wf/window_replica.hpp:253-283``): anchor every key's windows at
        this time origin and fire identity-valued EMPTY windows between
        the origin and the key's first tuple as the watermark passes them.
        Default (not called): a key's first window aligns to its first
        tuple (PARITY.md §2.3) — epoch-scale timestamps would otherwise
        create ~ts/slide empty windows, which this origin bounds."""
        self._tb_origin = origin_usec
        return self

    def incremental(self, initial_value=None):
        """Switch the window function to incremental form
        ``func(tuple, acc) -> acc``; ``initial_value`` may be a value
        (deep-copied per window) or a factory ``(key, gwid) -> acc``."""
        self._incremental = True
        self._initial = initial_value
        return self

    def _check_windows(self, what: str) -> None:
        if self._win_type is None:
            raise WindFlowError(f"{what}: call with_cb_windows() or "
                                "with_tb_windows() first")
        if self._tb_origin is not None and self._win_type is not WinType.TB:
            raise WindFlowError(f"{what}: with_tb_origin applies to "
                                "time-based windows only (the origin is a "
                                "timestamp; CB windows count arrivals)")


class Keyed_Windows_Builder(_WindowedBuilder):
    _default_name = "keyed_windows"

    def build(self) -> Keyed_Windows:
        self._check_windows("Keyed_Windows_Builder")
        if self._key_extractor is None:
            raise WindFlowError("Keyed_Windows_Builder: withKeyBy mandatory")
        return self._finish(Keyed_Windows(
            self._func, self._key_extractor, self._win_len, self._slide_len,
            self._win_type, self._lateness, self._incremental, self._initial,
            self._name, self._parallelism, self._output_batch_size,
            tb_origin=self._tb_origin))


class Parallel_Windows_Builder(_WindowedBuilder):
    _default_name = "parallel_windows"

    def build(self) -> Parallel_Windows:
        self._check_windows("Parallel_Windows_Builder")
        if self._key_extractor is None:
            raise WindFlowError("Parallel_Windows_Builder: withKeyBy mandatory")
        return self._finish(Parallel_Windows(
            self._func, self._key_extractor, self._win_len, self._slide_len,
            self._win_type, self._lateness, self._incremental, self._initial,
            self._name, self._parallelism, self._output_batch_size,
            tb_origin=self._tb_origin))


class _TwoStageWindowedBuilder(_WindowedBuilder):
    def __init__(self, func1, func2):
        super().__init__(func1)
        self._func2 = func2
        self._incremental2 = False
        self._initial2 = None
        self._parallelism2 = 1

    def incremental_stage2(self, initial_value=None):
        self._incremental2 = True
        self._initial2 = initial_value
        return self

    def with_parallelism(self, p1: int, p2: int = None):  # type: ignore[override]
        super().with_parallelism(p1)
        self._parallelism2 = p2 if p2 is not None else p1
        return self


class Paned_Windows_Builder(_TwoStageWindowedBuilder):
    _default_name = "paned_windows"

    def build(self) -> Paned_Windows:
        self._check_windows("Paned_Windows_Builder")
        if self._key_extractor is None:
            raise WindFlowError("Paned_Windows_Builder: withKeyBy mandatory")
        return self._finish(Paned_Windows(
            self._func, self._func2, self._key_extractor, self._win_len,
            self._slide_len, self._win_type, self._lateness,
            self._incremental, self._initial, self._incremental2,
            self._initial2, self._name, self._parallelism,
            self._parallelism2, self._output_batch_size,
            tb_origin=self._tb_origin))


class MapReduce_Windows_Builder(_TwoStageWindowedBuilder):
    _default_name = "mapreduce_windows"

    def build(self) -> MapReduce_Windows:
        self._check_windows("MapReduce_Windows_Builder")
        if self._key_extractor is None:
            raise WindFlowError("MapReduce_Windows_Builder: withKeyBy mandatory")
        return self._finish(MapReduce_Windows(
            self._func, self._func2, self._key_extractor, self._win_len,
            self._slide_len, self._win_type, self._lateness,
            self._incremental, self._initial, self._incremental2,
            self._initial2, self._name, self._parallelism,
            self._parallelism2, self._output_batch_size,
            tb_origin=self._tb_origin))


class Ffat_Windows_Builder(_WindowedBuilder):
    """lift+combine FlatFAT aggregator (``wf/builders.hpp`` FFAT_Builder)."""

    _default_name = "ffat_windows"

    def __init__(self, lift_func, combine_func):
        super().__init__(lift_func)
        self._combine = combine_func

    def incremental(self, initial_value=None):
        raise WindFlowError(
            "Ffat_Windows is inherently incremental via lift+combine; "
            "incremental() does not apply (use Keyed_Windows_Builder for "
            "seeded accumulators)")

    def build(self) -> Ffat_Windows:
        self._check_windows("Ffat_Windows_Builder")
        if self._key_extractor is None:
            raise WindFlowError("Ffat_Windows_Builder: withKeyBy mandatory")
        if self._tb_origin is not None:
            raise WindFlowError(
                "Ffat_Windows_Builder: with_tb_origin applies to the "
                "window-engine operators (Keyed/Parallel/Paned/MapReduce "
                "windows); the FFAT planes keep first-tuple anchoring")
        return self._finish(Ffat_Windows(
            self._func, self._combine, self._key_extractor, self._win_len,
            self._slide_len, self._win_type, self._lateness, self._name,
            self._parallelism, self._output_batch_size))


# ---------------------------------------------------------------------------
# Interval_Join builder (wf/builders.hpp:1480-1538: withBoundaries,
# withKPMode, withDPMode)
# ---------------------------------------------------------------------------


class Interval_Join_Builder(BasicBuilder):
    _default_name = "interval_join"

    def __init__(self, join_func):
        super().__init__(join_func)
        self._key_extractor = None
        self._lower = None
        self._upper = None
        self._mode = JoinMode.KP

    def with_key_by(self, key_extractor):
        self._key_extractor = key_extractor
        return self

    def with_boundaries(self, lower_usec: int, upper_usec: int):
        self._lower, self._upper = lower_usec, upper_usec
        return self

    def with_kp_mode(self):
        self._mode = JoinMode.KP
        return self

    def with_dp_mode(self):
        self._mode = JoinMode.DP
        return self

    def build(self) -> Interval_Join:
        if self._key_extractor is None:
            raise WindFlowError("Interval_Join_Builder: withKeyBy mandatory")
        if self._lower is None:
            raise WindFlowError("Interval_Join_Builder: withBoundaries "
                                "mandatory")
        return self._finish(Interval_Join(
            self._func, self._key_extractor, self._lower, self._upper,
            self._mode, self._name, self._parallelism,
            self._output_batch_size))
