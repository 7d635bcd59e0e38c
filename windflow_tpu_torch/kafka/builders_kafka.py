"""Kafka builders (reference ``wf/kafka/builders_kafka.hpp``: withBrokers,
withTopics, withGroupID, withOffsets, withIdleness).

The port's copy of ``windflow_tpu/kafka/builders_kafka.py``, with the
overload knobs (``with_slo``, ``with_priority``) of the source builders.
``with_retries`` on both builders takes the place of the JAX package's
``WF_KAFKA_RETRIES`` / ``WF_KAFKA_RETRY_BASE_MS``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..basic import WindFlowError
from ..builders import BasicBuilder, _SourceOverloadMixin
from .connectors import (DEFAULT_RETRIES, DEFAULT_RETRY_BASE_S, Kafka_Sink,
                         Kafka_Source)


class _RetryMixin:
    """``with_retries``: a real broker's transient client errors are
    retried ``attempts`` times, the k-th retry after ``base_ms * 2**k`` ms
    times a jitter in [0.5, 1.0]; each retry counts one
    ``Kafka_reconnects``, and the error that outlasts them raises."""

    _retry_attempts = DEFAULT_RETRIES
    _retry_base_s = DEFAULT_RETRY_BASE_S

    def with_retries(self, attempts: int = DEFAULT_RETRIES,
                     base_ms: float = DEFAULT_RETRY_BASE_S * 1e3):
        if attempts < 0 or base_ms < 0:
            raise WindFlowError(
                "with_retries: attempts and base_ms must be >= 0")
        self._retry_attempts = int(attempts)
        self._retry_base_s = float(base_ms) / 1e3
        return self

    def _finish_retries(self, op):
        op.retry_attempts = self._retry_attempts
        op.retry_base_s = self._retry_base_s
        return op


class Kafka_Source_Builder(_RetryMixin, _SourceOverloadMixin,
                           BasicBuilder):
    _default_name = "kafka_source"

    def __init__(self, deser_func: Callable) -> None:
        super().__init__(deser_func)
        self._brokers: Optional[str] = None
        self._topics: List[str] = []
        self._group_id = "windflow"
        self._offsets: Dict[Tuple[str, int], int] = {}
        self._idleness_ms = 100
        self._block_size: Optional[int] = None  # with_columnar_blocks

    def with_brokers(self, brokers: str):
        self._brokers = brokers
        return self

    def with_topics(self, *topics: str):
        self._topics = list(topics)
        return self

    def with_group_id(self, group_id: str):
        self._group_id = group_id
        return self

    def with_offsets(self, offsets: Dict[Tuple[str, int], int]):
        """Explicit start offsets per (topic, partition): the replayable
        source positions the checkpoint and resume story builds on."""
        self._offsets = dict(offsets)
        return self

    def with_idleness(self, ms: int):
        self._idleness_ms = ms
        return self

    def with_columnar_blocks(self, block_size: int = 512):
        """Columnar block mode: the deserialization functor gets a
        non-empty LIST of KafkaMessages (one batch poll, up to
        ``block_size``) instead of single messages, decodes it vectorized
        and calls ``shipper.push_columns``. ``None`` (idle timeout) and
        the ``False`` stop flag keep their meaning; offsets and barrier
        placement are unchanged."""
        if block_size <= 0:
            raise WindFlowError(
                "with_columnar_blocks: block_size must be positive")
        self._block_size = block_size
        return self

    def build(self) -> Kafka_Source:
        if not self._brokers:
            raise WindFlowError("Kafka_Source_Builder: withBrokers mandatory")
        if not self._topics:
            raise WindFlowError("Kafka_Source_Builder: withTopics mandatory")
        op = self._finish(Kafka_Source(
            self._func, self._brokers, self._topics, self._group_id,
            self._offsets, self._idleness_ms, self._name, self._parallelism,
            self._output_batch_size))
        if self._block_size is not None:
            op.block_mode = True
            op.block_size = self._block_size
        return self._finish_retries(self._finish_overload(op))


class Kafka_Sink_Builder(_RetryMixin, BasicBuilder):
    _default_name = "kafka_sink"

    def __init__(self, ser_func: Callable) -> None:
        super().__init__(ser_func)
        self._brokers: Optional[str] = None
        self._exactly_once = False
        self._txn_dir: Optional[str] = None

    def with_brokers(self, brokers: str):
        self._brokers = brokers
        return self

    def with_exactly_once(self, staging_dir: Optional[str] = None):
        """Exactly-once through per-epoch broker transactions driven by the
        checkpoint's finalize (a transactional producer with the stable id
        ``wf-txn-<op>-r<idx>``; zombie replicas are fenced). A
        ``memory://`` broker models the whole prepare / commit / abort /
        fence surface and holds the prepared epochs itself. A real broker
        needs confluent_kafka (kafka-python has no transactions: the
        graph's build refuses); its epochs stage in ``staging_dir``
        (default: the graph's ``with_exactly_once`` staging root, else
        ``wf_txn_sinks``)."""
        self._exactly_once = True
        if staging_dir is not None:
            self._txn_dir = staging_dir
        return self

    def build(self) -> Kafka_Sink:
        if not self._brokers:
            raise WindFlowError("Kafka_Sink_Builder: withBrokers mandatory")
        op = self._finish(Kafka_Sink(self._func, self._brokers, self._name,
                                     self._parallelism))
        op.exactly_once = self._exactly_once
        op.txn_dir = self._txn_dir
        return self._finish_retries(op)
