"""Kafka builders (reference ``wf/kafka/builders_kafka.hpp``: withBrokers,
withTopics, withGroupID, withOffsets, withIdleness).

The port's copy of ``windflow_tpu/kafka/builders_kafka.py``, with the
overload knobs (``with_slo``, ``with_priority``) of the source builders.
``Kafka_Sink_Builder.with_exactly_once`` runs per-epoch
transactions on a ``memory://`` broker.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..basic import WindFlowError
from ..builders import BasicBuilder, _SourceOverloadMixin
from .connectors import Kafka_Sink, Kafka_Source


class Kafka_Source_Builder(_SourceOverloadMixin, BasicBuilder):
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
        return self._finish_overload(op)


class Kafka_Sink_Builder(BasicBuilder):
    _default_name = "kafka_sink"

    def __init__(self, ser_func: Callable) -> None:
        super().__init__(ser_func)
        self._brokers: Optional[str] = None
        self._exactly_once = False

    def with_brokers(self, brokers: str):
        self._brokers = brokers
        return self

    def with_exactly_once(self, staging_dir: Optional[str] = None):
        """Exactly-once through per-epoch broker transactions driven by the
        checkpoint's finalize (a transactional producer with the stable id
        ``wf-txn-<op>-r<idx>``; zombie replicas are fenced). A
        ``memory://`` broker models the whole prepare / commit / abort /
        fence surface and stages the epochs itself. ``staging_dir`` (the
        JAX package's local staging root of a real broker's epochs) is
        accepted for the JAX signature and unused: real brokers are not
        ported."""
        self._exactly_once = True
        return self

    def build(self) -> Kafka_Sink:
        if not self._brokers:
            raise WindFlowError("Kafka_Sink_Builder: withBrokers mandatory")
        op = self._finish(Kafka_Sink(self._func, self._brokers, self._name,
                                     self._parallelism))
        op.exactly_once = self._exactly_once
        return op
