"""Kafka connectors of the port over the in-process ``memory://`` broker
(``connectors.py``) and their builders (``builders_kafka.py``)."""

from .builders_kafka import Kafka_Sink_Builder, Kafka_Source_Builder
from .connectors import Kafka_Sink, Kafka_Source, MemoryBroker

__all__ = ["Kafka_Source", "Kafka_Sink", "MemoryBroker",
           "Kafka_Source_Builder", "Kafka_Sink_Builder"]
