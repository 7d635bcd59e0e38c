"""Kafka connectors: external ingestion and egress with replayable offsets.

The port's copy of ``windflow_tpu/kafka/connectors.py``. Parity:
``wf/kafka/kafka_source.hpp:127-519`` (consumer-group replicas, a poll
loop with an idle timeout, a user deserialization functor returning a
continue flag, explicit start offsets) and
``wf/kafka/kafka_sink.hpp:71-379`` (a user serializer returning
``(topic, partition, payload)``).

The transport sits behind one small interface (subscribe / consume /
consume_batch / produce / flush / close, and the offset cursors). A broker
string ``"memory://<name>"`` uses the in-process ``MemoryBroker``
(partitioned topics, offsets, consumer groups, committed group offsets).
Any other broker string names a real Kafka cluster, reached through
``ConfluentTransport`` (confluent_kafka, librdkafka; preferred) or
``KafkaPythonTransport`` (kafka-python). A client library is imported only
when such a broker is used; with neither installed, the operators'
constructors raise ``WindFlowError`` naming the client. A transient client
error is retried with a jittered exponential backoff whose attempts and
base delay are the builders' ``with_retries`` (the port reads no
``WF_KAFKA_RETRIES`` / ``WF_KAFKA_RETRY_BASE_MS``).

Exactly-once (``Kafka_Sink_Builder.with_exactly_once``): on ``memory://``
the broker's transaction half (``txn_init`` / ``txn_prepare`` /
``txn_commit`` / ``txn_abort`` with a fence generation per transactional
id) under ``_MemoryTxnBackend``; on a real broker ``_StagedKafkaBackend``:
each epoch staged in a local segment store, produced in one Kafka
transaction when the checkpoint finalizes it (confluent_kafka only:
kafka-python has no transactional producer, and refuses).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..basic import OpType, RoutingMode, WindFlowError, current_time_usecs
from ..operators.base import BasicOperator, BasicReplica, arity
from ..operators.source import SourceShipper
from ..sinks.transactional import FencedWriteError

# the JAX package's WF_KAFKA_RETRIES / WF_KAFKA_RETRY_BASE_MS defaults
DEFAULT_RETRIES = 5
DEFAULT_RETRY_BASE_S = 0.1


# ---------------------------------------------------------------------------
# transient-error retry (jittered exponential backoff): a broker hiccup
# must not surface as a worker crash; bounded attempts with backoff, one
# Kafka_reconnects per retry, THEN the error propagates like any failure
# ---------------------------------------------------------------------------
def _retrying(transport, fn: Callable, what: str,
              attempts: int = DEFAULT_RETRIES,
              base_s: float = DEFAULT_RETRY_BASE_S):
    """Run ``fn`` with bounded retry on the transport's transient error
    classes: the k-th retry sleeps ``base_s * 2**k`` seconds times a
    uniform jitter in [0.5, 1.0] (a replica fleet must not retry a
    flapping broker in lockstep). Every retry calls
    ``transport.on_retry``; exhausted attempts raise ``WindFlowError``."""
    transients = transport._transient_excs()
    if not transients:
        return fn()
    attempts = max(0, int(attempts))
    base_s = max(0.0, float(base_s))
    for attempt in range(attempts + 1):
        try:
            return fn()
        except transients as e:
            # a client error carrying .fatal() (authentication, config)
            # never heals by retry
            inner = e.args[0] if getattr(e, "args", None) else None
            fatal = getattr(inner, "fatal", None)
            if callable(fatal) and fatal():
                raise
            if attempt >= attempts:
                raise WindFlowError(
                    f"Kafka {what}: still failing after {attempts} "
                    f"retr{'y' if attempts == 1 else 'ies'}: "
                    f"{type(e).__name__}: {e}") from e
            cb = getattr(transport, "on_retry", None)
            if cb is not None:
                cb()
            delay = base_s * (2 ** attempt)
            time.sleep(delay * (0.5 + 0.5 * random.random()))


class KafkaMessage:
    __slots__ = ("topic", "partition", "offset", "payload", "timestamp")

    def __init__(self, topic, partition, offset, payload, timestamp) -> None:
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.payload = payload
        self.timestamp = timestamp


# ---------------------------------------------------------------------------
# In-process broker
# ---------------------------------------------------------------------------
class MemoryBroker:
    """Partitioned topics in process memory, found by name in a
    process-wide registry (``get``; ``reset`` empties it)."""

    _registry: Dict[str, "MemoryBroker"] = {}
    _reg_lock = threading.Lock()

    def __init__(self, name: str, n_partitions: int = 4) -> None:
        self.name = name
        self.n_partitions = n_partitions
        self._topics: Dict[str, List[List[KafkaMessage]]] = {}
        self._lock = threading.Lock()
        # consumer-group committed offsets ((group, topic, partition) ->
        # next offset), written by MemoryTransport.commit_offsets when a
        # checkpoint finalizes, as a real broker's offset store
        self.committed: Dict[Tuple[str, str, int], int] = {}
        # transactional producers (exactly-once sinks): per transactional
        # id a fence generation (zombie producers are refused, Kafka's
        # producer-epoch fencing), the prepared epochs' records (they
        # outlive the producer, as the broker's transaction log) and the
        # committed epochs (an epoch replayed after a restore is discarded)
        self.txn_fences: Dict[str, int] = {}
        self.txn_prepared: Dict[str, Dict[int, List[Tuple]]] = {}
        self.txn_committed: Dict[str, set] = {}
        self.fenced_attempts = 0

    @classmethod
    def get(cls, name: str, n_partitions: int = 4) -> "MemoryBroker":
        with cls._reg_lock:
            b = cls._registry.get(name)
            if b is None:
                b = cls._registry[name] = MemoryBroker(name, n_partitions)
            return b

    @classmethod
    def reset(cls) -> None:
        with cls._reg_lock:
            cls._registry.clear()

    def _topic(self, topic: str) -> List[List[KafkaMessage]]:
        with self._lock:
            t = self._topics.get(topic)
            if t is None:
                t = self._topics[topic] = [[] for _ in
                                           range(self.n_partitions)]
            return t

    def produce(self, topic: str, payload: Any,
                partition: Optional[int] = None, key: Any = None) -> None:
        t = self._topic(topic)
        with self._lock:
            if partition is None:
                partition = (hash(key) % self.n_partitions if key is not None
                             else sum(len(p) for p in t) % self.n_partitions)
            part = t[partition % self.n_partitions]
            part.append(KafkaMessage(topic, partition % self.n_partitions,
                                     len(part), payload,
                                     current_time_usecs()))

    def assign_partitions(self, topic: str, group: str, member: int,
                          n_members: int) -> List[int]:
        """Cooperative assignment: partition p -> member p % n_members
        (the reference relies on Kafka's group rebalance,
        ``kafka_source.hpp:77-115``)."""
        return [p for p in range(self.n_partitions) if p % n_members == member]

    def poll(self, topic: str, partition: int, offset: int
             ) -> Optional[KafkaMessage]:
        t = self._topic(topic)
        with self._lock:
            part = t[partition]
            if offset < len(part):
                return part[offset]
        return None

    def poll_run(self, topic: str, partition: int, offset: int,
                 max_n: int) -> List[KafkaMessage]:
        """A contiguous run of one partition: the batch poll of the
        columnar block mode (one lock round per partition)."""
        t = self._topic(topic)
        with self._lock:
            return t[partition][offset:offset + max_n]

    def end_offset(self, topic: str, partition: int) -> int:
        t = self._topic(topic)
        with self._lock:
            return len(t[partition])

    # -- transactions (exactly-once sinks) ---------------------------------
    def txn_init(self, txn_id: str) -> int:
        """(Re)initialize a transactional producer: bump the fence
        generation, so every older producer of the id is a zombie whose
        writes are refused (Kafka's ``initTransactions`` epoch bump)."""
        with self._lock:
            gen = self.txn_fences.get(txn_id, 0) + 1
            self.txn_fences[txn_id] = gen
            self.txn_prepared.setdefault(txn_id, {})
            self.txn_committed.setdefault(txn_id, set())
            return gen

    def _txn_check(self, txn_id: str, gen: int) -> None:
        if self.txn_fences.get(txn_id) != gen:
            self.fenced_attempts += 1
            raise FencedWriteError(
                f"Kafka transactional producer {txn_id!r} generation "
                f"{gen} is fenced (current generation "
                f"{self.txn_fences.get(txn_id)}): a newer replica owns "
                "this transaction log")

    def txn_check(self, txn_id: str, gen: int) -> None:
        with self._lock:
            self._txn_check(txn_id, gen)

    def txn_prepare(self, txn_id: str, gen: int, epoch: int,
                    records: List[Tuple]) -> None:
        """Phase 1: the epoch's records become durable in the broker's
        transaction log, invisible to consumers until the commit."""
        with self._lock:
            self._txn_check(txn_id, gen)
            self.txn_prepared[txn_id][epoch] = list(records)

    def txn_is_committed(self, txn_id: str, epoch: int) -> bool:
        with self._lock:
            return epoch in self.txn_committed.get(txn_id, ())

    def txn_commit(self, txn_id: str, gen: int, epoch: int) -> bool:
        """Phase 2: append the prepared records to their topics. False
        when the epoch was already committed (the replayed duplicate is
        discarded)."""
        with self._lock:
            self._txn_check(txn_id, gen)
            if epoch in self.txn_committed[txn_id]:
                self.txn_prepared[txn_id].pop(epoch, None)
                return False
            records = self.txn_prepared[txn_id].pop(epoch, [])
            self.txn_committed[txn_id].add(epoch)
        for topic, partition, key, payload in records:
            self.produce(topic, payload, partition, key)
        return True

    def txn_abort(self, txn_id: str, gen: int, epoch: int) -> bool:
        with self._lock:
            self._txn_check(txn_id, gen)
            return self.txn_prepared[txn_id].pop(epoch, None) is not None

    def txn_prepared_epochs(self, txn_id: str) -> List[int]:
        with self._lock:
            return sorted(self.txn_prepared.get(txn_id, {}))


def _parse_brokers(brokers: str):
    if brokers.startswith("memory://"):
        return ("memory", brokers[len("memory://"):])
    return ("kafka", brokers)


def _require_kafka_client() -> str:
    """The client library a real broker goes through: confluent_kafka if
    it imports, else kafka-python; neither raises ``WindFlowError``."""
    try:
        import confluent_kafka  # noqa: F401
        return "confluent"
    except ImportError:
        pass
    try:
        import kafka  # noqa: F401
        return "kafka-python"
    except ImportError:
        raise WindFlowError(
            "Kafka connector: no Kafka client library available "
            "(confluent_kafka / kafka-python); use a memory:// broker or "
            "install a client") from None


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------
class MemoryTransport:
    supports_transactions = True

    def __init__(self, name: str) -> None:
        self.broker = MemoryBroker.get(name)
        self._parts: List[Tuple[str, int]] = []
        self._pos: Dict[Tuple[str, int], int] = {}
        self._rr = 0
        self._group = "windflow"
        self.on_retry = None  # in-process broker: no transient failures

    def _transient_excs(self) -> tuple:
        return ()

    def subscribe(self, topics, group, member, n_members, offsets) -> bool:
        self._group = group
        if offsets:
            # explicit offsets = an explicit assignment of ONLY the listed
            # partitions
            for (t, p), o in _member_share(offsets, member,
                                           n_members).items():
                self._parts.append((t, p))
                self._pos[(t, p)] = o
        else:
            for t in topics:
                for p in self.broker.assign_partitions(t, group, member,
                                                       n_members):
                    self._parts.append((t, p))
                    self._pos[(t, p)] = 0
        return bool(self._parts)

    def consume(self) -> Optional[KafkaMessage]:
        for _ in range(len(self._parts)):
            tp = self._parts[self._rr]
            self._rr = (self._rr + 1) % len(self._parts)
            msg = self.broker.poll(tp[0], tp[1], self._pos[tp])
            if msg is not None:
                self._pos[tp] += 1
                return msg
        return None

    def consume_batch(self, max_n: int) -> List[KafkaMessage]:
        """Up to ``max_n`` messages as contiguous per-partition runs
        (round-robin over the assigned partitions), advancing the same
        cursors ``snapshot_positions`` records as ``consume`` does."""
        out: List[KafkaMessage] = []
        for _ in range(len(self._parts)):
            if len(out) >= max_n:
                break
            tp = self._parts[self._rr]
            self._rr = (self._rr + 1) % len(self._parts)
            run = self.broker.poll_run(tp[0], tp[1], self._pos[tp],
                                       max_n - len(out))
            if run:
                self._pos[tp] += len(run)
                out.extend(run)
        return out

    def produce(self, topic, payload, partition=None, key=None) -> None:
        self.broker.produce(topic, payload, partition, key)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    # -- checkpointing -----------------------------------------------------
    def snapshot_positions(self) -> Dict[Tuple[str, int], int]:
        """The next offset to consume per assigned partition (the
        replayable cursor a checkpoint records)."""
        return dict(self._pos)

    def commit_offsets(self, offsets: Dict[Tuple[str, int], int]) -> None:
        """Group-offset commit when a checkpoint finalizes."""
        with self.broker._lock:
            for (t, p), o in offsets.items():
                self.broker.committed[(self._group, t, p)] = o


def _member_share(offsets, member: int, n_members: int):
    """The explicitly assigned partitions of one replica of the group
    (partition p -> member p % n_members, the rule of
    ``MemoryBroker.assign_partitions``): a non-empty offsets map is an
    explicit assignment, only its partitions are consumed, from the
    given positions."""
    return {(t, p): o for (t, p), o in offsets.items()
            if p % n_members == member}


class _ClientTransport:
    """What the two real-client adapters share: the retry settings (the
    builders' ``with_retries``; the owning replica sets them and points
    ``on_retry`` at its ``Kafka_reconnects``) and ``auto_commit``, which
    a checkpointing source turns off before ``subscribe`` (offsets then
    commit only when a checkpoint finalizes)."""

    retry_attempts = DEFAULT_RETRIES
    retry_base_s = DEFAULT_RETRY_BASE_S

    def __init__(self) -> None:
        self._consumer = None
        self._producer = None
        self.auto_commit = True
        self.on_retry = None

    def _retry(self, fn: Callable, what: str):
        return _retrying(self, fn, what, self.retry_attempts,
                         self.retry_base_s)

    def close(self) -> None:
        if self._consumer is not None:
            self._consumer.close()


def _produce_kwargs(on_delivery, partition, key) -> dict:
    kwargs = {"on_delivery": on_delivery}
    if partition is not None:
        kwargs["partition"] = partition
    if key is not None:
        kwargs["key"] = key
    return kwargs


class ConfluentTransport(_ClientTransport):
    """confluent_kafka (librdkafka) adapter. ``module`` replaces the
    imported client (the tests pass a fake with Consumer / Producer /
    TopicPartition / KafkaException)."""

    supports_transactions = True  # librdkafka's transactional producer

    def __init__(self, brokers: str, module=None) -> None:
        super().__init__()
        if module is None:
            import confluent_kafka as module  # noqa: PLC0415
        self._ck = module
        self.brokers = brokers
        self._txn_producer = None
        self._delivery_errors = 0

    def _transient_excs(self) -> tuple:
        exc = getattr(self._ck, "KafkaException", None)
        return (exc,) if isinstance(exc, type) else ()

    def subscribe(self, topics, group, member, n_members, offsets) -> bool:
        ck = self._ck
        self._consumer = self._retry(lambda: ck.Consumer({
            "bootstrap.servers": self.brokers,
            "group.id": group,
            "enable.auto.commit": self.auto_commit,
            "auto.offset.reset": "earliest",
        }), "consumer connect")
        if offsets:
            # explicit offsets = an explicit assignment (the reference's
            # manual-offset mode), split across the replica group so that
            # no partition is read twice
            mine = _member_share(offsets, member, n_members)
            if not mine:
                return False
            self._consumer.assign([ck.TopicPartition(t, p, o)
                                   for (t, p), o in mine.items()])
        else:
            self._consumer.subscribe(list(topics))
        return True

    @staticmethod
    def _message(msg) -> Optional[KafkaMessage]:
        """A client message as a ``KafkaMessage``; None for a transient
        per-message error (a partition EOF), a fatal one raises."""
        err = msg.error()
        if err is not None:
            if getattr(err, "fatal", lambda: False)():
                raise WindFlowError(f"Kafka consumer error: {err}")
            return None
        ts = msg.timestamp()
        ts_us = ts[1] * 1000 if ts and ts[1] > 0 else current_time_usecs()
        return KafkaMessage(msg.topic(), msg.partition(), msg.offset(),
                            msg.value(), ts_us)

    def consume(self) -> Optional[KafkaMessage]:
        msg = self._retry(lambda: self._consumer.poll(0.01), "consume")
        return None if msg is None else self._message(msg)

    def consume_batch(self, max_n: int) -> List[KafkaMessage]:
        """librdkafka's batch poll (``Consumer.consume``), or repeated
        single polls where the client lacks it; per-message errors as in
        ``consume``."""
        batch_fn = getattr(self._consumer, "consume", None)
        if batch_fn is None:
            out = []
            while len(out) < max_n:
                m = self.consume()
                if m is None:
                    break
                out.append(m)
            return out
        msgs = self._retry(lambda: batch_fn(max_n, 0.01), "consume")
        return [m for m in map(self._message, msgs or ()) if m is not None]

    def _on_delivery(self, err, msg) -> None:
        if err is not None:
            self._delivery_errors += 1

    def produce(self, topic, payload, partition=None, key=None) -> None:
        if self._producer is None:
            self._producer = self._ck.Producer(
                {"bootstrap.servers": self.brokers})
            self._delivery_errors = 0
        p = self._producer
        kwargs = _produce_kwargs(self._on_delivery, partition, key)
        for _ in range(60):
            try:
                self._retry(lambda: p.produce(topic, value=payload,
                                              **kwargs), "produce")
                break
            except BufferError:
                # librdkafka's local queue is full: wait, do not crash
                p.poll(1.0)
        else:
            raise WindFlowError(
                "Kafka sink: local producer queue stayed full for 60s")
        p.poll(0)  # serve delivery callbacks

    def flush(self) -> None:
        if self._producer is None:
            return
        remaining = self._producer.flush(10)
        if remaining or self._delivery_errors:
            raise WindFlowError(
                f"Kafka sink lost data: {self._delivery_errors} delivery "
                f"error(s), {remaining or 0} message(s) still queued at "
                "flush timeout")

    # -- transactions (exactly-once sinks) ---------------------------------
    def txn_produce_epoch(self, txn_id: str, records) -> None:
        """Produce one finalized epoch atomically in a Kafka transaction:
        a ``read_committed`` consumer sees the whole epoch or none of it.
        The transactional id is stable per sink replica, so the broker
        fences a zombie producer of an older run (``init_transactions``
        bumps the producer epoch). Runs on the sink's commit path."""
        if self._txn_producer is None:
            p = self._ck.Producer({"bootstrap.servers": self.brokers,
                                   "transactional.id": txn_id,
                                   "enable.idempotence": True})
            p.init_transactions(30.0)
            self._txn_producer = p
        p = self._txn_producer
        p.begin_transaction()
        try:
            for topic, partition, key, payload in records:
                p.produce(topic, value=payload, **_produce_kwargs(
                    self._on_delivery, partition, key))
            remaining = p.flush(10)
            if remaining or self._delivery_errors:
                raise WindFlowError(
                    f"Kafka exactly-once sink: {self._delivery_errors} "
                    f"delivery error(s), {remaining or 0} message(s) "
                    "unflushed inside the epoch transaction")
            p.commit_transaction(30.0)
        except Exception:
            try:
                p.abort_transaction(10.0)
            except Exception:  # noqa: BLE001 - the first failure matters
                pass
            raise

    # -- checkpointing -----------------------------------------------------
    def snapshot_positions(self) -> Dict[Tuple[str, int], int]:
        if self._consumer is None:
            return {}
        try:
            tps = self._consumer.assignment()
            return {(tp.topic, tp.partition): tp.offset
                    for tp in self._consumer.position(tps)
                    if tp.offset >= 0}
        except self._transient_excs():
            return {}

    def commit_offsets(self, offsets: Dict[Tuple[str, int], int]) -> None:
        if self._consumer is None or not offsets:
            return
        ck = self._ck
        try:
            self._consumer.commit(
                offsets=[ck.TopicPartition(t, p, o)
                         for (t, p), o in offsets.items()],
                asynchronous=False)
        except self._transient_excs():
            pass  # best effort: a failed commit only widens the replay


class KafkaPythonTransport(_ClientTransport):
    """kafka-python adapter (a pure-Python client). ``module`` replaces
    the imported client."""

    supports_transactions = False  # kafka-python has no transactions

    def __init__(self, brokers: str, module=None) -> None:
        super().__init__()
        if module is None:
            import kafka as module  # noqa: PLC0415
        self._kp = module
        self.brokers = brokers.split(",")

    def _transient_excs(self) -> tuple:
        exc = getattr(getattr(self._kp, "errors", None), "KafkaError", None)
        return (exc,) if isinstance(exc, type) else ()

    def subscribe(self, topics, group, member, n_members, offsets) -> bool:
        kp = self._kp
        self._consumer = self._retry(lambda: kp.KafkaConsumer(
            bootstrap_servers=self.brokers, group_id=group,
            enable_auto_commit=self.auto_commit,
            auto_offset_reset="earliest"), "consumer connect")
        if offsets:
            mine = _member_share(offsets, member, n_members)
            if not mine:
                return False
            self._consumer.assign([kp.TopicPartition(t, p)
                                   for (t, p) in mine])
            for (t, p), o in mine.items():
                self._consumer.seek(kp.TopicPartition(t, p), o)
        else:
            self._consumer.subscribe(list(topics))
        return True

    def _poll(self, max_n: int) -> List[KafkaMessage]:
        """One ``poll(max_records=max_n)``, flattened across partitions
        (each partition's records in offset order)."""
        polled = self._retry(lambda: self._consumer.poll(
            timeout_ms=10, max_records=max_n), "consume")
        return [KafkaMessage(r.topic, r.partition, r.offset, r.value,
                             r.timestamp * 1000
                             if getattr(r, "timestamp", 0)
                             else current_time_usecs())
                for records in polled.values() for r in records]

    def consume(self) -> Optional[KafkaMessage]:
        out = self._poll(1)
        return out[0] if out else None

    def consume_batch(self, max_n: int) -> List[KafkaMessage]:
        return self._poll(max_n)

    def produce(self, topic, payload, partition=None, key=None) -> None:
        if self._producer is None:
            self._producer = self._kp.KafkaProducer(
                bootstrap_servers=self.brokers)
        p = self._producer
        self._retry(lambda: p.send(topic, value=payload,
                                   partition=partition, key=key), "produce")

    def flush(self) -> None:
        if self._producer is not None:
            self._producer.flush(timeout=10)

    # -- checkpointing -----------------------------------------------------
    def snapshot_positions(self) -> Dict[Tuple[str, int], int]:
        if self._consumer is None:
            return {}
        try:
            return {(tp.topic, tp.partition): self._consumer.position(tp)
                    for tp in self._consumer.assignment()}
        except self._transient_excs():
            return {}

    def commit_offsets(self, offsets: Dict[Tuple[str, int], int]) -> None:
        if self._consumer is None or not offsets:
            return
        kp = self._kp
        try:
            self._consumer.commit(
                {kp.TopicPartition(t, p): kp.OffsetAndMetadata(o, None)
                 for (t, p), o in offsets.items()})
        except self._transient_excs():
            pass  # best effort: a failed commit only widens the replay


def make_transport(brokers: str):
    """memory:// -> ``MemoryTransport``; any other broker -> the first
    client that imports (confluent_kafka, then kafka-python)."""
    kind, target = _parse_brokers(brokers)
    if kind == "memory":
        return MemoryTransport(target)
    if _require_kafka_client() == "confluent":
        return ConfluentTransport(target)
    return KafkaPythonTransport(target)


def _open_transport(op, on_retry):
    """A replica's transport with its operator's retry settings, each
    retry counted by ``on_retry``."""
    transport = make_transport(op.brokers)
    transport.on_retry = on_retry
    transport.retry_attempts = op.retry_attempts
    transport.retry_base_s = op.retry_base_s
    return transport


# ---------------------------------------------------------------------------
# Kafka_Source
# ---------------------------------------------------------------------------
class Kafka_Source(BasicOperator):
    """Replicas share a consumer group, the partitions split across them;
    the user deserialization functor gets ``(Optional[KafkaMessage],
    shipper[, ctx])`` and returns False to stop (None message = the idle
    timeout).

    Columnar block mode (``with_columnar_blocks`` on the builder): the
    same functor gets a non-empty LIST of messages per call (one batch
    poll, up to ``block_size``), decodes it vectorized and calls
    ``shipper.push_columns``. Offsets snapshot per partition as in the
    per-message mode, and barriers inject only between polls, so a
    checkpoint covers exactly the shipped blocks."""

    op_type = OpType.SOURCE

    def __init__(self, deser_func: Callable, brokers: str,
                 topics: List[str], group_id: str = "windflow",
                 offsets: Optional[Dict[Tuple[str, int], int]] = None,
                 idleness_ms: int = 100, name: str = "kafka_source",
                 parallelism: int = 1, output_batch_size: int = 0) -> None:
        super().__init__(name, parallelism, RoutingMode.NONE,
                         output_batch_size=output_batch_size)
        self.deser_func = deser_func
        self.brokers = brokers
        self.topics = list(topics)
        self.group_id = group_id
        self.offsets = dict(offsets or {})
        self.idleness_ms = idleness_ms
        self._riched = arity(deser_func) >= 3
        self.block_mode = False  # set by with_columnar_blocks
        self.block_size = 512
        # transient-error retries (with_retries)
        self.retry_attempts = DEFAULT_RETRIES
        self.retry_base_s = DEFAULT_RETRY_BASE_S
        if _parse_brokers(brokers)[0] != "memory":
            _require_kafka_client()

    def build_replicas(self) -> None:
        self.replicas = [KafkaSourceReplica(self, i)
                         for i in range(self.parallelism)]


class KafkaSourceReplica(BasicReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        # overload admission control, the contract of SourceReplica._gate
        # (a shed Kafka record is never emitted; its offset still
        # advances, so a restore never replays it)
        self._gate = None
        self._restore_gate_pending = None
        # aligned checkpointing: barriers inject BETWEEN Kafka messages
        # (never between the pushes of one deser call), so the snapshot
        # offsets cover exactly the shipped prefix
        self._coord = None
        self._inject_cb = None
        self._last_ckpt = 0
        self._restore_offsets: Optional[Dict[Tuple[str, int], int]] = None
        self._transport = None
        # the last positions read: a finished replica retires with those
        # of the end of its consume loop (its transport is closed by
        # then), so a restore from a later epoch resumes it at its end,
        # not at its start. A client's transient failure reads none
        # ({}): the last good ones stay
        self._final_offsets: Optional[Dict[Tuple[str, int], int]] = None
        # the offsets of each injected barrier, committed to the broker
        # only when the coordinator finalizes that checkpoint, from THIS
        # thread (a consumer is not thread-safe): the finalize listener
        # only raises _commit_ready
        self._pending_commits: Dict[int, Dict[Tuple[str, int], int]] = {}
        self._commit_ready = 0
        self._committed = 0

    def process(self, payload, ts, wm, tag):  # pragma: no cover
        raise WindFlowError("Kafka_Source has no input")

    def _note_reconnect(self) -> None:
        """Transport retry hook: one transient-error retry
        (``Kafka_reconnects``)."""
        self.stats.kafka_reconnects += 1

    # -- checkpointing -----------------------------------------------------
    def bind_checkpoint(self, coordinator, inject_cb) -> None:
        self._coord = coordinator
        self._inject_cb = inject_cb
        self._last_ckpt = coordinator.requested_id
        coordinator.add_finalize_listener(self._on_finalized)

    def request_checkpoint(self):
        # the barrier injects at the consume loop's next message boundary
        return None if self._coord is None \
            else self._coord.trigger(force=True)

    def _on_finalized(self, ckpt_id: int) -> None:
        # runs on another worker's thread: only publish the epoch
        if ckpt_id > self._commit_ready:
            self._commit_ready = ckpt_id

    def _maybe_inject(self) -> None:
        # every epoch opened since the last one, in order (see
        # SourceReplica._maybe_inject)
        from ..message import Barrier
        cid = self._coord.requested_id
        while self._last_ckpt < cid:
            self._last_ckpt += 1
            if self._transport is not None:
                self._pending_commits[self._last_ckpt] = \
                    self._transport.snapshot_positions()
            self._inject_cb(Barrier(self._last_ckpt))

    def final_checkpoint(self) -> None:
        """At consume-loop exit: inject a pending epoch's barrier with the
        final offsets before EOS, and commit what has finalized."""
        if self._coord is not None and self._transport is not None:
            if self._coord.requested_id != self._last_ckpt:
                self._maybe_inject()
            self._maybe_commit()

    def _maybe_commit(self) -> None:
        ready = self._commit_ready
        if ready <= self._committed or self._transport is None:
            return
        best = max((c for c in self._pending_commits if c <= ready),
                   default=None)
        if best is not None:
            self._transport.commit_offsets(self._pending_commits[best])
            for c in [c for c in self._pending_commits if c <= best]:
                del self._pending_commits[c]
        self._committed = ready

    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        if self._transport is not None:
            # keys are (topic, partition) tuples; a fresh dict per call
            st["offsets"] = self._transport.snapshot_positions()
            self._final_offsets = st["offsets"] or self._final_offsets
        elif self._final_offsets is not None:
            st["offsets"] = dict(self._final_offsets)
        # shed accounting and gate-buffered records ride the snapshot, as
        # a plain source's do
        st["shed_records"] = self.stats.shed_records
        st["shed_bytes"] = self.stats.shed_bytes
        gate = self._gate
        if gate is not None and gate.pending:
            st["gate_pending"] = gate.snapshot_pending()
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        offs = state.get("offsets")
        if offs is not None:
            self._restore_offsets = dict(offs)
        self._restore_gate_pending = state.get("gate_pending")
        self.stats.shed_records = state.get("shed_records", 0)
        self.stats.shed_bytes = state.get("shed_bytes", 0)

    def run_source(self) -> None:
        op = self.op
        pend = self._restore_gate_pending
        if pend:
            # the snapshot's gate-buffered records re-emit before the
            # consume loop resumes (their offsets never replay)
            self._restore_gate_pending = None
            for p, t, w in pend:
                self._advance_wm(w)
                self._emit_admitted(p, t)
        transport = _open_transport(op, self._note_reconnect)
        if self._coord is not None:
            transport.auto_commit = False  # commits ride checkpoints only
        self._transport = transport
        offsets = op.offsets
        if self._restore_offsets is not None:
            # resume from the checkpoint's positions: the snapshot was
            # taken per replica AFTER the group split, so it is already
            # this member's share and subscribe must not split it again
            offsets = self._restore_offsets
            member, n_members = 0, 1
        else:
            member, n_members = self.idx, op.parallelism
        try:
            if not transport.subscribe(op.topics, op.group_id, member,
                                       n_members, offsets):
                return
            self._consume_loop(transport)
            gate = self._gate
            if gate is not None and gate.pending:
                # end of stream with ACCEPTED records still buffered: they
                # emit before the final barrier injects
                for p, t, w in gate.drain_pending():
                    self._advance_wm(w)
                    self._emit_admitted(p, t)
        finally:
            # the worker's final_checkpoint hook runs after run_source, too
            # late for the transport: inject any pending epoch here, with
            # the consumer still open
            try:
                self.final_checkpoint()
                self._final_offsets = (transport.snapshot_positions()
                                       or self._final_offsets)
            finally:
                transport.close()
                self._transport = None

    def _call(self, arg, shipper) -> Any:
        op = self.op
        return (op.deser_func(arg, shipper, self.context) if op._riched
                else op.deser_func(arg, shipper))

    def _consume_loop(self, transport) -> None:
        op = self.op
        shipper = SourceShipper(self)
        idle_budget_us = op.idleness_ms * 1000
        last_progress = current_time_usecs()
        block_n = op.block_size if op.block_mode else 0
        while True:
            if self._coord is not None:
                if self._coord.requested_id != self._last_ckpt:
                    self._maybe_inject()
                self._maybe_commit()
            if block_n:
                # one batch poll, decoded whole by the functor; barriers
                # land only between polls (the transport retries transient
                # client errors)
                msgs = transport.consume_batch(block_n)
                if msgs:
                    last_progress = current_time_usecs()
                    if self._call(msgs, shipper) is False:
                        return
                    continue
            else:
                msg = transport.consume()
                if msg is not None:
                    last_progress = current_time_usecs()
                    if self._call(msg, shipper) is False:
                        return
                    continue
            if current_time_usecs() - last_progress > idle_budget_us:
                # idle timeout: the functor may stop
                if self._call(None, shipper) is False:
                    return
                last_progress = current_time_usecs()
            time.sleep(0.001)

    def ship(self, payload: Any, ts: int, wm: int) -> None:
        gate = self._gate
        if gate is not None:
            # a buffered record emits under its accept-time watermark
            for p, t, w in gate.offer(payload, ts, wm):
                self._advance_wm(w)
                self._emit_admitted(p, t)
            if gate.released and not gate.pending:
                self._gate = None
            return
        self._advance_wm(wm)
        self._emit_admitted(payload, ts)

    def _emit_admitted(self, payload: Any, ts: int) -> None:
        st = self.stats
        st.inputs_received += 1
        # sampled latency tracing, the mask gate of SourceReplica
        if not (st.inputs_received & (st.sample_every - 1)):
            self.emitter.trace_ts = current_time_usecs()
        self.emitter.emit(payload, ts, self.cur_wm)

    def ship_columns(self, cols, ts_arr, wm: int) -> None:
        """The columnar twin of ``ship`` (``shipper.push_columns``): the
        gate / watermark / trace contract of ``SourceReplica.ship_columns``
        without barrier injection (in the Kafka loop barriers land between
        polls, never inside a block)."""
        t0_ns = time.perf_counter_ns()
        gate = self._gate
        if gate is not None:
            if gate.pending:
                for p, t, w in gate.drain_pending():
                    self._advance_wm(w)
                    self._emit_admitted(p, t)
            if gate.released:
                self._gate = None
            else:
                cols, ts_arr, n = gate.offer_columns(cols, ts_arr)
                if n == 0:
                    return
        self._advance_wm(wm)
        st = self.stats
        n = len(ts_arr)
        base = st.inputs_received
        st.inputs_received = base + n
        trace_rows = None
        se = st.sample_every
        if se:
            first = (-(base + 1)) % se
            if first < n:
                trace_rows = np.arange(first, n, se)
                self.emitter.trace_ts = current_time_usecs()
        self.emitter.emit_columns(cols, ts_arr, self.cur_wm, trace_rows)
        st.note_ingest_block(n, time.perf_counter_ns() - t0_ns)


# ---------------------------------------------------------------------------
# Kafka_Sink
# ---------------------------------------------------------------------------
class Kafka_Sink(BasicOperator):
    """The user serializer returns ``(topic, partition_or_None, payload)``,
    or None to drop (``kafka_sink.hpp``: wf_kafka_sink_msg). At least
    once: the producer is flushed before every checkpoint ack; exactly
    once with ``exactly_once`` (``TxnKafkaSinkReplica``)."""

    op_type = OpType.SINK
    # exactly-once mode (sinks/transactional.py): epoch transactions on
    # the broker, prepared at the barrier, committed on finalize
    supports_exactly_once = True

    def __init__(self, ser_func: Callable, brokers: str,
                 name: str = "kafka_sink", parallelism: int = 1) -> None:
        super().__init__(name, parallelism, RoutingMode.FORWARD)
        self.ser_func = ser_func
        self.brokers = brokers
        self._riched = arity(ser_func) >= 2
        if _parse_brokers(brokers)[0] != "memory":
            _require_kafka_client()
        self.exactly_once = False
        # a real broker's exactly-once staging root (with_exactly_once's
        # staging_dir, or the graph's)
        self.txn_dir: Optional[str] = None
        self.retry_attempts = DEFAULT_RETRIES
        self.retry_base_s = DEFAULT_RETRY_BASE_S

    def build_replicas(self) -> None:
        cls = TxnKafkaSinkReplica if self.exactly_once else KafkaSinkReplica
        self.replicas = [cls(self, i) for i in range(self.parallelism)]


class KafkaSinkReplica(BasicReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        # terminal operator: records the e2e latency of traced tuples
        self._e2e = self.stats.hist_e2e
        self._transport = _open_transport(op, self._note_reconnect)

    def _note_reconnect(self) -> None:
        self.stats.kafka_reconnects += 1

    def process(self, payload, ts, wm, tag):
        out = (self.op.ser_func(payload, self.context) if self.op._riched
               else self.op.ser_func(payload))
        if out is None:
            return
        topic, partition, data = out
        self._transport.produce(topic, data, partition)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self) -> dict:
        # flush the producer (and fail loudly on delivery errors) before
        # this worker's ack can let the epoch finalize: a checkpoint must
        # never record source offsets past data that never reached the
        # broker
        self._transport.flush()
        return super().snapshot_state()

    def flush_on_termination(self) -> None:
        self._transport.flush()
        self._transport.close()


# ---------------------------------------------------------------------------
# Exactly-once Kafka sink: epoch transactions driven by the checkpoint
# coordinator (sinks/transactional.py)
# ---------------------------------------------------------------------------
class _MemoryTxnBackend:
    """2PC backend over ``MemoryBroker``'s transaction log: prepared epochs
    live in the broker (they outlive the producer, like a real broker's
    transaction markers) and zombie generations are fenced there."""

    def __init__(self, broker: MemoryBroker, txn_id: str) -> None:
        self.broker = broker
        self.txn_id = txn_id
        self.gen = broker.txn_init(txn_id)

    def check_fence(self) -> None:
        self.broker.txn_check(self.txn_id, self.gen)

    def is_committed(self, epoch: int) -> bool:
        return self.broker.txn_is_committed(self.txn_id, epoch)

    def do_precommit(self, epoch: int, records) -> None:
        self.broker.txn_prepare(self.txn_id, self.gen, epoch, records)

    def do_commit(self, epoch: int):
        self.broker.txn_commit(self.txn_id, self.gen, epoch)
        return None  # no functor delivery: the topic IS the output

    def do_abort(self, epoch: int) -> None:
        self.broker.txn_abort(self.txn_id, self.gen, epoch)

    def do_recover(self, last_epoch: int):
        rolled, aborted = [], []
        for epoch in self.broker.txn_prepared_epochs(self.txn_id):
            if epoch <= last_epoch:
                if self.broker.txn_commit(self.txn_id, self.gen, epoch):
                    rolled.append((epoch, None))
            else:
                self.broker.txn_abort(self.txn_id, self.gen, epoch)
                aborted.append(epoch)
        return rolled, aborted


class _StagedKafkaBackend:
    """Real-broker backend: each epoch is staged durably in a local
    ``SegmentBackend`` (the broker holds nothing until the finalize), and
    its commit produces the whole epoch in one Kafka transaction
    (``txn_produce_epoch``), so a ``read_committed`` consumer sees epochs
    whole. The local ``.seg`` rename is the commit marker.

    One crash window stays open, as in the JAX package (its
    ``docs/API.md``): a crash after the broker's transaction commits and
    before the local rename leaves the epoch pending, and the restore
    rolls it forward into a second transaction, so the epoch is visible
    twice. Closing it needs Kafka's resumable-transaction surface, which
    the client APIs do not expose."""

    def __init__(self, root: str, transport, txn_id: str) -> None:
        from ..sinks.transactional import SegmentBackend
        self._seg = SegmentBackend(root)
        self.transport = transport
        self.txn_id = txn_id

    def is_committed(self, epoch: int) -> bool:
        return self._seg.is_committed(epoch)

    def do_precommit(self, epoch: int, records) -> None:
        self._seg.do_precommit(epoch, records)

    def _staged(self, epoch: int):
        from ..sinks.transactional import port_loads
        return port_loads(self._seg.store.read(epoch, pending=True))

    def do_commit(self, epoch: int):
        records = self._seg._records.get(epoch)
        if records is None and not self._seg.is_committed(epoch):
            records = self._staged(epoch)
        if records:
            self.transport.txn_produce_epoch(self.txn_id, records)
        self._seg.do_commit(epoch)
        return None  # no functor delivery: the topic IS the output

    def do_abort(self, epoch: int) -> None:
        self._seg.do_abort(epoch)

    def do_recover(self, last_epoch: int):
        store = self._seg.store
        store.reap_tmp()
        rolled, aborted = [], []
        for epoch in store.pending_epochs():
            if epoch <= last_epoch:
                records = self._staged(epoch)
                if records:
                    self.transport.txn_produce_epoch(self.txn_id, records)
                store.commit(epoch)
                rolled.append((epoch, None))
            else:
                store.abort(epoch)
                aborted.append(epoch)
        return rolled, aborted


class TxnKafkaSinkReplica(KafkaSinkReplica):
    """Kafka sink in exactly-once mode: serialized records buffer per
    epoch, are prepared at the barrier (in the broker on ``memory://``,
    in a local staged segment on a real broker) and reach the topic only
    when the coordinator finalizes the epoch. The transactional id
    ``wf-txn-<op>-r<idx>`` is stable across restarts and rebuilds, so a
    replica left unwinding by a rescale or a supervised restart is
    fenced."""

    def __init__(self, op, idx):
        super().__init__(op, idx)
        from ..sinks.transactional import EpochTxnDriver, txn_dir_for
        txn_id = f"wf-txn-{op.name}-r{idx}"
        if isinstance(self._transport, MemoryTransport):
            backend = _MemoryTxnBackend(self._transport.broker, txn_id)
        elif self._transport.supports_transactions:
            backend = _StagedKafkaBackend(
                txn_dir_for(op.name, idx, op.txn_dir), self._transport,
                txn_id)
        else:
            raise WindFlowError(
                f"{op.name}: exactly-once needs a transactional producer "
                "— use a memory:// broker or confluent_kafka "
                "(kafka-python has no transactions)")
        self._txn = EpochTxnDriver(backend, self.stats)
        self.on_idle = self._txn.poll

    def process(self, payload, ts, wm, tag):
        out = (self.op.ser_func(payload, self.context) if self.op._riched
               else self.op.ser_func(payload))
        if out is None:
            return
        check = getattr(self._txn.backend, "check_fence", None)
        if check is not None:
            try:
                check()
            except FencedWriteError:
                self.stats.txn_fenced_writes += 1
                raise
        topic, partition, data = out
        self._txn.buffer.append((topic, partition, None, data))

    def handle_msg(self, ch, msg):
        if self._txn.commit_due():
            self._txn.poll()
        super().handle_msg(ch, msg)

    # -- worker and coordinator hooks --------------------------------------
    def bind_txn_coordinator(self, coordinator) -> None:
        self._txn.bind(coordinator)

    def precommit_epoch(self, ckpt_id: int) -> None:
        self._txn.precommit_epoch(ckpt_id)

    def snapshot_state(self) -> dict:
        st = BasicReplica.snapshot_state(self)  # the records ride the txn
        st.update(self._txn.snapshot())
        return st

    def restore_state(self, state: dict) -> None:
        BasicReplica.restore_state(self, state)
        self._txn.restore(state)

    def flush_on_termination(self) -> None:
        # EOS: stage the post-barrier tail as one final epoch; it (and any
        # epoch not yet finalized) commits in txn_complete once the run
        # is known to have finished cleanly
        self._txn.seal_tail()

    def txn_complete(self) -> None:
        self._txn.complete_all()
        self._transport.flush()
        self._transport.close()
