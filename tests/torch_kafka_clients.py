"""In-process fake ``confluent_kafka`` and ``kafka`` (kafka-python) client
modules over one shared ``Cluster``: the Kafka adapters of both packages
run end to end through them with no broker and no client library.

    cluster = Cluster(n_partitions=8)
    monkeypatch.setitem(sys.modules, "confluent_kafka", make_confluent(cluster))
    monkeypatch.setitem(sys.modules, "kafka", None)   # confluent only

or, outside pytest, ``with installed(cluster, "confluent"): ...``.

What the cluster models, for the adapters' sake:

- partitioned topic logs; a record written inside a transaction carries
  it, and ``read_committed(topic)`` is what a ``read_committed`` consumer
  sees (librdkafka's rule: nothing of an aborted or still-open
  transaction; a partition is read up to its first open record);
- transactional producers: ``init_transactions`` bumps the producer epoch
  of its ``transactional.id`` and aborts that id's open transaction, so a
  producer of an older run is fenced (its next begin / commit raises a
  fatal ``KafkaException``);
- consumer groups: subscribed members split the partitions (p % members
  == the member's join index) and share the group's fetch positions, so
  a member joining or leaving moves partitions without a record lost or
  read twice; a group with no member left restarts from its committed
  offsets (earliest without). ``enable.auto.commit`` commits each
  consumed offset at once; ``assign`` / ``seek`` are explicit cursors;
  ``assignment``, ``position`` and ``commit`` work on both;
- faults: ``fail_next(op, n, fatal=False, after=0)`` makes ``n`` calls
  of ``op`` (``"connect"``, ``"poll"``, ``"produce"``), after the next
  ``after`` ones, raise the client's error (confluent: ``KafkaException``
  over a ``KafkaError`` with ``fatal()``; kafka-python:
  ``kafka.errors.KafkaError``), and ``fail_next("deliver", n)`` fails
  deliveries (the delivery callback gets the error; nothing is
  written).

Every call takes the cluster's lock: the sinks' commit path runs on
another thread than their consumers. Imports neither jax nor either
package.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import types
from collections import Counter
from typing import Dict, List, Optional, Tuple

OFFSET_INVALID = -1001  # librdkafka's "no position yet"


class _Txn:
    __slots__ = ("txn_id", "status")

    def __init__(self, txn_id: str) -> None:
        self.txn_id = txn_id
        self.status = "open"  # -> "committed" | "aborted"


class _Record:
    __slots__ = ("value", "key", "txn", "ts_ms")

    def __init__(self, value, key, txn: Optional[_Txn]) -> None:
        self.value, self.key, self.txn = value, key, txn
        self.ts_ms = int(time.time() * 1000)


class Fenced(Exception):
    """A producer of an older epoch of its transactional id."""


class Cluster:
    def __init__(self, n_partitions: int = 2) -> None:
        self.n_partitions = n_partitions
        self.lock = threading.RLock()
        self._logs: Dict[str, List[List[_Record]]] = {}
        self.committed: Dict[Tuple[str, str, int], int] = {}
        self._fetch: Dict[Tuple[str, str, int], int] = {}
        self._members: Dict[str, list] = {}
        self._txn_epoch: Dict[str, int] = {}
        self._open_txn: Dict[str, _Txn] = {}
        self._faults: Dict[str, List[Optional[bool]]] = {}
        # transactions by outcome, and fenced calls refused
        self.txn_counts: Counter = Counter()

    # -- faults ------------------------------------------------------------
    def fail_next(self, op: str, n: int = 1, fatal: bool = False,
                  after: int = 0) -> None:
        with self.lock:
            self._faults.setdefault(op, []).extend([None] * after
                                                   + [fatal] * n)

    def pending_faults(self, op: str) -> int:
        with self.lock:
            return sum(f is not None for f in self._faults.get(op, ()))

    def _fault(self, op: str) -> Optional[bool]:
        """None, or whether the injected fault of ``op`` is fatal."""
        with self.lock:
            q = self._faults.get(op)
            return q.pop(0) if q else None

    # -- logs --------------------------------------------------------------
    def _log(self, topic: str) -> List[List[_Record]]:
        log = self._logs.get(topic)
        if log is None:
            log = self._logs[topic] = [[] for _ in range(self.n_partitions)]
        return log

    def append(self, topic, value, partition=None, key=None,
               txn: Optional[_Txn] = None) -> Tuple[int, int]:
        with self.lock:
            log = self._log(topic)
            if partition is None or partition < 0:
                partition = (hash(key) if key is not None
                             else sum(map(len, log))) % self.n_partitions
            part = log[partition]
            part.append(_Record(value, key, txn))
            return partition, len(part) - 1

    def next_visible(self, topic, partition, offset, read_committed=True):
        """(record, offset) of the first record a consumer at ``offset``
        gets, or (None, offset) where it has to wait: aborted records are
        skipped, an open one blocks a read_committed consumer."""
        with self.lock:
            part = self._log(topic)[partition]
            while offset < len(part):
                rec = part[offset]
                txn = rec.txn
                if txn is None or txn.status == "committed" \
                        or not read_committed:
                    return rec, offset
                if txn.status == "open":
                    return None, offset
                offset += 1  # aborted
            return None, offset

    def read_committed(self, topic: str) -> list:
        """Every value a read_committed consumer of ``topic`` gets,
        partition by partition in offset order."""
        out = []
        with self.lock:
            for p in range(self.n_partitions):
                off = 0
                while True:
                    rec, off = self.next_visible(topic, p, off)
                    if rec is None:
                        break
                    out.append(rec.value)
                    off += 1
        return out

    def end_offsets(self, topic: str) -> List[int]:
        with self.lock:
            return [len(p) for p in self._log(topic)]

    # -- groups ------------------------------------------------------------
    def join(self, group: str, member, topics) -> None:
        with self.lock:
            self._members.setdefault(group, []).append(member)
            for t in topics:
                for p in range(self.n_partitions):
                    self._fetch.setdefault(
                        (group, t, p), self.committed.get((group, t, p), 0))

    def leave(self, group: str, member) -> None:
        with self.lock:
            members = self._members.get(group, [])
            if member in members:
                members.remove(member)
            if not members:
                for k in [k for k in self._fetch if k[0] == group]:
                    del self._fetch[k]

    def share(self, group: str, member, topics) -> List[Tuple[str, int]]:
        """The partitions ``member`` of ``group`` reads now."""
        with self.lock:
            members = self._members.get(group, [])
            if member not in members:
                return []
            i, n = members.index(member), len(members)
            return [(t, p) for t in topics for p in range(self.n_partitions)
                    if p % n == i]

    # -- transactions ------------------------------------------------------
    def init_transactions(self, txn_id: str) -> int:
        with self.lock:
            epoch = self._txn_epoch.get(txn_id, 0) + 1
            self._txn_epoch[txn_id] = epoch
            txn = self._open_txn.pop(txn_id, None)
            if txn is not None:
                txn.status = "aborted"
                self.txn_counts["aborted_by_init"] += 1
            return epoch

    def check_epoch(self, txn_id: str, epoch: int) -> None:
        with self.lock:
            if self._txn_epoch.get(txn_id) != epoch:
                self.txn_counts["fenced"] += 1
                raise Fenced(
                    f"producer epoch {epoch} of {txn_id!r} is fenced "
                    f"(current {self._txn_epoch.get(txn_id)})")

    def begin(self, txn_id: str, epoch: int) -> _Txn:
        with self.lock:
            self.check_epoch(txn_id, epoch)
            if txn_id in self._open_txn:
                raise RuntimeError(f"{txn_id!r}: a transaction is open")
            txn = self._open_txn[txn_id] = _Txn(txn_id)
            return txn

    def end(self, txn: _Txn, epoch: int, status: str) -> None:
        with self.lock:
            if status == "committed":
                self.check_epoch(txn.txn_id, epoch)
            if self._open_txn.get(txn.txn_id) is txn:
                del self._open_txn[txn.txn_id]
            if txn.status == "open":
                txn.status = status
                self.txn_counts[status] += 1


# ---------------------------------------------------------------------------
# consumers: the cursor logic both fakes share
# ---------------------------------------------------------------------------
class _Cursor:
    """A consumer's reading state: subscribed (the group's shared fetch
    positions over its current share) or assigned (its own positions)."""

    def __init__(self, cluster: Cluster, group, auto_commit: bool,
                 read_committed: bool) -> None:
        self.c = cluster
        self.group = group
        self.auto_commit = auto_commit
        self.read_committed = read_committed
        self.topics: List[str] = []
        self.own: Dict[Tuple[str, int], int] = {}
        self.subscribed = False
        self.rr = 0
        self.closed = False

    def subscribe(self, topics) -> None:
        self.topics = list(topics)
        self.subscribed = True
        self.c.join(self.group, self, self.topics)

    def assign(self, tps: Dict[Tuple[str, int], int]) -> None:
        self.own = dict(tps)

    def parts(self) -> List[Tuple[str, int]]:
        if self.subscribed:
            return self.c.share(self.group, self, self.topics)
        return list(self.own)

    def _pos(self, tp) -> int:
        if self.subscribed:
            return self.c._fetch[(self.group,) + tp]
        return self.own[tp]

    def _set(self, tp, off: int) -> None:
        if self.subscribed:
            self.c._fetch[(self.group,) + tp] = off
        else:
            self.own[tp] = off
        if self.auto_commit and self.group is not None:
            self.c.committed[(self.group,) + tp] = off

    def position(self, tp) -> int:
        with self.c.lock:
            if self.subscribed:
                return self.c._fetch.get((self.group,) + tp, OFFSET_INVALID)
            return self.own.get(tp, OFFSET_INVALID)

    def take(self, max_n: int, one_partition: bool):
        """Up to ``max_n`` (topic, partition, offset, record): one record
        from the next partition in turn with records, or (batch) a run of
        one partition."""
        with self.c.lock:
            parts = self.parts()
            for _ in range(len(parts)):
                tp = parts[self.rr % len(parts)]
                self.rr += 1
                out, off = [], self._pos(tp)
                while len(out) < max_n:
                    rec, off = self.c.next_visible(tp[0], tp[1], off,
                                                   self.read_committed)
                    if rec is None:
                        break
                    out.append((tp[0], tp[1], off, rec))
                    off += 1
                    if not one_partition:
                        break
                if out:
                    self._set(tp, off)
                    return out
            return []

    def commit(self, offsets: Dict[Tuple[str, int], int]) -> None:
        with self.c.lock:
            for tp, o in offsets.items():
                self.c.committed[(self.group,) + tp] = o

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            if self.subscribed:
                self.c.leave(self.group, self)


# ---------------------------------------------------------------------------
# fake confluent_kafka
# ---------------------------------------------------------------------------
def make_confluent(cluster: Cluster, batch_consume: bool = True):
    """A fake ``confluent_kafka`` module over ``cluster``; without
    ``batch_consume`` its Consumer has no ``consume`` (the adapter's
    single-poll fallback)."""

    class KafkaError:
        _TRANSPORT = -195
        _FENCED = -144

        def __init__(self, code, reason="", fatal=False):
            self._code, self._reason, self._fatal = code, reason, fatal

        def code(self):
            return self._code

        def str(self):
            return self._reason

        def fatal(self):
            return self._fatal

        def retriable(self):
            return not self._fatal

        def __repr__(self):
            return f"KafkaError({self._code}, {self._reason!r})"

        __str__ = __repr__

    class KafkaException(Exception):
        pass

    def raise_fault(op):
        fatal = cluster._fault(op)
        if fatal is not None:
            raise KafkaException(KafkaError(
                KafkaError._TRANSPORT, f"injected {op} failure", fatal))

    class TopicPartition:
        def __init__(self, topic, partition=-1, offset=OFFSET_INVALID):
            self.topic, self.partition, self.offset = \
                topic, partition, offset

        def __repr__(self):
            return f"TopicPartition({self.topic}, {self.partition}, " \
                   f"{self.offset})"

    class Message:
        def __init__(self, topic, partition, offset, rec, err=None):
            self._t, self._p, self._o, self._r = topic, partition, offset, rec
            self._err = err

        def topic(self):
            return self._t

        def partition(self):
            return self._p

        def offset(self):
            return self._o

        def value(self):
            return None if self._r is None else self._r.value

        def key(self):
            return None if self._r is None else self._r.key

        def error(self):
            return self._err

        def timestamp(self):
            return (1, self._r.ts_ms) if self._r is not None else (0, -1)

    class Consumer:
        def __init__(self, conf):
            raise_fault("connect")
            if "bootstrap.servers" not in conf or "group.id" not in conf:
                raise KafkaException(KafkaError(-186, "bad config", True))
            self.conf = dict(conf)
            self._cur = _Cursor(
                cluster, conf["group.id"],
                bool(conf.get("enable.auto.commit", True)),
                conf.get("isolation.level", "read_committed")
                == "read_committed")

        def subscribe(self, topics):
            self._cur.subscribe(topics)

        def assign(self, tps):
            self._cur.assign({(tp.topic, tp.partition): max(0, tp.offset)
                              for tp in tps})

        def assignment(self):
            return [TopicPartition(t, p) for t, p in self._cur.parts()]

        def position(self, tps):
            return [TopicPartition(tp.topic, tp.partition,
                                   self._cur.position((tp.topic,
                                                       tp.partition)))
                    for tp in tps]

        def poll(self, timeout=None):
            raise_fault("poll")
            got = self._cur.take(1, one_partition=True)
            return Message(*got[0]) if got else None

        def commit(self, message=None, offsets=None, asynchronous=True):
            self._cur.commit({(tp.topic, tp.partition): tp.offset
                              for tp in offsets or ()})

        def close(self):
            self._cur.close()

    if batch_consume:
        def consume(self, num_messages=1, timeout=-1):
            raise_fault("poll")
            return [Message(*g) for g in self._cur.take(num_messages,
                                                        one_partition=True)]
        Consumer.consume = consume

    class Producer:
        def __init__(self, conf):
            if "bootstrap.servers" not in conf:
                raise KafkaException(KafkaError(-186, "bad config", True))
            self.conf = dict(conf)
            self.txn_id = conf.get("transactional.id")
            self._epoch = None
            self._txn = None
            self._callbacks = []
            self._lock = threading.Lock()

        def _fenced(self, e):
            raise KafkaException(KafkaError(KafkaError._FENCED, str(e),
                                            True)) from None

        def init_transactions(self, timeout=None):
            if self.txn_id is None:
                raise KafkaException(KafkaError(-172, "not transactional",
                                                True))
            self._epoch = cluster.init_transactions(self.txn_id)

        def begin_transaction(self):
            if self._epoch is None:
                raise KafkaException(KafkaError(-172, "no init", True))
            try:
                self._txn = cluster.begin(self.txn_id, self._epoch)
            except Fenced as e:
                self._fenced(e)

        def commit_transaction(self, timeout=None):
            txn, self._txn = self._txn, None
            try:
                cluster.end(txn, self._epoch, "committed")
            except Fenced as e:
                cluster.end(txn, self._epoch, "aborted")
                self._fenced(e)

        def abort_transaction(self, timeout=None):
            txn, self._txn = self._txn, None
            if txn is not None:
                cluster.end(txn, self._epoch, "aborted")

        def produce(self, topic, value=None, key=None, partition=-1,
                    on_delivery=None, **kwargs):
            raise_fault("produce")
            if self.txn_id is not None and self._txn is None:
                raise KafkaException(KafkaError(-172, "produce outside a "
                                                "transaction", True))
            if cluster._fault("deliver") is not None:
                err = KafkaError(KafkaError._TRANSPORT, "delivery failed")
                msg = Message(topic, partition, -1, None, err)
            else:
                p, off = cluster.append(topic, value, partition, key,
                                        self._txn)
                err, msg = None, Message(topic, p, off, None)
            if on_delivery is not None:
                with self._lock:
                    self._callbacks.append((on_delivery, err, msg))

        def poll(self, timeout=None):
            with self._lock:
                cbs, self._callbacks = self._callbacks, []
            for cb, err, msg in cbs:
                cb(err, msg)
            return len(cbs)

        def flush(self, timeout=None):
            self.poll(0)
            return 0

    mod = types.ModuleType("confluent_kafka")
    mod.__dict__.update(Consumer=Consumer, Producer=Producer,
                        TopicPartition=TopicPartition,
                        KafkaException=KafkaException, KafkaError=KafkaError,
                        OFFSET_INVALID=OFFSET_INVALID, cluster=cluster)
    return mod


# ---------------------------------------------------------------------------
# fake kafka-python
# ---------------------------------------------------------------------------
def make_kafka_python(cluster: Cluster):
    """A fake ``kafka`` (kafka-python) module over ``cluster``."""

    class KafkaError(RuntimeError):
        retriable = True

    errors = types.ModuleType("kafka.errors")
    errors.KafkaError = KafkaError

    def raise_fault(op):
        if cluster._fault(op) is not None:
            raise KafkaError(f"injected {op} failure")

    class TopicPartition(tuple):
        def __new__(cls, topic, partition):
            return tuple.__new__(cls, (topic, partition))

        topic = property(lambda self: self[0])
        partition = property(lambda self: self[1])

    class OffsetAndMetadata(tuple):
        def __new__(cls, offset, metadata):
            return tuple.__new__(cls, (offset, metadata))

        offset = property(lambda self: self[0])

    class ConsumerRecord:
        def __init__(self, topic, partition, offset, rec):
            self.topic, self.partition, self.offset = topic, partition, offset
            self.value, self.key, self.timestamp = rec.value, rec.key, \
                rec.ts_ms

    class KafkaConsumer:
        def __init__(self, *topics, bootstrap_servers=None, group_id=None,
                     enable_auto_commit=True, auto_offset_reset="latest",
                     isolation_level="read_uncommitted", **kwargs):
            raise_fault("connect")
            if not bootstrap_servers:
                raise KafkaError("no bootstrap_servers")
            self._cur = _Cursor(cluster, group_id, enable_auto_commit,
                                isolation_level == "read_committed")
            if topics:
                self.subscribe(topics)

        def subscribe(self, topics):
            self._cur.subscribe(topics)

        def assign(self, tps):
            self._cur.assign({(tp.topic, tp.partition): 0 for tp in tps})

        def seek(self, tp, offset):
            self._cur.own[(tp.topic, tp.partition)] = offset

        def assignment(self):
            return {TopicPartition(t, p) for t, p in self._cur.parts()}

        def position(self, tp):
            return self._cur.position((tp.topic, tp.partition))

        def poll(self, timeout_ms=0, max_records=None):
            raise_fault("poll")
            got = self._cur.take(max_records or 500, one_partition=True)
            if not got:
                return {}
            t, p = got[0][0], got[0][1]
            return {TopicPartition(t, p): [ConsumerRecord(*g) for g in got]}

        def commit(self, offsets=None):
            self._cur.commit({(tp.topic, tp.partition): om.offset
                              for tp, om in (offsets or {}).items()})

        def close(self, autocommit=True):
            self._cur.close()

    class KafkaProducer:
        def __init__(self, bootstrap_servers=None, **kwargs):
            if not bootstrap_servers:
                raise KafkaError("no bootstrap_servers")

        def send(self, topic, value=None, key=None, partition=None, **kw):
            raise_fault("produce")
            cluster.append(topic, value, partition, key)

        def flush(self, timeout=None):
            pass

        def close(self, timeout=None):
            pass

    mod = types.ModuleType("kafka")
    mod.__dict__.update(KafkaConsumer=KafkaConsumer,
                        KafkaProducer=KafkaProducer,
                        TopicPartition=TopicPartition,
                        OffsetAndMetadata=OffsetAndMetadata, errors=errors,
                        cluster=cluster)
    return mod


@contextlib.contextmanager
def installed(cluster: Cluster, client: str = "confluent"):
    """The fake ``client`` ("confluent" or "kafka-python") in
    ``sys.modules`` for the block, the other client hidden; both names
    restored after it."""
    saved = {n: sys.modules.get(n, _MISSING) for n in _NAMES}
    try:
        if client == "confluent":
            sys.modules["confluent_kafka"] = make_confluent(cluster)
            sys.modules["kafka"] = None
        else:
            sys.modules["confluent_kafka"] = None
            sys.modules["kafka"] = make_kafka_python(cluster)
        yield
    finally:
        for n, m in saved.items():
            if m is _MISSING:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


_MISSING = object()
_NAMES = ("confluent_kafka", "kafka")
