"""Persistent basic operators: keyed state that lives in an embedded DB.

The port's copy of ``windflow_tpu/persistent/p_basic_ops.py`` (parity:
``wf/persistent/`` p_filter / p_map / p_flatmap / p_reduce / p_sink): the
in-memory operators' logic, with each tuple reading and writing its key's
state through a ``DBHandle`` behind an LRU (or LFU) cache. The functor
gets ``(tuple, state)`` and returns ``(result, new_state)`` (P_Map,
P_Filter), the new state (P_Reduce, P_Sink), or takes a shipper
(P_FlatMap). ``initial_state`` is deep-copied per key on first sight.

Each replica owns one sqlite file ``<op>_r<idx>.db`` under the operator's
``db_dir``; at EOS the cache is flushed, so the database holds the final
keyed state. A checkpoint blob carries the whole database image, and a
restore replaces the file with it. ``P_Sink`` in exactly-once mode
(``PTxnSinkReplica``) is an epoch-fenced sqlite writer: the data and the
``epoch`` marker commit in one sqlite transaction at the barrier, the
``finalized`` marker follows the coordinator's finalize, and a replica
of an older generation is refused by the in-DB fence.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

from ..basic import OpType, RoutingMode, WindFlowError
from ..operators.base import BasicOperator, BasicReplica, arity
from ..operators.basic_ops import Shipper
from .cache import LRUStore
from .db_handle import DBHandle


class _PersistentOperator(BasicOperator):
    def __init__(self, func: Callable, key_extractor, initial_state: Any,
                 name: str, parallelism: int, output_batch_size: int,
                 db_dir: Optional[str] = None, cache_capacity: int = 1024,
                 serialize=None, deserialize=None,
                 input_routing: RoutingMode = RoutingMode.KEYBY,
                 cache_policy: str = "lru") -> None:
        if key_extractor is None:
            raise WindFlowError(f"{name}: persistent operators require a "
                                "key extractor")
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.func = func
        self.initial_state = initial_state
        self.db_dir = db_dir
        self.cache_capacity = cache_capacity
        self.cache_policy = cache_policy
        self.serialize = serialize
        self.deserialize = deserialize
        self._riched = arity(func) >= 3

    @property
    def is_chainable(self) -> bool:
        return False

    replica_cls: type = None

    def build_replicas(self) -> None:
        self.replicas = [self.replica_cls(self, i)
                         for i in range(self.parallelism)]


class _PersistentReplica(BasicReplica):
    def __init__(self, op: _PersistentOperator, idx: int) -> None:
        super().__init__(op, idx)
        self.db = DBHandle(f"{op.name}_r{idx}", op.serialize, op.deserialize,
                           op.db_dir)
        self.state = LRUStore(self.db, op.cache_capacity,
                              policy=op.cache_policy)

    def _get_state(self, key):
        try:
            return self.state[key]
        except KeyError:
            return copy.deepcopy(self.op.initial_state)

    def _call(self, *args):
        if self.op._riched:
            return self.op.func(*args, self.context)
        return self.op.func(*args)

    def flush_on_termination(self) -> None:
        self.state.flush()

    def terminate(self) -> None:
        super().terminate()
        self.db.close()

    # -- checkpointing -----------------------------------------------------
    # Keyed state lives in cache+DB; spill the cache and snapshot the DB
    # file as one consistent image. Restore REPLACES the on-disk contents:
    # after a crash the file holds post-checkpoint writes that must roll
    # back to the barrier point.
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        self.state.flush()
        st["db"] = self.db.snapshot_bytes()
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        blob = state.get("db")
        if blob is not None:
            self.db.restore_bytes(blob)


# ---------------------------------------------------------------------------
class P_Map(_PersistentOperator):
    """func(tuple, state) -> (mapped, new_state). The pair is mandatory —
    a mutate-style functor returns (mapped, state) with the same (mutated)
    state object; inferring intent from the return shape would corrupt
    state whenever the mapped value itself is a 2-tuple."""


class PMapReplica(_PersistentReplica):
    def process(self, payload, ts, wm, tag):
        key = self.op.key_extractor(payload)
        st = self._get_state(key)
        out = self._call(payload, st)
        if not (isinstance(out, tuple) and len(out) == 2):
            raise WindFlowError(
                f"{self.op.name}: P_Map functor must return "
                "(result, new_state)")
        result, st = out
        self.state[key] = st
        if result is not None:
            self.emitter.emit(result, ts, wm)


P_Map.replica_cls = PMapReplica


class P_Filter(_PersistentOperator):
    """func(tuple, state) -> (keep, new_state); the pair is mandatory
    (see P_Map)."""


class PFilterReplica(_PersistentReplica):
    def process(self, payload, ts, wm, tag):
        key = self.op.key_extractor(payload)
        st = self._get_state(key)
        out = self._call(payload, st)
        if not (isinstance(out, tuple) and len(out) == 2):
            raise WindFlowError(
                f"{self.op.name}: P_Filter functor must return "
                "(keep, new_state)")
        keep, st = out
        self.state[key] = st
        if keep:
            self.emitter.emit(payload, ts, wm)
        else:
            self.stats.inputs_ignored += 1


P_Filter.replica_cls = PFilterReplica


class P_FlatMap(_PersistentOperator):
    """func(tuple, shipper, state) -> new_state (or mutate state)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._riched = arity(self.func) >= 4


class PFlatMapReplica(_PersistentReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        self.shipper = Shipper(self)

    def process(self, payload, ts, wm, tag):
        key = self.op.key_extractor(payload)
        st = self._get_state(key)
        self.shipper._ts = ts
        self.shipper._wm = wm
        out = self._call(payload, self.shipper, st)
        self.state[key] = out if out is not None else st


P_FlatMap.replica_cls = PFlatMapReplica


class P_Reduce(_PersistentOperator):
    """Keyed running reduce with durable state: func(tuple, state) ->
    new_state; the updated state is emitted after each update (like
    Reduce)."""


class PReduceReplica(_PersistentReplica):
    def process(self, payload, ts, wm, tag):
        key = self.op.key_extractor(payload)
        st = self._get_state(key)
        out = self._call(payload, st)
        if out is not None:
            st = out
        self.state[key] = st
        self.emitter.emit(copy.copy(st), ts, wm)


P_Reduce.replica_cls = PReduceReplica


class P_Sink(_PersistentOperator):
    """func(Optional[tuple], state) -> new_state per tuple; None at EOS."""

    op_type = OpType.SINK
    # exactly-once mode: the sqlite file carries the 2PC epoch marker and
    # a replica-generation fence (windflow_tpu.sinks.transactional)
    supports_exactly_once = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.exactly_once = False

    def build_replicas(self) -> None:
        cls = PTxnSinkReplica if self.exactly_once else PSinkReplica
        self.replicas = [cls(self, i) for i in range(self.parallelism)]


class PSinkReplica(_PersistentReplica):
    def process(self, payload, ts, wm, tag):
        key = self.op.key_extractor(payload)
        st = self._get_state(key)
        out = self._call(payload, st)
        self.state[key] = out if out is not None else st

    def flush_on_termination(self) -> None:
        # EOS marker per key (the in-memory Sink gets one func(None) call;
        # the keyed persistent sink finalizes every key's state)
        for key, st in list(self.state.items()):
            out = self._call(None, st)
            if out is not None:
                self.state[key] = out
        super().flush_on_termination()


P_Sink.replica_cls = PSinkReplica


# ---------------------------------------------------------------------------
# Exactly-once persistent sink: epoch-fenced sqlite writer
# ---------------------------------------------------------------------------
class _PSinkTxnBackend:
    """2PC backend over the replica's own sqlite file. The staged state
    IS the database: between barriers every write sits in the cache or
    the open implicit sqlite transaction; pre-commit spills the cache and
    commits data + ``epoch`` marker atomically; phase-2 commit only
    advances the ``finalized`` marker (the visibility watermark external
    readers compare against ``epoch``). Restore replaces the whole file
    with the checkpoint image, so roll-forward/abort reduce to stamping
    the markers at the restored epoch. Every durable step first checks
    the generation fence — a zombie pre-rescale replica is refused before
    it can commit anything."""

    always_seal = True  # the tail epoch lives in the DB, not in buffer

    def __init__(self, replica: "PTxnSinkReplica") -> None:
        self.r = replica

    def do_precommit(self, epoch: int, records) -> None:
        r = self.r
        r._check_fence()
        for k, v in list(r.state.cache.items()):
            r.db.put(k, v)
        r.db.meta_put("epoch", epoch)
        r.db.commit()

    def do_commit(self, epoch: int):
        r = self.r
        r._check_fence()
        r.db.meta_put("finalized", epoch)
        r.db.commit()
        return None

    def do_abort(self, epoch: int) -> None:
        pass  # nothing staged outside the DB image

    def do_recover(self, last_epoch: int):
        # the checkpoint image (already restored into the file by
        # restore_state) is exactly the barrier state of ``last_epoch``:
        # stamp both markers there and re-assert this replica's fence
        # over whatever generation the image recorded
        r = self.r
        r.db.meta_put("fence", r._fence)
        r.db.meta_put("epoch", last_epoch)
        r.db.meta_put("finalized", last_epoch)
        r.db.commit()
        return [], []


class PTxnSinkReplica(PSinkReplica):
    def __init__(self, op, idx):
        super().__init__(op, idx)
        from ..sinks.transactional import EpochTxnDriver
        # acquire this replica generation's fence token: one atomic bump
        # of the in-DB generation — rebuilding the runtime plane (a live
        # rescale, a restore) creates a new replica and fences the old
        self._fence = (self.db.meta_get("fence") or 0) + 1
        self.db.meta_put("fence", self._fence)
        self.db.commit()
        self._txn = EpochTxnDriver(_PSinkTxnBackend(self), self.stats)
        self.on_idle = self._txn.poll

    def _check_fence(self) -> None:
        # accounting (Sink_txn_fenced_writes + the txn:fenced span)
        # happens in the driver, which wraps every backend verb
        from ..sinks.transactional import FencedWriteError
        stored = self.db.meta_get("fence")
        if stored != self._fence:
            raise FencedWriteError(
                f"{self.op.name} replica {self.idx}: sqlite epoch fence "
                f"{self._fence} is stale (current {stored}); a newer "
                "replica generation owns this database — refusing the "
                "write")

    # -- worker / coordinator hooks ----------------------------------------
    def bind_txn_coordinator(self, coordinator) -> None:
        self._txn.bind(coordinator)

    def precommit_epoch(self, ckpt_id: int) -> None:
        self._txn.precommit_epoch(ckpt_id)

    def handle_msg(self, ch, msg):
        t = self._txn
        if t._pending and min(t._pending) <= t._commit_ready:
            t.poll()
        super().handle_msg(ch, msg)

    # -- checkpointing ------------------------------------------------------
    def snapshot_state(self) -> dict:
        # the precommit hook already spilled + committed the epoch; the
        # inherited snapshot captures the image (markers included)
        st = super().snapshot_state()
        st.update(self._txn.snapshot())
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)  # replaces the DB with the image
        self._txn.restore(state)      # -> do_recover stamps markers+fence

    def flush_on_termination(self) -> None:
        # per-key EOS finalization mutates state like normal processing:
        # it belongs to the tail epoch, staged (pre-committed) here and
        # finalized in txn_complete on a clean end of run
        for key, st in list(self.state.items()):
            out = self._call(None, st)
            if out is not None:
                self.state[key] = out
        self._txn.seal_tail()

    def terminate(self) -> None:
        # keep the DB open: txn_complete still has markers to commit
        if self.terminated:
            return
        self.terminated = True
        self.flush_on_termination()
        if self.op.closing_func is not None:
            if arity(self.op.closing_func) >= 1:
                self.op.closing_func(self.context)
            else:
                self.op.closing_func()
        if self.emitter is not None:
            self.emitter.flush()
        self.stats.is_terminated = True

    def txn_complete(self) -> None:
        self._txn.complete_all()
        self.db.close()
