"""Exactly-once sinks: epoch-fenced two-phase commit on checkpoint finalize.

The port's copy of ``windflow_tpu/sinks/transactional.py``. Aligned-barrier
checkpointing alone gives at-least-once delivery: after a restore the
sources replay the suffix after the barrier and every sink emits it again.
A two-phase commit whose coordinator is the ``CheckpointCoordinator``
closes the gap:

- between barriers a sink replica stages its output under the CURRENT
  epoch (an in-memory buffer for functor sinks, a broker transaction for
  Kafka, the open sqlite transaction for ``P_Sink``);
- when the barrier reaches it (``Worker.checkpoint_now`` calls the
  replica's ``precommit_epoch(ckpt_id)`` after the drain, before the
  capture) the epoch is **pre-committed**: made durable but not visible
  (a segment file published by tmp + atomic rename, a prepared broker
  transaction, a committed sqlite image carrying the epoch marker);
- when the coordinator finalizes the epoch, a finalize listener (on the
  acking worker's thread, or the uploader's under ``async_upload``) only
  raises a watermark, and the sink's own thread **commits** every
  pre-committed epoch at or below it (``.pending`` -> ``.seg``, the
  broker commit, the sqlite ``finalized`` marker);
- on a restore from checkpoint ``cid``, pre-committed epochs ``<= cid``
  roll FORWARD (their records precede the barrier, and the replay will
  not produce them again) and epochs ``> cid`` abort (the replay produces
  them again), so kill anywhere, restore and compare gives byte-identical
  output without duplicates.

Fencing: a replica acquires a rising fence token when it opens its
transaction log (a ``fence`` file, a broker transactional id, an sqlite
meta row). Rebuilding the runtime plane (a live ``rescale()``, a
restore, a supervised restart) bumps it, and a write or commit by a
replica of an older generation raises ``FencedWriteError``.

Segment files are pickled record lists in the JAX package's format, so a
segment staged by the JAX package reads back here: ``port_loads`` maps
the JAX package's classes in a payload onto the port's classes of the
same module path (a window's ``WinResult``), importing nothing of it.
The JAX driver's flight-recorder spans are not ported.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..basic import WindFlowError

DEFAULT_TXN_DIR = "wf_txn_sinks"


class FencedWriteError(WindFlowError):
    """A stale (zombie) sink replica attempted a transactional write
    after a newer replica generation took over its log."""


def txn_dir_for(op_name: str, replica_idx: int,
                base: Optional[str] = None) -> str:
    """Staging root of one sink replica's transaction log:
    ``<base or wf_txn_sinks>/<sanitized op>_r<idx>`` (the JAX package's
    ``WF_TXN_DIR`` is the ``base`` argument here)."""
    root = base or DEFAULT_TXN_DIR
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in op_name)
    return os.path.join(root, f"{safe}_r{replica_idx}")


class _PortUnpickler(pickle.Unpickler):
    """Resolves ``windflow_tpu.<mod>`` classes as ``windflow_tpu_torch.<mod>``
    (the two packages share module paths and dataclass layouts)."""

    def find_class(self, module: str, name: str):
        if module == "windflow_tpu" or module.startswith("windflow_tpu."):
            module = "windflow_tpu_torch" + module[len("windflow_tpu"):]
        return super().find_class(module, name)


def port_loads(data: bytes) -> Any:
    """``pickle.loads`` that reads payloads written by either package."""
    return _PortUnpickler(io.BytesIO(data)).load()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


_SEG_RE = re.compile(r"^epoch_(\d{10})\.(pending|seg)$")


class EpochSegmentStore:
    """One sink replica's on-disk transaction log, one staged segment per
    epoch, crash-safe by tmp + atomic rename (as ``checkpoint/store.py``)::

        <root>/
          epoch_0000000003.pending   # pre-committed (durable, invisible)
          epoch_0000000002.seg       # committed (the sink's real output)

    ``precommit`` publishes the pending file atomically; ``commit`` is one
    ``os.replace`` of ``.pending`` to ``.seg``; both are idempotent, so a
    crash between the coordinator's finalize and the rename heals by
    roll-forward on restore. ``.tmp`` debris of a crash mid-precommit is
    reaped on recovery."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, epoch: int, pending: bool) -> str:
        return os.path.join(
            self.root, f"epoch_{epoch:010d}.{'pending' if pending else 'seg'}")

    # -- the 2PC verbs -----------------------------------------------------
    def precommit(self, epoch: int, payload: bytes) -> str:
        path = self._path(epoch, pending=True)
        _atomic_write(path, payload)
        return path

    def commit(self, epoch: int) -> bool:
        """``.pending`` -> ``.seg``; True when this call renamed (False:
        already committed, the idempotent replay case)."""
        final = self._path(epoch, pending=False)
        if os.path.exists(final):
            return False
        os.replace(self._path(epoch, pending=True), final)  # missing: raise
        return True

    def abort(self, epoch: int) -> bool:
        try:
            os.unlink(self._path(epoch, pending=True))
            return True
        except FileNotFoundError:
            return False

    # -- introspection and recovery ----------------------------------------
    def _scan(self) -> List[Tuple[int, str]]:
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        out = []
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), m.group(2)))
        return sorted(out)

    def pending_epochs(self) -> List[int]:
        return [e for e, kind in self._scan() if kind == "pending"]

    def committed_epochs(self) -> List[int]:
        return [e for e, kind in self._scan() if kind == "seg"]

    def is_committed(self, epoch: int) -> bool:
        return os.path.exists(self._path(epoch, pending=False))

    def read(self, epoch: int, pending: bool = False) -> bytes:
        with open(self._path(epoch, pending), "rb") as f:
            return f.read()

    def reap_tmp(self) -> int:
        """Delete torn ``.tmp`` files a crash mid-precommit left behind."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return 0
        n = 0
        for name in names:
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.root, name))
                    n += 1
                except OSError:
                    pass
        return n


def read_committed_records(root: str) -> List[Any]:
    """Every committed record of one replica's segment store, in epoch
    order: the canonical "what did this sink output" view."""
    store = EpochSegmentStore(root)
    out: List[Any] = []
    for epoch in store.committed_epochs():
        out.extend(port_loads(store.read(epoch)))
    return out


class EpochTxnDriver:
    """The two-phase-commit state machine of one sink replica.

    The family's mechanics live in a backend with the verbs
    ``do_precommit(epoch, records)``, ``do_commit(epoch) ->
    Optional[records]`` (records handed to ``deliver``, the functor
    callback), ``do_abort(epoch)`` and ``do_recover(last_epoch) ->
    (rolled_forward, aborted)``. The driver owns the epoch bookkeeping,
    the finalize watermark, the commit latency and the ``Sink_txn_*``
    stats; ``precommit_total_us`` / ``commit_total_us`` add up the time
    of the backend's pre-commits and commits.

    Threading: ``on_finalized`` runs on whichever thread finalized the
    epoch and only stores an int; every other method runs on the sink
    replica's thread, or on the main thread with the worker joined
    (``restore``, ``complete_all``)."""

    def __init__(self, backend: Any, stats: Any,
                 deliver: Optional[Callable[[Any], None]] = None) -> None:
        self.backend = backend
        self.stats = stats
        self.deliver = deliver
        self.buffer: List[Any] = []  # current-epoch records
        self._pending: Dict[int, float] = {}  # epoch -> precommit time
        self._commit_ready = 0  # finalize watermark (listener-written)
        self.last_epoch = 0
        # precommit -> commit visible, per epoch
        self.commit_latency_last_us = 0.0
        self.commit_latency_total_us = 0.0
        self.commits = 0
        self.precommit_total_us = 0.0
        self.commit_total_us = 0.0

    # -- wiring ------------------------------------------------------------
    def bind(self, coordinator: Any) -> None:
        self._commit_ready = coordinator.last_completed_id
        coordinator.add_finalize_listener(self.on_finalized)

    def on_finalized(self, ckpt_id: int) -> None:
        # another thread: publish the watermark only
        if ckpt_id > self._commit_ready:
            self._commit_ready = ckpt_id

    def _fenced(self) -> None:
        self.stats.txn_fenced_writes += 1

    def commit_due(self) -> bool:
        """A pre-committed epoch is finalized: one int compare per
        message on the sink's hot path."""
        return bool(self._pending) and min(self._pending) <= self._commit_ready

    # -- phase 1: pre-commit at the aligned barrier ------------------------
    def precommit_epoch(self, ckpt_id: int) -> None:
        """Everything staged since the previous barrier belongs to epoch
        ``ckpt_id``. Commits any older finalized epoch first (keeps the
        disk bounded), then prepares this one durably. An epoch ALREADY
        committed in the log (a restore from an older checkpoint replayed
        it) is discarded instead: the sink-side duplicate filter."""
        self.poll()
        records, self.buffer = self.buffer, []
        self.last_epoch = max(self.last_epoch, ckpt_id)
        already = getattr(self.backend, "is_committed", None)
        if already is not None and already(ckpt_id):
            self.stats.txn_aborts += 1
            return
        t0 = time.perf_counter()
        try:
            self.backend.do_precommit(ckpt_id, records)
        except FencedWriteError:
            self._fenced()
            raise
        now = time.perf_counter()
        self.precommit_total_us += (now - t0) * 1e6
        self._pending[ckpt_id] = now
        self.stats.txn_precommits += 1

    # -- phase 2: commit on the coordinator's finalize ---------------------
    def poll(self) -> bool:
        """Commit every pre-committed epoch at or below the finalize
        watermark, in epoch order. Runs on the sink's own thread: the
        message path, the worker's idle tick, the barrier hook."""
        ready = self._commit_ready
        did = False
        for epoch in sorted(e for e in self._pending if e <= ready):
            self._commit_one(epoch)
            did = True
        return did

    def _commit_one(self, epoch: int) -> None:
        t_pre = self._pending.pop(epoch)
        t0 = time.perf_counter()
        try:
            records = self.backend.do_commit(epoch)
        except FencedWriteError:
            self._pending[epoch] = t_pre  # still staged; not ours any more
            self._fenced()
            raise
        now = time.perf_counter()
        self.commit_total_us += (now - t0) * 1e6
        lat_us = (now - t_pre) * 1e6
        self.commit_latency_last_us = lat_us
        self.commit_latency_total_us += lat_us
        self.commits += 1
        self.stats.txn_commits += 1
        if records is not None and self.deliver is not None:
            self.deliver(records)

    # -- termination -------------------------------------------------------
    def seal_tail(self) -> None:
        """EOS: stage the records after the last barrier as one final
        epoch (``last_epoch + 1``); it commits in ``complete_all`` once
        the graph is known to have finished cleanly. A crash before that
        aborts it on restore: the replay produces the tail again."""
        self.poll()
        if not self.buffer and not hasattr(self.backend, "always_seal"):
            return
        self.precommit_epoch(self.last_epoch + 1)

    def complete_all(self) -> None:
        """Clean end of the run (``PipeGraph.wait_end``, every worker
        joined without error): nothing will replay, so every pending
        epoch, finalized or merely superseded, commits now in order."""
        for epoch in sorted(self._pending):
            self._commit_one(epoch)

    # -- checkpoint snapshot and restore -----------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"txn_last_epoch": self.last_epoch}

    def restore(self, state: Dict[str, Any]) -> None:
        """Recovery: pre-committed epochs ``<= txn_last_epoch`` (the
        restored checkpoint's id: their data precedes the replay point)
        roll forward; everything newer aborts (the replay produces it
        again)."""
        last = int(state.get("txn_last_epoch", 0))
        self.last_epoch = last
        self._commit_ready = max(self._commit_ready, last)
        rolled, aborted = self.backend.do_recover(last)
        for _epoch, records in rolled:
            self.commits += 1
            self.stats.txn_commits += 1
            if records is not None and self.deliver is not None:
                self.deliver(records)
        self.stats.txn_aborts += len(aborted)


class SegmentBackend:
    """File backend over :class:`EpochSegmentStore`, for the row and
    columnar sinks. Records are pickled per epoch; the committed ``.seg``
    files are the sink's durable, exactly-once output stream.

    Fencing: a ``fence`` file in the segment root holds the current
    replica generation. Constructing a backend (a restore, a rebuild of
    the runtime plane) bumps it atomically; a replica of an older
    generation fails its next precommit or commit."""

    def __init__(self, root: str) -> None:
        self.store = EpochSegmentStore(root)
        self._records: Dict[int, List[Any]] = {}  # uncommitted, in memory
        self._fence_path = os.path.join(root, "fence")
        self.fence = self._read_fence() + 1
        _atomic_write(self._fence_path, str(self.fence).encode())

    def _read_fence(self) -> int:
        try:
            with open(self._fence_path, "rb") as f:
                return int(f.read() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def check_fence(self) -> None:
        stored = self._read_fence()
        if stored != self.fence:
            raise FencedWriteError(
                f"segment store {self.store.root!r}: fence {self.fence} "
                f"is stale (current {stored}); a newer replica "
                "generation owns this transaction log")

    def is_committed(self, epoch: int) -> bool:
        return self.store.is_committed(epoch)

    def do_precommit(self, epoch: int, records: List[Any]) -> None:
        self.check_fence()
        self.store.precommit(epoch, pickle.dumps(
            records, protocol=pickle.HIGHEST_PROTOCOL))
        self._records[epoch] = records

    def do_commit(self, epoch: int) -> Optional[List[Any]]:
        self.check_fence()
        if not self.store.commit(epoch):
            self._records.pop(epoch, None)
            return None  # already committed: do not deliver again
        return self._records.pop(epoch, None)

    def do_abort(self, epoch: int) -> None:
        self._records.pop(epoch, None)
        self.store.abort(epoch)

    def do_recover(self, last_epoch: int
                   ) -> Tuple[List[Tuple[int, Any]], List[int]]:
        self.store.reap_tmp()
        rolled: List[Tuple[int, Any]] = []
        aborted: List[int] = []
        for epoch in self.store.pending_epochs():
            if epoch <= last_epoch:
                payload = self.store.read(epoch, pending=True)
                if self.store.commit(epoch):
                    rolled.append((epoch, port_loads(payload)))
            else:
                self.store.abort(epoch)
                aborted.append(epoch)
        return rolled, aborted
