"""CheckpointCoordinator: epoch generation, ack collection, atomic commit.

Copy of ``windflow_tpu/checkpoint/coordinator.py`` without the async
uploader and the rescale hold point. One coordinator per running
PipeGraph. Triggering is a single integer bump of ``requested_id``;
source replicas poll it on their own threads at tuple boundaries and
inject the ``Barrier`` themselves, so the coordinator never touches a
channel. Each worker acknowledges a checkpoint once, writing all of its
replicas' blobs synchronously; the checkpoint commits (manifest + atomic
rename, ``store.py``) when every worker of the graph has acked. Finalize
listeners run on the acking worker's thread and must be cheap.

A checkpoint that can never complete (a worker crashed before its
barrier) stays uncommitted: restore only ever sees fully-acked
checkpoints. With ``epoch_timeout_s`` > 0 such an epoch fails loudly,
naming the workers that never acked.
"""

from __future__ import annotations

import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from ..basic import WindFlowError
from .store import CheckpointStore


class CheckpointCoordinator:
    def __init__(self, store: CheckpointStore, graph_name: str = "pipegraph",
                 interval_s: Optional[float] = None,
                 epoch_timeout_s: float = 0.0) -> None:
        self.store = store
        self.graph_name = graph_name
        self.interval_s = interval_s
        # the epoch counter source replicas poll (reads are one attribute
        # load; writes hold the lock). _alloc_id hands out ids BEFORE they
        # publish, so two concurrent triggers never share an epoch
        self.requested_id = 0
        self._alloc_id = 0
        # workers expected to ack each checkpoint; set by PipeGraph once
        # the topology is built
        self.expected_acks = 0
        self._lock = threading.Lock()
        # serializes blob writes against the commit rename: an ack's
        # pending-check + write must be atomic w.r.t. _finalize renaming
        # the staging dir away. Ordering: _store_lock outside _lock.
        self._store_lock = threading.Lock()
        self._pending: Dict[int, Dict[str, Any]] = {}
        # workers that exited cleanly, with their final blobs: a finished
        # worker's state is frozen, so its final snapshot is valid for
        # every later epoch (Flink's finished-task semantics)
        self._retired: Dict[str, Dict[Any, Any]] = {}
        self._listeners: List[Callable[[int], None]] = []
        # notified with the epoch id when a pending epoch fails (timeout,
        # storage) or is dropped
        self._abort_listeners: List[Callable[[int], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.completed = 0
        self.last_completed_id = 0
        self.last_duration_s = 0.0
        self.last_bytes = 0
        self.total_bytes = 0
        # one entry per committed epoch: its id, trigger -> commit seconds,
        # the manifest + rename seconds and the bytes of its blobs
        self.history: List[Dict[str, Any]] = []
        # pending epochs older than this fail loudly instead of hanging
        # trigger_checkpoint(wait=True) forever (0 = no timeout, the JAX
        # package's default)
        self.epoch_timeout_s = float(epoch_timeout_s)
        self.failed_epochs = 0
        self.storage_failures = 0
        self.last_failure: Optional[str] = None
        self._failed: Dict[int, str] = {}  # cid -> failure message
        # wait_committed() sleeps here; notified on finalize and failure
        self._commit_cond = threading.Condition(self._lock)
        # worker roster, wired by PipeGraph: names make the timeout error
        # actionable
        self.worker_names: List[str] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self.interval_s is None or self.interval_s <= 0 \
                or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"{self.graph_name}/ckpt-coord",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=3)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_epoch_timeouts()
            self.trigger()

    # -- triggering --------------------------------------------------------
    def trigger(self, force: bool = False) -> Optional[int]:
        """Open a new checkpoint epoch and return its id. Without
        ``force``, declines while an earlier checkpoint is still in flight
        (aligned barriers serialize naturally; overlapping epochs would
        only race each other at the aligners)."""
        timeout = max(2.0 * (self.interval_s or 0.0), 10.0)
        with self._lock:
            if not force:
                now = time.monotonic()
                for ent in self._pending.values():
                    if now - ent["t0"] < timeout:
                        return None
            self._alloc_id = max(self._alloc_id, self.requested_id) + 1
            cid = self._alloc_id
            self._pending[cid] = {"acked": set(), "bytes": 0,
                                  "t0": time.monotonic()}
        # stage BEFORE publishing the epoch: sources poll requested_id and
        # may ack at once — clearing crashed-run debris after that would
        # race their blob writes
        with self._store_lock:
            self.store.begin(cid)
        with self._lock:
            if cid > self.requested_id:
                self.requested_id = cid
            retired = list(self._retired.items())
        for wname, blobs in retired:
            self.ack(cid, wname, blobs)
        return cid

    # -- acks --------------------------------------------------------------
    def ack(self, ckpt_id: int, worker_name: str,
            blobs: Dict[Any, Any]) -> int:
        """One worker's snapshot for one checkpoint: ``blobs`` maps
        ``(op_name, replica_idx)`` to the replica's state dict. Returns the
        bytes written (0 when the checkpoint is unknown or already
        committed)."""
        nbytes = 0
        with self._store_lock:
            with self._lock:
                if ckpt_id not in self._pending:
                    return 0
            try:
                for (op_name, idx), state in blobs.items():
                    nbytes += self.store.write_blob(ckpt_id, op_name, idx,
                                                    state)
            except OSError as e:
                # disk full / write failure while staging: the EPOCH fails
                # loudly, never the worker; its staging debris goes
                shutil.rmtree(self.store._dirname(ckpt_id, staging=True),
                              ignore_errors=True)
                with self._lock:
                    self._fail_epoch_storage_locked(ckpt_id, worker_name, e)
                self._notify_aborted(ckpt_id)
                return 0
        with self._lock:
            ent = self._pending.get(ckpt_id)
            if ent is None:
                return nbytes
            ent["acked"].add(worker_name)
            ent["bytes"] += nbytes
            done = (self.expected_acks > 0
                    and len(ent["acked"]) >= self.expected_acks)
        if done:
            self._finalize(ckpt_id)
        return nbytes

    def retire(self, worker_name: str, blobs: Dict[Any, Any]) -> None:
        """A worker finished cleanly: remember its final blobs and ack them
        into every epoch it had not answered yet (its barrier can no longer
        be in flight — it saw EOS on every channel)."""
        with self._lock:
            self._retired[worker_name] = blobs
            open_cids = [cid for cid, ent in self._pending.items()
                         if worker_name not in ent["acked"]]
        for cid in open_cids:
            self.ack(cid, worker_name, blobs)

    def _finalize(self, ckpt_id: int) -> None:
        with self._lock:
            ent = self._pending.pop(ckpt_id, None)
            if ent is None:
                return  # raced another finalize
            # an older still-open checkpoint can no longer matter: the
            # newer one supersedes it
            for old in [c for c in self._pending if c < ckpt_id]:
                self._pending.pop(old, None)
            listeners = list(self._listeners)
        duration = time.monotonic() - ent["t0"]
        t_commit = time.perf_counter()
        with self._store_lock:
            self.store.commit(ckpt_id, {
                "graph": self.graph_name,
                "created_unix": time.time(),
                "duration_sec": round(duration, 6),
                "n_workers": self.expected_acks,
                "bytes": ent["bytes"],
            })
        commit_s = time.perf_counter() - t_commit
        with self._lock:
            self.completed += 1
            self.last_completed_id = ckpt_id
            self.last_duration_s = duration
            self.last_bytes = ent["bytes"]
            self.total_bytes += ent["bytes"]
            self.history.append({"ckpt_id": ckpt_id,
                                 "duration_s": duration,
                                 "commit_s": commit_s,
                                 "bytes": ent["bytes"]})
            self._commit_cond.notify_all()
        for fn in listeners:
            try:
                fn(ckpt_id)
            except Exception:  # listener bugs must not kill the worker
                pass

    # -- epoch timeout and failures ----------------------------------------
    def _unacked_of(self, acked: Set[str]) -> List[str]:
        names = self.worker_names or []
        return [n for n in names if n not in acked] \
            or [f"<{self.expected_acks - len(acked)} unnamed worker(s)>"]

    def _fail_epoch_locked(self, cid: int, age_s: float) -> str:
        """Drop a pending epoch and compose the descriptive error (lock
        held). The staging dir stays on disk; ``store.prune`` cleans it
        once a newer checkpoint commits."""
        ent = self._pending.pop(cid, None)
        acked = ent["acked"] if ent else set()
        unacked = self._unacked_of(acked)
        msg = (f"checkpoint epoch {cid} timed out after {age_s:.1f}s: "
               f"{len(acked)}/{self.expected_acks} workers acked; never "
               f"acked: {', '.join(unacked)}")
        self._record_failure_locked(cid, msg)
        return msg

    def _fail_epoch_storage_locked(self, cid: int, worker_name: str,
                                   err: OSError) -> str:
        """Drop a pending epoch whose blob staging hit an OSError (lock
        held): the epoch never finalizes, restore only ever sees fully
        committed checkpoints."""
        self._pending.pop(cid, None)
        msg = (f"checkpoint epoch {cid} aborted: storage write failure "
               f"while worker {worker_name!r} staged its snapshot "
               f"({type(err).__name__}: {err}) — staging debris pruned, "
               "the next interval retries")
        self.storage_failures += 1
        self._record_failure_locked(cid, msg)
        return msg

    def _record_failure_locked(self, cid: int, msg: str) -> None:
        self._failed[cid] = msg
        for old in [c for c in self._failed if c < cid - 16]:
            self._failed.pop(old, None)
        self.failed_epochs += 1
        self.last_failure = msg
        self._commit_cond.notify_all()

    def check_epoch_timeouts(self) -> None:
        """Fail pending epochs older than ``epoch_timeout_s`` (a no-op when
        it is 0). Called by the interval thread each tick and by
        ``wait_committed``."""
        t = self.epoch_timeout_s
        if t <= 0:
            return
        with self._lock:
            now = time.monotonic()
            stale = [(cid, now - ent["t0"])
                     for cid, ent in self._pending.items()
                     if now - ent["t0"] >= t]
            for cid, age in stale:
                self._fail_epoch_locked(cid, age)
        for cid, _ in stale:
            self._notify_aborted(cid)

    def wait_committed(self, cid: int, timeout_s: Optional[float] = None
                       ) -> None:
        """Block until epoch ``cid`` commits. Raises ``WindFlowError`` when
        the epoch fails (``epoch_timeout_s`` elapsed, or ``timeout_s`` as
        an explicit override), naming the workers that never acked."""
        t = timeout_s if timeout_s is not None else self.epoch_timeout_s
        deadline = time.monotonic() + t if t and t > 0 else None
        while True:
            timed_out_msg = None
            with self._lock:
                if self.last_completed_id >= cid:
                    return
                if cid in self._failed:
                    raise WindFlowError(self._failed[cid])
                if cid not in self._pending:
                    raise WindFlowError(
                        f"checkpoint epoch {cid} was dropped without "
                        "committing (superseded by a newer checkpoint)")
                if deadline is not None and time.monotonic() >= deadline:
                    timed_out_msg = self._fail_epoch_locked(cid, t)
                else:
                    self._commit_cond.wait(0.05)
            if timed_out_msg is not None:
                self._notify_aborted(cid)
                raise WindFlowError(timed_out_msg)

    # -- rescale hold point: part of elastic rescaling, not ported ---------
    def park_if_held(self, ckpt_id: int, worker_name: str):
        raise WindFlowError("the rescale hold point is not yet ported to "
                            "windflow_tpu_torch")

    def wait_all_parked(self, cid: int, timeout_s: float) -> bool:
        raise WindFlowError("the rescale hold point is not yet ported to "
                            "windflow_tpu_torch")

    def release_hold(self, directive: str = "resume") -> None:
        raise WindFlowError("the rescale hold point is not yet ported to "
                            "windflow_tpu_torch")

    def abort_pending(self) -> None:
        """Drop every still-pending epoch (epochs opened against a runtime
        plane whose workers are gone can never complete)."""
        with self._lock:
            dropped = list(self._pending)
            self._pending.clear()
            self._retired.clear()
            self._commit_cond.notify_all()
        for cid in dropped:
            self._notify_aborted(cid)

    def _notify_aborted(self, cid: int) -> None:
        for fn in list(self._abort_listeners):
            try:
                fn(cid)
            except Exception:
                pass  # listener bugs must not kill the coordinator

    # -- listeners ---------------------------------------------------------
    def add_finalize_listener(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def add_abort_listener(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            self._abort_listeners.append(fn)

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "Checkpoints_completed": self.completed,
                "Checkpoints_requested": self.requested_id,
                "Checkpoint_last_id": self.last_completed_id,
                "Checkpoint_last_duration_sec": round(self.last_duration_s,
                                                      6),
                "Checkpoint_last_bytes": self.last_bytes,
                "Checkpoint_bytes_total": self.total_bytes,
                "Checkpoint_store_dir": self.store.root,
                "Checkpoint_failed_epochs": self.failed_epochs,
                "Checkpoint_failures": self.failed_epochs,
                "Checkpoint_storage_failures": self.storage_failures,
                "Checkpoint_verify_failures": self.store.verify_failures,
                "Checkpoint_last_failure": self.last_failure,
            }
