"""CheckpointCoordinator: epoch generation, ack collection, atomic commit.

Copy of ``windflow_tpu/checkpoint/coordinator.py``. One coordinator per
running PipeGraph. Triggering is a single
integer bump of ``requested_id``; source replicas poll it on their own
threads at tuple boundaries and inject the ``Barrier`` themselves, so the
coordinator never touches a channel. Each worker acknowledges a
checkpoint once with all of its replicas' blobs; the checkpoint commits
(manifest + atomic rename, ``store.py``) when every worker of the graph
has acked and every blob is written. Finalize listeners run on the
thread that completes the epoch and must be cheap.

Synchronous acks (the default) write the blobs on the worker's thread.
With ``async_upload`` (the graph's ``with_checkpointing(async_upload=
True)``, the JAX package's ``WF_CKPT_ASYNC``) an ack only queues the
captured blobs for one background uploader thread and returns: the
barrier then fences only the state CUT, and pickling, hashing and the
fsync'd writes run off the worker. The captured blobs must own their data
by then (every snapshot copies device and host state). A failed upload
fails its epoch like a failed synchronous write, and is also kept in
``upload_error``, which the graph raises when the run ends: the worker
that took the snapshot has long moved on, so the run itself reports it.

A checkpoint that can never complete (a worker crashed before its
barrier) stays uncommitted: restore only ever sees fully-acked
checkpoints. With ``epoch_timeout_s`` > 0 such an epoch fails loudly,
naming the workers that never acked.

The rescale hold point: an epoch triggered with ``hold=True`` parks every
worker right after its ack (``park_if_held``), so the whole graph
quiesces exactly at the aligned barrier; the rescale controller waits for
that (``wait_all_parked``), then releases them with a directive
(``release_hold``): ``"resume"`` (the rescale was aborted) or
``"abandon"`` (unwind; the runtime plane is rebuilt).
"""

from __future__ import annotations

import queue
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from ..basic import WindFlowError
from .delta import DEFAULT_FULL_EVERY
from .store import CheckpointStore

# seconds ``stop`` waits for the uploader to write what is queued
UPLOAD_DRAIN_S = 120.0


class CheckpointCoordinator:
    def __init__(self, store: CheckpointStore, graph_name: str = "pipegraph",
                 interval_s: Optional[float] = None,
                 epoch_timeout_s: float = 0.0, async_upload: bool = False,
                 full_every: int = DEFAULT_FULL_EVERY) -> None:
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
        # the newest epoch committed to the store (written under
        # _store_lock): an older epoch finalizing after it is superseded
        self._stored_id = 0
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
        # incremental captures: at least one FULL snapshot every
        # ``full_every`` captures of an engine (the store's ``delta`` says
        # whether deltas are on)
        self.full_every = max(1, int(full_every))
        # the async uploader: acks queue (epoch, worker, blobs, entry); an
        # epoch finalizes once every worker acked AND every upload landed
        # (ent["uploads"] == 0)
        self.async_enabled = bool(async_upload)
        self._upload_q: Optional[queue.Queue] = None
        self._upload_thread: Optional[threading.Thread] = None
        self.async_uploads = 0  # uploads completed (any outcome)
        self.async_pending = 0  # uploads in flight
        self.upload_usec_total = 0.0
        self.upload_error: Optional[BaseException] = None
        # the rescale hold point (see the module docstring); who acked each
        # committed epoch, so that parked + retired can be checked to
        # cover them before a teardown
        self._hold_epoch: Optional[int] = None
        self._hold_evt = threading.Event()
        self._hold_directive = "resume"
        self.parked: Set[str] = set()
        self._commit_acked: Dict[int, Set[str]] = {}
        # epochs whose last ack landed and whose store commit (manifest,
        # fsync, rename) is running: no longer pending, not yet committed
        self._committing: Set[int] = set()

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
        """Stop the interval timer, and let the uploader write what is
        queued before it exits. An uploader still busy after
        ``UPLOAD_DRAIN_S`` is recorded in ``upload_error``."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=3)
            self._thread = None
        with self._lock:
            q, ut = self._upload_q, self._upload_thread
            self._upload_q = self._upload_thread = None
        if ut is not None:
            q.put(None)  # sentinel: drain the queued uploads, then exit
            ut.join(timeout=UPLOAD_DRAIN_S)
            if ut.is_alive() and self.upload_error is None:
                self.upload_error = WindFlowError(
                    f"checkpoint uploader of {self.graph_name!r} still "
                    f"busy {UPLOAD_DRAIN_S:.0f}s after the run ended")

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_epoch_timeouts()
            self.trigger()

    # -- triggering --------------------------------------------------------
    def trigger(self, force: bool = False, hold: bool = False
                ) -> Optional[int]:
        """Open a new checkpoint epoch and return its id. Without
        ``force``, declines while an earlier checkpoint is still in flight
        (aligned barriers serialize naturally; overlapping epochs would
        only race each other at the aligners). ``hold=True`` makes the
        epoch a rescale quiesce point: every worker parks in
        ``park_if_held`` right after acking it."""
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
            if hold:
                # armed BEFORE the epoch publishes: a source may poll the
                # new requested_id and park before trigger() returns
                self._hold_epoch = cid
                self._hold_directive = "resume"
                self._hold_evt.clear()
                self.parked = set()
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

    def rewind_to(self, cid: int) -> None:
        """Epoch ids continue after ``cid``, the checkpoint a restore
        installs (0: none, a full replay); ids the abandoned run used past
        it are handed out again."""
        with self._lock:
            self._alloc_id = cid
            self.requested_id = cid
            self.last_completed_id = cid
            self._stored_id = cid

    # -- acks --------------------------------------------------------------
    def ack(self, ckpt_id: int, worker_name: str,
            blobs: Dict[Any, Any]) -> int:
        """One worker's snapshot for one checkpoint: ``blobs`` maps
        ``(op_name, replica_idx)`` to the replica's state dict. Returns the
        bytes written (0 when the checkpoint is unknown or already
        committed; also 0 with ``async_upload``, where the bytes count when
        the upload lands)."""
        if self.async_enabled:
            return self._ack_async(ckpt_id, worker_name, blobs)
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
                    and len(ent["acked"]) >= self.expected_acks
                    and ent.get("uploads", 0) == 0)
        if done:
            self._finalize(ckpt_id)
        return nbytes

    # -- the async uploader ------------------------------------------------
    def _ack_async(self, ckpt_id: int, worker_name: str,
                   blobs: Dict[Any, Any]) -> int:
        """Queue the captured blobs as one pending upload and return: the
        barrier fenced only the state cut. The epoch cannot finalize until
        this upload lands."""
        with self._lock:
            ent = self._pending.get(ckpt_id)
            if ent is None:
                return 0
            ent["acked"].add(worker_name)
            ent["uploads"] = ent.get("uploads", 0) + 1
            self.async_pending += 1
            if self._upload_thread is None:
                self._upload_q = queue.Queue()
                self._upload_thread = threading.Thread(
                    target=self._upload_loop, args=(self._upload_q,),
                    name=f"{self.graph_name}/ckpt-upload", daemon=True)
                self._upload_thread.start()
            # the entry rides along as an incarnation token: a re-begun
            # epoch of the same id gets a fresh entry, and a stale upload
            # must neither write into it nor fail it
            from ..monitoring.flightrec import thread_recorder
            self._upload_q.put((ckpt_id, worker_name, blobs, ent,
                                thread_recorder()))
        return 0

    def _upload_loop(self, q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            self._upload_one(*item)

    def _upload_one(self, ckpt_id: int, worker_name: str,
                    blobs: Dict[Any, Any], ent: dict, rec: Any = None
                    ) -> None:
        t0 = time.perf_counter()
        nbytes = 0
        failed: Optional[BaseException] = None
        try:
            with self._store_lock:
                with self._lock:
                    alive = self._pending.get(ckpt_id) is ent
                if alive:
                    for (op_name, idx), state in blobs.items():
                        nbytes += self.store.write_blob(
                            ckpt_id, op_name, idx, state)
        except Exception as e:  # the uploader must outlive one bad upload
            failed = e
        dur_s = time.perf_counter() - t0
        done = False
        with self._lock:
            self.async_pending -= 1
            self.async_uploads += 1
            self.upload_usec_total += dur_s * 1e6
            stale = self._pending.get(ckpt_id) is not ent
            if failed is not None:
                if self.upload_error is None:
                    self.upload_error = failed
                if not stale:
                    self._fail_epoch_storage_locked(ckpt_id, worker_name,
                                                    failed)
            elif not stale:
                ent["uploads"] -= 1
                ent["bytes"] += nbytes
                ent["upload_s"] = ent.get("upload_s", 0.0) + dur_s
                done = (self.expected_acks > 0
                        and len(ent["acked"]) >= self.expected_acks
                        and ent["uploads"] == 0)
        if failed is not None:
            if not stale:  # a re-begun epoch keeps its staging
                shutil.rmtree(self.store._dirname(ckpt_id, staging=True),
                              ignore_errors=True)
                self._notify_aborted(ckpt_id)
            return
        if rec is not None:
            # the acking worker's ring, written cross-thread: one racy
            # slot write, tolerated as the stall watchdog's is
            from ..monitoring.flightrec import rec_evt_safe
            rec_evt_safe(rec, "ckpt:upload", dur_s * 1e6,
                         {"ckpt_id": ckpt_id, "worker": worker_name,
                          "bytes": nbytes})
        if done:
            self._finalize(ckpt_id)

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
            self._committing.add(ckpt_id)
        duration = time.monotonic() - ent["t0"]
        t_commit = time.perf_counter()
        try:
            with self._store_lock:
                if ckpt_id < self._stored_id:
                    # a NEWER epoch's finalize took the store first: its
                    # commit pruned this epoch's staging, and it covers
                    # everything this one would (overlapping forced epochs
                    # finalizing out of order)
                    superseded = True
                else:
                    superseded = False
                    self.store.commit(ckpt_id, {
                        "graph": self.graph_name,
                        "created_unix": time.time(),
                        "duration_sec": round(duration, 6),
                        "n_workers": self.expected_acks,
                        "bytes": ent["bytes"],
                    })
                    self._stored_id = ckpt_id
        except BaseException:
            with self._lock:
                self._committing.discard(ckpt_id)
                self._commit_cond.notify_all()
            raise
        commit_s = time.perf_counter() - t_commit
        if superseded:
            with self._lock:
                self._committing.discard(ckpt_id)
                self._commit_cond.notify_all()
            return
        with self._lock:
            self._committing.discard(ckpt_id)
            self.completed += 1
            self.last_completed_id = ckpt_id
            self.last_duration_s = duration
            self.last_bytes = ent["bytes"]
            self.total_bytes += ent["bytes"]
            self.history.append({"ckpt_id": ckpt_id,
                                 "duration_s": duration,
                                 "commit_s": commit_s,
                                 "upload_s": ent.get("upload_s", 0.0),
                                 "bytes": ent["bytes"]})
            self._commit_acked[ckpt_id] = set(ent["acked"])
            for old in [c for c in self._commit_acked if c < ckpt_id]:
                self._commit_acked.pop(old, None)
            self._commit_cond.notify_all()
        # _finalize runs on the LAST acking worker's thread: its ring gets
        # the commit marker, closing barrier_open -> snapshot -> commit
        from ..monitoring.flightrec import thread_recorder
        rec = thread_recorder()
        if rec is not None:
            rec.event("ckpt_commit", duration * 1e6,
                      {"ckpt_id": ckpt_id, "bytes": ent["bytes"]})
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
                                   err: BaseException) -> str:
        """Drop a pending epoch whose blob staging failed (lock held): the
        epoch never finalizes, restore only ever sees fully committed
        checkpoints."""
        self._pending.pop(cid, None)
        what = ("storage write failure" if isinstance(err, OSError)
                else "snapshot write failure")
        msg = (f"checkpoint epoch {cid} aborted: {what} while worker "
               f"{worker_name!r} staged its snapshot "
               f"({type(err).__name__}: {err}) — staging debris pruned, "
               "the next interval retries")
        if isinstance(err, OSError):
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
                if cid not in self._pending and cid not in self._committing:
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

    # -- the rescale hold point ---------------------------------------------
    def park_if_held(self, ckpt_id: int, worker_name: str) -> Optional[str]:
        """Called by every worker right after acking ``ckpt_id``. For a
        held epoch the worker blocks here until the controller releases it
        and gets the directive (``"resume"`` / ``"abandon"``); None when
        the epoch is not held."""
        with self._lock:
            if self._hold_epoch != ckpt_id:
                return None
            self.parked.add(worker_name)
            self._commit_cond.notify_all()
            evt = self._hold_evt
        evt.wait()
        with self._lock:
            return self._hold_directive

    def wait_all_parked(self, cid: int, timeout_s: float) -> bool:
        """True once every worker that acked the committed held epoch
        ``cid`` live (not by retirement) is parked: the moment a teardown
        is safe. False after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                acked = self._commit_acked.get(cid)
                if acked is not None \
                        and acked <= (self.parked | set(self._retired)):
                    return True
                if time.monotonic() >= deadline:
                    return False
                self._commit_cond.wait(0.05)

    def release_hold(self, directive: str = "resume") -> None:
        """Release every parked worker with ``directive``: ``"resume"``
        goes on as after a normal checkpoint, ``"abandon"`` unwinds the
        worker silently (the runtime plane is being rebuilt)."""
        with self._lock:
            self._hold_directive = directive
            self._hold_epoch = None
            evt = self._hold_evt
        evt.set()

    def abort_pending(self) -> None:
        """Drop every still-pending epoch, and the retired workers' final
        blobs: epochs opened against a runtime plane whose workers are
        gone can never complete (a rescale's or a supervisor's teardown)."""
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
                "Checkpoint_delta_blobs": self.store.delta_blobs,
                "Checkpoint_delta_bytes": self.store.delta_bytes,
                "Checkpoint_full_bytes": self.store.full_bytes,
                "Checkpoint_async_pending": self.async_pending,
                "Checkpoint_async_uploads": self.async_uploads,
                "Checkpoint_upload_usec_total": round(
                    self.upload_usec_total, 1),
            }
