"""Supervisor: graph-level auto-recovery from worker deaths and stalls.

The port of ``windflow_tpu/supervision/supervisor.py``. Without it, ``wait_end`` re-raises the first
worker error and recovery is a person calling ``run(restore_from=...)``.
The supervisor closes that loop:

1. **detect**: a dying worker's error path wakes the supervisor
   (``Worker.on_failure``); a polling tick backs it up, and reads the
   workers the graph's stall watchdog flagged (``PipeGraph(stall_sec=
   ...)``, ``monitoring/flightrec.py:StallWatchdog``) when the policy's
   ``restart_on_stall`` is on;
2. **back off**: a jittered exponential delay under the
   ``RestartPolicy`` budget; an exhausted budget ESCALATES: the
   supervisor stands down and ``wait_end`` raises the aggregated
   ``SupervisionEscalated``. So does a sticky CUDA error
   (``errors.is_sticky_device_error``): the device context is poisoned,
   and a restart in this process would only fail again;
3. **tear down**: abort pending checkpoint epochs, close every channel so
   blocked producers and consumers unwind with ``SupervisorTeardown`` (no
   EOS cascade: sinks must not see an end of stream mid-recovery), join
   the old workers (a wedged thread is abandoned: Python threads cannot
   be killed, and its next channel touch raises the teardown signal). On
   a card the teardown then waits for the device to finish the old
   plane's queued work. The old plane's commits, D2H fetches and pinned
   staging buffers die with its replicas and emitters: each staging
   emitter owns its pool, so no buffer of the old plane is handed to the
   new one, and the old emitters' ports lead to closed channels, so no
   batch of the old plane reaches the new one;
4. **restore**: rebuild the runtime plane (``PipeGraph._rebuild_runtime``,
   the rescale path) and install a committed checkpoint, walking a
   FALLBACK LADDER from the newest: a checkpoint that fails verification
   (``CorruptCheckpointError``) or raises mid-apply is quarantined
   (``ckpt_N`` -> ``ckpt_N.corrupt``) and the next older one is tried,
   down to a full replay from the sources' captured initial positions
   (which also aborts every exactly-once sink's pre-committed epochs: the
   replay from zero produces them again). The rebuilt sink replicas bump
   their transaction log's fence, so a torn-down replica's late write
   raises ``FencedWriteError``;
5. **resume**: fresh workers start; cumulative crash and dead-letter
   counters carry over. The detect -> resume time is the event's MTTR
   (``Supervision_last_restart_s``).

Device loss (``health.py``): before every rebuild a wired
``DeviceHealthProbe`` is read and its dead devices are published into the
mesh exclusion registry (``mesh/core.py:set_excluded_devices``), so the
rebuilt mesh operators come up on the surviving devices and their
sharded state relayouts onto the smaller mesh. While degraded the
supervisor polls the probe at its ``interval_s``; when an excluded device
reports healthy again it makes ONE planned restart (no backoff, no
restart budget spent; ``planned: true`` in the history) that re-expands
the meshes.

Every step leaves a ``supervise:*`` span on the supervisor's own flight
ring (``flightrec.ControlRing``) when the graph records.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..basic import WindFlowError
from .errors import is_sticky_device_error
from .policy import RestartPolicy


class SupervisionEscalated(WindFlowError):
    """The restart budget is exhausted (or recovery itself failed): the
    aggregated error of every dead worker, raised by ``wait_end``.
    ``worker_errors`` maps worker name -> exception."""

    def __init__(self, msg: str,
                 worker_errors: Optional[Dict[str, BaseException]] = None
                 ) -> None:
        super().__init__(msg)
        self.worker_errors = dict(worker_errors or {})


class Supervisor(threading.Thread):
    """One per supervised PipeGraph; started by ``PipeGraph.start`` and
    stopped by ``wait_end``. All recovery work runs on this thread."""

    _TICK_S = 0.05

    def __init__(self, graph, policy: Optional[RestartPolicy] = None) -> None:
        super().__init__(name=f"{graph.name}/supervisor", daemon=True)
        self.graph = graph
        self.policy = policy or RestartPolicy()
        self.active = True  # False once escalated or stopped
        self.escalated: Optional[SupervisionEscalated] = None
        self.restarts = 0
        self.last_restart_s = 0.0  # detect -> resume (MTTR) of the last
        self.restart_total_s = 0.0
        self.last_cause = ""
        self.abandoned: List[str] = []  # wedged worker threads left behind
        self.history: List[Dict[str, Any]] = []  # bounded, newest last
        self.last_ladder_depth = 0   # rungs skipped by the last restore
        self.verify_failures = 0     # cumulative corrupt rungs walked past
        self.degraded_devices = 0    # devices currently excluded
        self.planned_restarts = 0    # re-expansion restarts (not failures)
        self._excluded: frozenset = frozenset()
        self._next_probe_t = 0.0
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._stall_seen = 0  # consumed prefix of the watchdog's fired
        from ..monitoring.flightrec import ControlRing
        self._ring = ControlRing(graph, "supervise", "supervisor")
        self._span = self._ring.span

    # -- wiring ------------------------------------------------------------
    def note_failure(self, worker) -> None:
        """Worker error-path hook (any thread): wake the loop now."""
        self._wake.set()

    def stop(self) -> None:
        self.active = False
        self._stop_evt.set()
        self._wake.set()

    # -- the loop ----------------------------------------------------------
    def run(self) -> None:
        while not self._stop_evt.is_set():
            self._wake.wait(self._TICK_S)
            self._wake.clear()
            if self._stop_evt.is_set() or self.graph._ended:
                return
            failed = [w for w in self.graph._workers
                      if w.error is not None]
            stalled = self._new_stalls()
            if failed or stalled:
                try:
                    self._recover(failed, stalled)
                except Exception as e:  # recovery itself failed
                    self._escalate(failed, stalled,
                                   reason=f"recovery failed: "
                                          f"{type(e).__name__}: {e}",
                                   cause=e)
                if not self.active:
                    return
            elif self.active:
                try:
                    self._maybe_reexpand()
                except Exception as e:
                    self._escalate([], [],
                                   reason=f"mesh re-expansion failed: "
                                          f"{type(e).__name__}: {e}",
                                   cause=e)
                    return

    def _new_stalls(self) -> List[str]:
        """Workers the graph's stall watchdog flagged since the last tick.
        Only stalls of CURRENT workers count (an abandoned zombie flagged
        again must not restart the healthy new plane)."""
        if not self.policy.restart_on_stall:
            return []
        wd = getattr(self.graph, "_watchdog", None)
        if wd is None:
            return []
        fired = list(wd.fired)
        fresh = fired[self._stall_seen:]
        self._stall_seen = len(fired)
        live = {w.name for w in self.graph._workers}
        return [n for n in fresh if n in live]

    # -- recovery ----------------------------------------------------------
    def _errors_of(self, failed) -> Dict[str, BaseException]:
        return {w.name: w.error for w in failed if w.error is not None}

    def _escalate(self, failed, stalled, reason: str,
                  cause: Optional[BaseException] = None) -> None:
        errors = self._errors_of(failed)
        parts = [f"{n} ({type(e).__name__}: {e})" for n, e in errors.items()]
        parts += [f"{n} (stalled)" for n in stalled if n not in errors]
        exc = SupervisionEscalated(
            f"supervision gave up after {self.restarts} restart(s): "
            f"{reason}; dead worker(s): {', '.join(parts) or '<none>'}",
            errors)
        if cause is not None:
            exc.__cause__ = cause
        elif errors:
            exc.__cause__ = next(iter(errors.values()))
        self.escalated = exc
        self.active = False
        self._span("supervise:escalate", 0.0, reason)
        # unwind what is left so wait_end's joins return
        self._teardown(join_timeout=5.0, sync=False)
        self.graph._supervising = False

    def _recover(self, failed, stalled: List[str]) -> None:
        g = self.graph
        t_detect = time.monotonic()
        g._supervising = True  # wait_end spins while this is set
        errors = self._errors_of(failed)
        self.last_cause = "; ".join(
            [f"{n}: {type(e).__name__}: {e}" for n, e in errors.items()]
            + [f"{n}: stalled" for n in stalled])
        self._span("supervise:failure", 0.0, self.last_cause)
        if any(is_sticky_device_error(e) for e in errors.values()):
            self._escalate(
                failed, stalled,
                reason="a sticky CUDA error poisoned the device context; "
                       "a restart in this process would fail the same way")
            return
        if not self.policy.allow_restart():
            self._escalate(
                failed, stalled,
                reason=f"restart budget exhausted "
                       f"({self.policy.max_restarts} per "
                       f"{self.policy.window_s:.0f}s window)")
            return
        delay = self.policy.next_backoff()
        self.policy.note_restart()
        self._span("supervise:backoff", delay * 1e6,
                   {"attempt": self.restarts + 1})
        if self._stop_evt.wait(delay):
            g._supervising = False
            return
        t0 = time.monotonic()
        self._teardown()
        self._span("supervise:teardown", (time.monotonic() - t0) * 1e6)
        t0 = time.monotonic()
        cid = self._rebuild_and_restore()
        self._span("supervise:restore", (time.monotonic() - t0) * 1e6,
                   {"ckpt_id": cid})
        for w in g._workers:
            w.start()
        mttr = time.monotonic() - t_detect
        self.restarts += 1
        self.last_restart_s = mttr
        self.restart_total_s += mttr
        self.history.append({
            "t_unix": time.time(), "cause": self.last_cause,
            "ckpt_id": cid, "mttr_s": round(mttr, 6),
            "backoff_s": round(delay, 6), "abandoned": list(stalled)})
        del self.history[:-64]
        g._supervising = False
        self._span("supervise:resume", mttr * 1e6,
                   {"restart": self.restarts, "ckpt_id": cid})

    def _teardown(self, join_timeout: float = 10.0,
                  sync: bool = True) -> None:
        """Unwind the old runtime plane without an EOS cascade."""
        g = self.graph
        coord = g._coordinator
        if coord is not None:
            # epochs opened against the dying plane can never complete
            coord.abort_pending()
        for s in g._stages:
            for ch in s.channels:
                ch.close()
        old = list(g._workers)
        for w in old:
            if w is not threading.current_thread():
                w.join(timeout=join_timeout)
        wedged = [w.name for w in old if w.is_alive()]
        if wedged:
            # a Python thread cannot be killed: abandon it; its next
            # channel touch raises SupervisorTeardown
            self.abandoned.extend(wedged)
            self._span("supervise:abandon", 0.0, wedged)
        if sync:
            # the old plane's queued device work ends before the new
            # plane starts (raises on a poisoned context)
            g._sync_device()

    # -- device-loss failover (health.py) ------------------------------------
    def _apply_device_exclusions(self) -> None:
        """Read the graph's device-health probe (when wired) and publish
        its dead devices into the mesh exclusion registry, so the rebuild
        lands mesh state on surviving devices only. Runs BEFORE the
        rebuild. A probe exception keeps the previous exclusion set: no
        new information must never block a recovery."""
        probe = getattr(self.graph, "_device_probe", None)
        if probe is None:
            return
        try:
            dead = frozenset(int(d) for d in probe.dead_devices())
        except Exception:
            dead = self._excluded
        if dead != self._excluded:
            from ..mesh.core import set_excluded_devices
            set_excluded_devices(dead)
            self._excluded = dead
        self.degraded_devices = len(dead)

    def _maybe_reexpand(self) -> None:
        """While degraded, poll the probe at its own pace; when an excluded
        device reports healthy again, make ONE planned restart so the
        meshes re-expand (the rebuild reads the shrunken exclusion set
        and the relayout restore does the rest)."""
        g = self.graph
        probe = getattr(g, "_device_probe", None)
        if probe is None or not self._excluded or g._ended:
            return
        if all(not w.is_alive() for w in g._workers):
            return  # the stream is finishing; nothing to re-expand for
        now = time.monotonic()
        if now < self._next_probe_t:
            return
        self._next_probe_t = now + max(
            0.01, float(getattr(probe, "interval_s", 1.0) or 1.0))
        try:
            dead = frozenset(int(d) for d in probe.dead_devices())
        except Exception:
            return
        recovered = sorted(self._excluded - dead)
        if not recovered:
            return
        self._planned_restart(
            f"mesh re-expansion: device(s) {recovered} recovered")

    def _planned_restart(self, cause: str) -> None:
        """A deliberate restart (re-expansion): the teardown / rebuild /
        restore of ``_recover`` without backoff and without spending the
        restart budget (recovering capacity must never eat it)."""
        g = self.graph
        t0 = time.monotonic()
        g._supervising = True
        try:
            self.last_cause = cause
            self._span("supervise:planned", 0.0, cause)
            self._teardown()
            cid = self._rebuild_and_restore()
            for w in g._workers:
                w.start()
            mttr = time.monotonic() - t0
            self.planned_restarts += 1
            self.last_restart_s = mttr
            self.restart_total_s += mttr
            self.history.append({
                "t_unix": time.time(), "cause": cause, "ckpt_id": cid,
                "mttr_s": round(mttr, 6), "planned": True})
            del self.history[:-64]
        finally:
            g._supervising = False

    def _rebuild_and_restore(self) -> Optional[int]:
        """Rebuild the runtime plane and install a committed checkpoint,
        walking the fallback ladder newest -> oldest. Returns the restored
        checkpoint id (None for the full-replay rung)."""
        g = self.graph
        carry = self._collect_carryover()
        # device health first: the rebuilt meshes must avoid dead devices
        self._apply_device_exclusions()
        g._rebuild_runtime()
        cid = None
        if g._coordinator is not None:
            cid = self._restore_ladder(g._coordinator)
        self._apply_carryover(carry)
        return cid

    def _restore_ladder(self, coord) -> Optional[int]:
        """Walk committed checkpoints newest -> oldest until one both
        verifies and applies. A failing rung is quarantined and the
        partly applied plane is rebuilt clean before the next rung. With
        no usable checkpoint, replayable sources restart from their
        captured initial positions (a full replay)."""
        g = self.graph
        store = coord.store
        depth = 0
        for cid in reversed(store.completed_ids()):
            try:
                ckpt_dir = store._dirname(cid)
                states = store.load_states(ckpt_dir,
                                           store.load_manifest(ckpt_dir))
                # epoch ids roll back to the restored rung BEFORE the
                # rebuild, as with restore_from=: re-created sources anchor
                # their injection cursor here
                coord.rewind_to(cid)
                g._rebuild_runtime()
                g._restore_states(states)
            except Exception:
                # a CorruptCheckpointError from verification, or any
                # mid-apply failure: this rung is unusable, and the next
                # rung's rebuild discards the dirty plane
                depth += 1
                self.verify_failures += 1
                store.quarantine(cid)
                continue
            self.last_ladder_depth = depth
            return cid
        # no usable checkpoint: resuming from the sources' in-memory
        # cursors would drop every record that sat in the discarded
        # channels, so replayable sources restart from their initial
        # positions instead
        coord.rewind_to(0)
        g._rebuild_runtime()
        self._reset_sources_to_initial()
        self.last_ladder_depth = depth
        return None

    def _reset_sources_to_initial(self) -> None:
        initial = getattr(self.graph, "_initial_positions", None) or {}
        for op in self.graph._ops:
            for r in op.replicas:
                pos = initial.get((op.name, r.idx))
                if pos is not None:
                    r._restore_position = pos
                    r.stats.inputs_received = 0  # the stream restarts
                # exactly-once sinks: the dead generation may have left
                # pre-committed epochs that no checkpoint finalized. The
                # stream restarts from ZERO, so the replay produces their
                # records again: they abort now, or a later restore would
                # roll them forward and duplicate them
                drv = getattr(r, "_txn", None)
                if drv is not None:
                    drv.restore({"txn_last_epoch": 0})

    # -- cumulative counters carried across a rebuild -----------------------
    _CARRY_FIELDS = ("worker_crashes", "dlq_records", "dlq_skipped",
                     "dlq_retries")

    def _collect_carryover(self) -> Dict[Any, Dict[str, Any]]:
        out: Dict[Any, Dict[str, Any]] = {}
        for op in self.graph._ops:
            for r in {id(r): r for r in op.replicas}.values():
                ent = {f: getattr(r.stats, f, 0)
                       for f in self._CARRY_FIELDS}
                ent["worker_last_error"] = r.stats.worker_last_error
                out[(r.stats.op_name, r.idx)] = ent
        return out

    def _apply_carryover(self, carry: Dict[Any, Dict[str, Any]]) -> None:
        for op in self.graph._ops:
            for r in {id(r): r for r in op.replicas}.values():
                ent = carry.get((r.stats.op_name, r.idx))
                if not ent:
                    continue
                for f in self._CARRY_FIELDS:
                    setattr(r.stats, f,
                            getattr(r.stats, f, 0) + ent.get(f, 0))
                if ent.get("worker_last_error"):
                    r.stats.worker_last_error = ent["worker_last_error"]

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "Supervision_restarts": self.restarts,
            "Supervision_last_restart_s": round(self.last_restart_s, 6),
            "Supervision_restart_total_s": round(self.restart_total_s, 6),
            "Supervision_last_cause": self.last_cause,
            "Supervision_escalated": self.escalated is not None,
            "Supervision_abandoned_threads": list(self.abandoned),
            "Supervision_budget_remaining": max(
                0, self.policy.max_restarts - self.policy.consecutive),
            "Supervision_planned_restarts": self.planned_restarts,
            "Recovery_ladder_depth": self.last_ladder_depth,
            "Recovery_verify_failures": self.verify_failures,
            "Recovery_degraded_devices": self.degraded_devices,
            "Supervision_history": list(self.history),
        }
