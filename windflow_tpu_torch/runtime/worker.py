"""Worker threads: one OS thread per replica-chain.

Copy of ``windflow_tpu/runtime/worker.py``. Chained operators share a
thread and the stage collector is fused in front of the first replica.
A worker may own a flight-recorder ring (``monitoring/flightrec.py``),
shared with every chain node's stats record; it advances a progress
counter the stall watchdog reads, and with the watchdog armed it takes
its idle tick even when nothing in the chain pipelines work.
Termination mirrors the reference's EOS cascade
(``wf/basic_operator.hpp:180-189``). A replica that throws records the
error, drains its inputs and force-propagates EOS downstream, so
``PipeGraph.wait_end`` can re-raise it in the caller's thread; under
supervision (``on_failure`` wired) it only notifies the supervisor, which
owns the teardown. ``RescaleTeardown`` (a rescale's ``abandon``, or a
closed channel's ``SupervisorTeardown``) ends the thread silently.

Checkpointing (``windflow_tpu_torch.checkpoint``): the worker is the
alignment point of checkpoint barriers. ``Barrier`` messages ride the
channels like EOS (one per producer edge, intercepted here, never
delivered to collectors or replicas); a ``BarrierAligner`` buffers
post-barrier input from already-barriered channels until every live
channel delivered the barrier, then ``checkpoint_now`` drains the chain's
device dispatch queues, flushes its emitters, forwards the barrier
downstream, has every exactly-once sink pre-commit its epoch
(``precommit_epoch``), snapshots every node (collector included) and
acks the coordinator with the blobs. A held epoch (a live rescale) then
parks the worker right after its ack until the rescale controller
releases it.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, List, Optional

from ..basic import RescaleTeardown
from ..checkpoint.delta import capturing, delta_bases
from ..message import EOS, Barrier
from .channel import Channel
from .collectors import BarrierAligner

# a quiet channel gives pipelining nodes an idle tick after this long
IDLE_DRAIN_MS = 50.0


class Worker(threading.Thread):
    """Runs a chain ``[collector?] + [replica_op1, replica_op2, ...]``.
    For source stages ``channel`` is None and the first chain node is a
    SourceReplica that drives its own generation loop."""

    def __init__(self, wname: str, chain: List[Any],
                 channel: Optional[Channel] = None,
                 flightrec: Optional[Any] = None) -> None:
        super().__init__(name=wname, daemon=True)
        self.chain = chain
        self.channel = channel
        self.coordinator = None  # CheckpointCoordinator (bind_coordinator)
        self.error: Optional[BaseException] = None
        # flight recorder (monitoring/flightrec.py): this worker's ring,
        # shared with every chain node's stats record so the stats hooks
        # (svc / prep / commit / snapshot) append spans to it
        self.flightrec = flightrec
        # crash hook (the graph wires a post-mortem trace dump)
        self.on_crash = None
        # supervised recovery (supervision/): when wired, a dying worker
        # notifies the supervisor and exits WITHOUT the drain and
        # emergency EOS (sinks must not see an end of stream mid-recovery)
        self.on_failure = None
        # the stall watchdog needs idle ticks even without idle sinks, so
        # a worker parked on an empty channel still advances its counter
        self.force_idle_tick = False
        self._progress = 0  # channel deliveries + idle ticks (watchdog)
        self._eos_seen = 0
        self._has_coll = hasattr(chain[0], "on_channel_eos")
        # the chain nodes that carry operator state (the collector, when
        # present, is snapshotted with the first replica), deduped by
        # identity: every sub-op of a fused device stage aliases ONE fused
        # replica, which must drain, snapshot and terminate once
        self._replicas = []
        for n in chain:
            if hasattr(n, "snapshot_state") and hasattr(n, "op") \
                    and not any(n is r for r in self._replicas):
                self._replicas.append(n)
        self._aligner: Optional[BarrierAligner] = None
        if flightrec is not None:
            for n in chain:
                st = getattr(n, "stats", None)
                if st is not None:
                    st.recorder = flightrec

    def bind_coordinator(self, coordinator) -> None:
        """Checkpointing on: ack ``coordinator``'s epochs. Called by
        ``PipeGraph.start`` before the thread starts (after a restore has
        set the coordinator's epoch counter)."""
        self.coordinator = coordinator
        if self.channel is None:
            # source chain: the source replica injects barriers at push
            # boundaries and hands the chain snapshot back to us
            self.chain[0].bind_checkpoint(coordinator, self.checkpoint_now)
        # exactly-once sinks (sinks/transactional.py): their commit rides
        # the coordinator's finalize listener
        for n in self._replicas:
            bind = getattr(n, "bind_txn_coordinator", None)
            if bind is not None:
                bind(coordinator)

    def run(self) -> None:
        if self.flightrec is not None:
            # blocked channel puts/gets and kernel loads find this
            # thread's ring through the TLS slot
            from ..monitoring.flightrec import set_thread_recorder
            set_thread_recorder(self.flightrec)
        try:
            self._process()
            self._retire()
            self._shutdown()
        except RescaleTeardown:
            # a rescale rebuilds the plane from the checkpoint we just
            # acked, or the supervisor closed our channels: exit silently,
            # no EOS cascade and no retirement
            return
        except BaseException as e:
            self.error = e
            # crash visibility FIRST (while the ring still holds the
            # run-up): the stats plane, the ring, the post-mortem hook
            try:
                self._record_crash(e)
            except BaseException:
                pass
            if self.on_failure is not None:
                try:
                    self.on_failure(self)
                except BaseException:
                    pass
                return
            # unwind so sibling workers never block on us: swallow the rest
            # of our input, then force EOS downstream
            try:
                self._drain_inputs()
            except BaseException:
                pass
            try:
                self._emergency_eos()
            except BaseException:
                pass

    def _stats(self):
        return next((n.stats for n in self.chain
                     if getattr(n, "stats", None) is not None), None)

    def _record_crash(self, e: BaseException) -> None:
        """The exception type and traceback land in ``Worker_last_error``
        (and the graph's ``Worker_errors``), a ``crash`` event enters the
        ring, and the graph's post-mortem hook dumps the trace."""
        stats = self._stats()
        if stats is not None:
            stats.worker_crashes += 1
            stats.worker_last_error = "".join(
                traceback.format_exception(type(e), e, e.__traceback__))
        if self.flightrec is not None:
            self.flightrec.event("crash", 0.0, f"{type(e).__name__}: {e}")
        if self.on_crash is not None:
            self.on_crash(self, e)

    def progress_value(self) -> int:
        """Monotone liveness counter for the stall watchdog: channel
        deliveries and idle ticks, plus the tuples the head replica moved
        (a source's loop never returns to ``_process``, and a worker stuck
        inside one long message would otherwise look live). Shed records
        count: a source under admission control is refusing work, not
        wedged."""
        v = self._progress
        stats = self._stats()
        if stats is not None:
            v += (stats.inputs_received + stats.outputs_sent
                  + stats.shed_records)
        return v

    # -- normal path -------------------------------------------------------
    def _process(self) -> None:
        head = self.chain[0]
        if self.channel is None:
            head.run_source()
            # an epoch the loop never reached injects at EOS time: a
            # finished source's final position is a valid snapshot, and
            # without it the checkpoint could never gather all acks
            head.final_checkpoint()
            return
        n_inputs = self.channel.n_inputs
        if self.coordinator is not None:
            self._aligner = BarrierAligner(n_inputs)
        # anything that pipelines work (replica dispatch queues, emitter
        # D2H FIFOs) must not withhold results on an idle stream: poll with
        # a timeout and give it an idle tick when the channel stays quiet.
        # Chain order, node before its emitter.
        idle_sinks = []
        for node in self.chain:
            if hasattr(node, "on_idle"):
                idle_sinks.append(node)
            em = getattr(node, "emitter", None)
            if em is not None and hasattr(em, "on_idle"):
                idle_sinks.append(em)
        idle_s = IDLE_DRAIN_MS / 1e3 \
            if idle_sinks or self.force_idle_tick else None
        idle_streak = 0  # back off (up to 16x) while ticks find nothing
        stats = self._stats()
        while self._eos_seen < n_inputs:
            backoff = idle_s if idle_s is None else idle_s * min(
                16, 1 << min(idle_streak, 4))
            item = self.channel.get(backoff)
            self._progress += 1  # liveness for the stall watchdog
            if item is None:  # idle tick
                if stats is not None:
                    stats.worker_idle_ticks += 1
                did_work = False
                for sink in idle_sinks:
                    did_work = bool(sink.on_idle()) or did_work
                idle_streak = 0 if did_work else idle_streak + 1
                continue
            idle_streak = 0
            self._handle_item(item[0], item[1])

    def _handle_item(self, ch: int, msg: Any) -> None:
        """One channel delivery: barrier alignment first, then the normal
        EOS / message path. Re-entered for buffered post-barrier items
        after a snapshot (a buffered item may itself be the next Barrier,
        opening the next alignment)."""
        al = self._aligner
        if al is not None and al.blocked(ch):
            # post-barrier input on an aligned channel: park it. EOS too
            # (consuming it early would change collector state
            # mid-snapshot), and so is a next-epoch Barrier — channels are
            # FIFO, so anything behind this epoch's barrier belongs to the
            # next alignment and replays after the snapshot
            al.buffered.append((ch, msg))
            return
        if isinstance(msg, Barrier):
            if al is not None and al.on_barrier(ch, msg):
                self._complete_alignment()
            return  # checkpointing off: a stray barrier is dropped
        if isinstance(msg, EOS):
            self._eos_seen += 1
            if self._has_coll:
                self.chain[0].on_channel_eos(ch)
            if al is not None and al.on_eos(ch):
                self._complete_alignment()
            return
        self.chain[0].handle_msg(ch, msg)

    def _complete_alignment(self) -> None:
        barrier, stall_us, buffered = self._aligner.take()
        self.checkpoint_now(barrier, stall_us)
        for ch, msg in buffered:
            self._handle_item(ch, msg)

    # -- checkpointing -----------------------------------------------------
    def checkpoint_now(self, barrier: Barrier, stall_us: float = 0.0) -> None:
        """Snapshot the whole chain for one aligned barrier. Runs on this
        worker's own thread (from ``_complete_alignment``, or from the
        source replica's injection hook mid-``run_source``), so no tuple
        is in flight anywhere in the chain.

        Order matters: (1) in chain order, drain each node's dispatch
        queue (``drain(forced=True)`` runs every queued commit as a single,
        so an open megabatch group closes here) and flush the inline
        emitter feeding the next node, so every pre-barrier tuple reaches
        downstream channels BEFORE the barrier; (2) the barrier goes
        downstream through the last emitter, which drains its D2H
        pipeline first; (3) exactly-once sinks pre-commit the epoch;
        (4) state capture under the snapshot context
        (``checkpoint/delta.py``: engines that track their touched slots
        may emit a delta against their last FULL snapshot), device state
        copied to host numpy with synchronous copies, so the blobs own
        their data when (5) the ack hands them over — written here, or
        queued for the coordinator's uploader with ``async_upload``. The
        coordinator commits once every worker has acked."""
        coord = self.coordinator
        if coord is None:
            return
        t0 = time.perf_counter()
        replicas = self._replicas
        last = replicas[-1] if replicas else None
        for node in replicas:
            dq = getattr(node, "dispatch", None)
            if dq is not None:
                dq.drain(forced=True)
            em = node.emitter
            if em is not None and node is not last:
                em.flush()  # inline edge: feeds the next chained node now
        if last is not None and last.emitter is not None:
            last.emitter.send_barrier_all(barrier)
        # exactly-once sinks pre-commit the epoch BEFORE the capture (and
        # before our ack can let the coordinator finalize it): what they
        # staged since the previous barrier becomes this epoch's durable,
        # not yet visible segment or transaction
        for node in replicas:
            hook = getattr(node, "precommit_epoch", None)
            if hook is not None:
                hook(barrier.ckpt_id)
        t_cap = time.perf_counter()
        with capturing(barrier.ckpt_id, coord.store, coord.store.delta,
                       coord.full_every):
            blobs = self._capture_blobs()
        snapshot_us = (time.perf_counter() - t_cap) * 1e6
        nbytes = coord.ack(barrier.ckpt_id, self.name, blobs)
        cut_us = (time.perf_counter() - t0) * 1e6
        stats = self._stats()
        if stats is not None:
            stats.note_checkpoint(snapshot_us, nbytes, stall_us,
                                  cut_us=cut_us)
        rec = self.flightrec
        if rec is not None:
            rec.event("ckpt:cut", cut_us, {"ckpt_id": barrier.ckpt_id,
                                           "bytes": nbytes})
            ndelta = sum(1 for st in blobs.values() if delta_bases(st))
            if ndelta:
                rec.event("ckpt:delta", 0.0, {"ckpt_id": barrier.ckpt_id,
                                              "delta_blobs": ndelta})
            rec.event("ckpt_ack", 0.0, {"ckpt_id": barrier.ckpt_id,
                                        "bytes": nbytes})
        # the rescale quiesce point: a held epoch parks every worker here,
        # after its ack, with every pre-barrier tuple flushed and the
        # barrier forwarded, before any post-barrier tuple is produced
        t_park = time.perf_counter()
        directive = coord.park_if_held(barrier.ckpt_id, self.name)
        if directive is not None and rec is not None:
            rec.event("rescale:parked", (time.perf_counter() - t_park) * 1e6,
                      {"ckpt_id": barrier.ckpt_id, "directive": directive})
        if directive == "abandon":
            raise RescaleTeardown()

    def _capture_blobs(self) -> dict:
        blobs = {}
        for node in self._replicas:
            dq = getattr(node, "dispatch", None)
            if dq is not None:
                dq.drain(forced=True)
            state = node.snapshot_state()
            if node.emitter is not None:
                state["__emitter__"] = node.emitter.emitter_state()
            blobs[(node.op.name, node.idx)] = state
        if self._has_coll and self._replicas:
            coll_state = self.chain[0].snapshot_state()
            if coll_state:
                blobs[(self._replicas[0].op.name,
                       self._replicas[0].idx)]["__collector__"] = coll_state
        return blobs

    def _retire(self) -> None:
        """Clean exit with checkpointing on: hand the coordinator our final
        state, so epochs opened after we finish still complete (a finished
        worker's state is frozen — captured BEFORE the EOS flush, so a
        restore re-runs the flush as a live replica would)."""
        if self.coordinator is not None:
            self.coordinator.retire(self.name, self._capture_blobs())

    def _shutdown(self) -> None:
        # EOS cascade in chain order: whatever an upstream node's flush
        # emits is processed by the downstream chained nodes first
        for node in self.chain:
            node.terminate()
        last = self.chain[-1]
        if getattr(last, "emitter", None) is not None:
            last.emitter.send_eos_all()

    # -- error path --------------------------------------------------------
    def _drain_inputs(self) -> None:
        if self.channel is None:
            return
        while self._eos_seen < self.channel.n_inputs:
            _, msg = self.channel.get()
            if isinstance(msg, EOS):
                self._eos_seen += 1

    def _emergency_eos(self) -> None:
        em = getattr(self.chain[-1], "emitter", None)
        if em is not None:
            for port in em.eos_ports():
                try:
                    port.send_eos()
                except BaseException:
                    pass
