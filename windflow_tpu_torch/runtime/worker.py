"""Worker threads: one OS thread per replica-chain.

Trimmed copy of ``windflow_tpu/runtime/worker.py`` (no supervision, no
flight recorder, no rescale hold, no exactly-once pre-commit). Chained
operators share a thread and the stage collector is fused in front of the
first replica. Termination mirrors the reference's EOS cascade
(``wf/basic_operator.hpp:180-189``). A replica that throws records the
error, drains its inputs and force-propagates EOS downstream, so
``PipeGraph.wait_end`` can re-raise it in the caller's thread.

Checkpointing (``windflow_tpu_torch.checkpoint``): the worker is the
alignment point of checkpoint barriers. ``Barrier`` messages ride the
channels like EOS (one per producer edge, intercepted here, never
delivered to collectors or replicas); a ``BarrierAligner`` buffers
post-barrier input from already-barriered channels until every live
channel delivered the barrier, then ``checkpoint_now`` drains the chain's
device dispatch queues, flushes its emitters, forwards the barrier
downstream, snapshots every node (collector included) and acks the
coordinator with the blobs.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, List, Optional

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
                 channel: Optional[Channel] = None) -> None:
        super().__init__(name=wname, daemon=True)
        self.chain = chain
        self.channel = channel
        self.coordinator = None  # CheckpointCoordinator (bind_coordinator)
        self.error: Optional[BaseException] = None
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

    def bind_coordinator(self, coordinator) -> None:
        """Checkpointing on: ack ``coordinator``'s epochs. Called by
        ``PipeGraph.start`` before the thread starts (after a restore has
        set the coordinator's epoch counter)."""
        self.coordinator = coordinator
        if self.channel is None:
            # source chain: the source replica injects barriers at push
            # boundaries and hands the chain snapshot back to us
            self.chain[0].bind_checkpoint(coordinator, self.checkpoint_now)

    def run(self) -> None:
        try:
            self._process()
            self._retire()
            self._shutdown()
        except BaseException as e:
            self.error = e
            stats = self._stats()
            if stats is not None:
                stats.worker_last_error = "".join(
                    traceback.format_exception(type(e), e, e.__traceback__))
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
        idle_s = IDLE_DRAIN_MS / 1e3 if idle_sinks else None
        idle_streak = 0  # back off (up to 16x) while ticks find nothing
        stats = self._stats()
        while self._eos_seen < n_inputs:
            backoff = idle_s if idle_s is None else idle_s * min(
                16, 1 << min(idle_streak, 4))
            item = self.channel.get(backoff)
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
        pipeline first; (3) state capture (device state copied to host
        numpy; the copies are synchronous); (4) ack with the blobs — the
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
        t_cap = time.perf_counter()
        blobs = self._capture_blobs()
        snapshot_us = (time.perf_counter() - t_cap) * 1e6
        nbytes = coord.ack(barrier.ckpt_id, self.name, blobs)
        cut_us = (time.perf_counter() - t0) * 1e6
        stats = self._stats()
        if stats is not None:
            stats.note_checkpoint(snapshot_us, nbytes, stall_us,
                                  cut_us=cut_us)

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
