"""Worker threads: one OS thread per replica-chain.

Trimmed copy of ``windflow_tpu/runtime/worker.py`` (no checkpoint barriers,
no supervision, no flight recorder). Chained operators share a thread and
the stage collector is fused in front of the first replica. Termination
mirrors the reference's EOS cascade (``wf/basic_operator.hpp:180-189``). A
replica that throws records the error, drains its inputs and
force-propagates EOS downstream, so ``PipeGraph.wait_end`` can re-raise it
in the caller's thread.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, List, Optional

from ..message import EOS
from .channel import Channel

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
        self.error: Optional[BaseException] = None
        self._eos_seen = 0
        self._has_coll = hasattr(chain[0], "on_channel_eos")

    def run(self) -> None:
        try:
            self._process()
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

    def _process(self) -> None:
        head = self.chain[0]
        if self.channel is None:
            head.run_source()
            return
        n_inputs = self.channel.n_inputs
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
            ch, msg = item
            if isinstance(msg, EOS):
                self._eos_seen += 1
                if self._has_coll:
                    self.chain[0].on_channel_eos(ch)
                continue
            self.chain[0].handle_msg(ch, msg)

    def _shutdown(self) -> None:
        # EOS cascade in chain order: whatever an upstream node's flush
        # emits is processed by the downstream chained nodes first
        for node in self.chain:
            node.terminate()
        last = self.chain[-1]
        if getattr(last, "emitter", None) is not None:
            last.emitter.send_eos_all()

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
