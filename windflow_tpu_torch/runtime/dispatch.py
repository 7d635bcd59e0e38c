"""DeviceDispatchQueue: the per-replica device-ahead dispatch pipeline.

Copy of ``windflow_tpu/runtime/dispatch.py``. Every device replica's per-batch work has a HOST-PREP stage (key ->
slot resolution, pane bookkeeping, the fire plan: numpy only) and a
DEVICE-COMMIT stage (the kernel launches on the replica's device state
plus the downstream emit). The queue defers the commit stage of up to
``depth`` batches (default ``DISPATCH_DEPTH`` = 2; 0 = synchronous), so
the host prepares batch N+1 while batch N's launches are queued on the
card.

Ordering contract: commits run strictly in submission order, on the
replica's own worker thread. The replica drains the queue at every
ordering point (punctuation, EOS, any host access to its device state,
the worker's idle tick). A commit that raises discards the remaining
entries: they were prepped against control-plane state the failed batch
already advanced.

MEGABATCH (``megabatch`` = K, the graph's ``PipeGraph(megabatch=K)``;
1 = off): when the queue overflows, the longest power-of-two FRONT run of
commits with the same ``scan_sig`` (same fused chain, same capacity
bucket: ``gpu/fused_ops.py`` attaches the attribute) is popped as ONE
group and handed to the commits' ``scan_runner``, which runs the chain
body over the K batches in submission order with one readback wait for
the group. Commits without ``scan_sig`` (every replica but the fused one)
and lone commits run as singles, and ``drain`` always runs singles, so
every ordering point degrades to K=1. A group is a contiguous prefix of
the queue: nothing is ever reordered.

Instrumentation: the host-prep / commit split lands in the replica's
``StatsRecord`` (``Dispatch_*``), the flight ring gets ``dispatch_submit``
and ``dispatch_wait`` events, and with latency tracing on for the operator
every commit runs inside a ``torch.profiler.record_function`` span
``wf:commit:<op>`` (``monitoring/tracing.device_span``; off, it is a
``nullcontext``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

from ..monitoring.tracing import device_span

DISPATCH_DEPTH = 2


class DeviceDispatchQueue:
    """Bounded FIFO of deferred device-commit thunks (see module doc)."""

    def __init__(self, stats=None, depth: Optional[int] = None,
                 megabatch: int = 1) -> None:
        self.depth = DISPATCH_DEPTH if depth is None else max(0, depth)
        self.megabatch = max(1, megabatch)
        # a K-wide group can only form if K prepped commits sit in the
        # queue; depth 0 (synchronous) wins: commits never queue at all
        if self.depth > 0 and self.megabatch > 1:
            self.depth = max(self.depth, self.megabatch)
        self.stats = stats
        # the profiler span of every commit (only with tracing on: the
        # prep span lives in the replica)
        self._span_commit = "wf:commit:" + (
            stats.op_name if stats is not None and stats.op_name else "?")
        self._span_on = stats is not None and stats.sample_every > 0
        # entries are (commit, enqueue perf_counter): the stamp feeds the
        # flight ring's dispatch_wait span (how long the prepared batch
        # sat in the queue before its commit ran)
        self._q: "deque" = deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, commit: Callable[[], None], prep_us: float = 0.0) -> None:
        """Record the host-prep time and queue (or, at depth 0, run) one
        batch's device-commit stage; overflowing ``depth`` commits the
        oldest entry, or the oldest group."""
        if self.stats is not None:
            self.stats.note_host_prep(prep_us)
        if self.depth == 0:
            self._run(commit)
            return
        self._q.append((commit, time.perf_counter()))
        if self.stats is not None:
            self.stats.note_dispatch_depth(len(self._q))
            rec = self.stats.recorder
            if rec is not None:
                rec.event("dispatch_submit", 0.0, len(self._q))
        while len(self._q) > self.depth:
            self._pop_run()

    def drain(self, forced: bool = False) -> None:
        """Commit everything in flight, as singles (``forced`` marks an
        ordering-point drain in the stats)."""
        if forced and self._q and self.stats is not None:
            self.stats.note_dispatch_stall()
        while self._q:
            self._run(*self._q.popleft())

    def on_idle(self) -> bool:
        had = bool(self._q)
        self.drain()
        return had

    def _pop_run(self) -> None:
        """Overflow pop: the oldest commit, or with megabatch on the
        largest power-of-two same-signature front run as one group."""
        q = self._q
        k = self.megabatch
        sig = getattr(q[0][0], "scan_sig", None) if k > 1 else None
        if sig is None:
            self._run(*q.popleft())
            return
        run = 1
        while run < k and run < len(q) \
                and getattr(q[run][0], "scan_sig", None) == sig:
            run += 1
        g = 1 << (run.bit_length() - 1)  # largest power of two <= run
        if g < 2:
            self._run(*q.popleft())
            return
        self._run_group([q.popleft() for _ in range(g)])

    def _run_group(self, entries: List[tuple]) -> None:
        """One same-signature group through the commits' scan runner
        (``FusedGPUReplica._run_megabatch``); a failed group discards the
        rest of the queue, as ``_run`` does."""
        self._note_waits(entries, time.perf_counter())
        commits = [c for c, _t in entries]
        self._run(lambda: commits[0].scan_runner(commits))

    def _note_waits(self, entries, t0: float) -> None:
        rec = self.stats.recorder if self.stats is not None else None
        if rec is not None:
            for _c, enq_t in entries:
                rec.event("dispatch_wait", (t0 - enq_t) * 1e6)

    def _run(self, commit: Callable[[], None],
             enq_t: Optional[float] = None) -> None:
        t0 = time.perf_counter()
        if enq_t is not None:
            self._note_waits(((commit, enq_t),), t0)
        try:
            with device_span(self._span_commit, self._span_on):
                commit()
        except BaseException:
            self._q.clear()
            raise
        finally:
            if self.stats is not None:
                self.stats.note_dispatch_commit(
                    (time.perf_counter() - t0) * 1e6)
