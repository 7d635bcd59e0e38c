"""DeviceDispatchQueue: the per-replica device-ahead dispatch pipeline.

Copy of ``windflow_tpu/runtime/dispatch.py`` without megabatching and the
flight-recorder spans. Every device replica's per-batch work has a
HOST-PREP stage (key -> slot resolution, pane bookkeeping, the fire plan:
numpy only) and a DEVICE-COMMIT stage (the kernel launches on the
replica's device state plus the downstream emit). The queue defers the
commit stage of up to ``depth`` batches (default ``DISPATCH_DEPTH`` = 2;
0 = synchronous), so the host prepares batch N+1 while batch N's launches
are queued on the card.

Ordering contract: commits run strictly in submission order, on the
replica's own worker thread. The replica drains the queue at every
ordering point (punctuation, EOS, any host access to its device state,
the worker's idle tick). A commit that raises discards the remaining
entries: they were prepped against control-plane state the failed batch
already advanced.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

DISPATCH_DEPTH = 2


class DeviceDispatchQueue:
    """Bounded FIFO of deferred device-commit thunks (see module doc)."""

    def __init__(self, stats=None, depth: Optional[int] = None) -> None:
        self.depth = DISPATCH_DEPTH if depth is None else max(0, depth)
        self.stats = stats
        self._q: "deque[Callable[[], None]]" = deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, commit: Callable[[], None], prep_us: float = 0.0) -> None:
        """Record the host-prep time and queue (or, at depth 0, run) one
        batch's device-commit stage; overflowing ``depth`` commits the
        oldest entry."""
        if self.stats is not None:
            self.stats.note_host_prep(prep_us)
        if self.depth == 0:
            self._run(commit)
            return
        self._q.append(commit)
        if self.stats is not None:
            self.stats.note_dispatch_depth(len(self._q))
        while len(self._q) > self.depth:
            self._run(self._q.popleft())

    def drain(self, forced: bool = False) -> None:
        """Commit everything in flight (``forced`` marks an ordering-point
        drain in the stats)."""
        if forced and self._q and self.stats is not None:
            self.stats.note_dispatch_stall()
        while self._q:
            self._run(self._q.popleft())

    def on_idle(self) -> bool:
        had = bool(self._q)
        self.drain()
        return had

    def _run(self, commit: Callable[[], None]) -> None:
        t0 = time.perf_counter()
        try:
            commit()
        except BaseException:
            self._q.clear()
            raise
        finally:
            if self.stats is not None:
                self.stats.note_dispatch_commit(
                    (time.perf_counter() - t0) * 1e6)
