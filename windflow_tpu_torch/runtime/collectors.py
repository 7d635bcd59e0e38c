"""Collectors: the routing plane on the consumer side.

Trimmed copy of ``windflow_tpu/runtime/collectors.py``: the port runs
DEFAULT mode only, so the one collector is ``WatermarkCollector``
(per-input-channel max watermark; outgoing watermark = min over still-open
channels, ``wf/watermark_collector.hpp:65-80``), fused in front of the
first replica of a stage with several input channels (a merge, or a
shuffle from several producer replicas). ``BarrierAligner`` is the
worker's per-channel bookkeeping of aligned checkpoint barriers.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional


class AtomicCounter:
    """Shared dropped-tuple counter (``wf/pipegraph.hpp:91-92``)."""

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class BarrierAligner:
    """Per-worker aligned-checkpoint barrier bookkeeping (Flink's barrier
    alignment; the checkpoint twin of the per-channel EOS counting in
    ``Worker._process``).

    A checkpoint's barrier arrives once per input channel. The first
    arrival opens an alignment: from then on, input from channels that
    already delivered their barrier is BUFFERED (those tuples are
    post-barrier and must not reach the snapshot), while the remaining
    channels keep processing. When every live channel has delivered the
    barrier — or gone EOS: a finished producer sends no more data — the
    worker snapshots and the buffered backlog replays in arrival order.
    Buffering (instead of blocking the channel) means alignment can never
    deadlock the bounded channels upstream."""

    __slots__ = ("live", "waiting", "arrived", "buffered", "align_t0_ns")

    def __init__(self, n_channels: int) -> None:
        self.live = set(range(n_channels))
        self.waiting: Optional[Any] = None  # the in-flight Barrier
        self.arrived: set = set()
        self.buffered: list = []  # (ch, msg) from already-barriered channels
        self.align_t0_ns = 0

    def blocked(self, ch: int) -> bool:
        return self.waiting is not None and ch in self.arrived

    def on_barrier(self, ch: int, barrier: Any) -> bool:
        """Returns True when alignment is complete (snapshot now)."""
        if self.waiting is None:
            self.waiting = barrier
            self.arrived = {ch}
            self.align_t0_ns = time.monotonic_ns()
        else:
            self.arrived.add(ch)
        return self.live.issubset(self.arrived)

    def on_eos(self, ch: int) -> bool:
        """A closed channel sends no more data (all of its input was
        pre-barrier); it stops counting toward alignment. Returns True
        when this completes a pending alignment."""
        self.live.discard(ch)
        return (self.waiting is not None
                and self.live.issubset(self.arrived))

    def take(self):
        """Close the alignment: ``(barrier, stall_us, buffered)``."""
        barrier = self.waiting
        stall_us = (time.monotonic_ns() - self.align_t0_ns) / 1e3
        buffered = self.buffered
        self.waiting = None
        self.arrived = set()
        self.buffered = []
        return barrier, stall_us, buffered


class WatermarkCollector:
    """Chain-node protocol: handle_msg(ch, msg) / on_channel_eos(ch) /
    terminate(). ``next_node`` is the stage's first replica."""

    def __init__(self, n_channels: int, next_node: Any) -> None:
        self.next_node = next_node
        self.live = set(range(n_channels))
        self._ch_wm = [0] * n_channels

    def _out_wm(self) -> int:
        if not self.live:
            return max(self._ch_wm) if self._ch_wm else 0
        return min(self._ch_wm[c] for c in self.live)

    def handle_msg(self, ch: int, msg: Any) -> None:
        wm = msg.min_watermark()
        if wm > self._ch_wm[ch]:
            self._ch_wm[ch] = wm
        msg.wm = self._out_wm()
        self.next_node.handle_msg(0, msg)

    def on_channel_eos(self, ch: int) -> None:
        self.live.discard(ch)

    def terminate(self) -> None:
        pass

    # -- checkpointing: the per-channel watermarks ride the worker's blob.
    # ``live`` is not saved: a restored graph starts with every channel
    # open and its sources replay.
    def snapshot_state(self) -> dict:
        return {"ch_wm": list(self._ch_wm)}

    def restore_state(self, state: dict) -> None:
        wm = state.get("ch_wm")
        if wm is not None and len(wm) == len(self._ch_wm):
            self._ch_wm = list(wm)
