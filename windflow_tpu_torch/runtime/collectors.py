"""Collectors: the routing plane on the consumer side.

The port's copy of ``windflow_tpu/runtime/collectors.py``. One collector
is fused in front of the first replica of a stage (the reference's
``combine_with_firststage``, ``wf/multipipe.hpp:200-244``), run on the
replica's worker thread; the graph picks it by execution mode.

- ``WatermarkCollector`` (DEFAULT): per-input-channel max watermark; the
  outgoing watermark is the min over still-open channels
  (``wf/watermark_collector.hpp:65-80``).
- ``OrderingCollector`` (DETERMINISTIC): k-way merge of the per-channel
  ordered streams into one total order by (ts, id)
  (``wf/ordering_collector.hpp:50-272``).
- ``IDSequencerCollector``: per-key id sequencing in front of the WLQ and
  REDUCE stages of Paned/MapReduce windows, in every mode.
- ``DPJoinCollector``: one total order for every replica of a DP-mode
  Interval_Join in DEFAULT mode (``wf/join_collector.hpp``).
- ``KSlackCollector`` (PROBABILISTIC): K-slack buffering with an adaptive
  K; tuples behind the released frontier are dropped and counted
  (``wf/kslack_collector.hpp:52-243``).

A collector in front of an Interval_Join tags each message with its
stream (A below the channel separator, B from it on,
``watermark_collector.hpp:121-134``). The ordering, id-sequencing,
DP-join and K-slack collectors hold messages the replica has not seen:
those are part of the worker's snapshot (as copies, so the blob owns
them), and ``terminate`` delivers what they still hold at EOS.
``BarrierAligner`` is the worker's per-channel bookkeeping of aligned
checkpoint barriers.
"""

from __future__ import annotations

import copy
import heapq
import threading
import time
from collections import deque
from typing import Any, List, Optional

from ..message import Batch, Single

MAX_WM = (1 << 63) - 1


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
            # flight-recorder marker of the OPEN (the stall span itself is
            # the worker's barrier_align at take()): which channel's
            # barrier arrived first
            from ..monitoring.flightrec import thread_recorder
            rec = thread_recorder()
            if rec is not None:
                rec.event("barrier_open", 0.0,
                          {"ckpt_id": getattr(barrier, "ckpt_id", None),
                           "channel": ch})
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


class BasicCollector:
    """Chain-node protocol: handle_msg(ch, msg) / on_channel_eos(ch) /
    terminate(). ``next_node`` is the stage's first replica."""

    def __init__(self, n_channels: int, next_node: Any,
                 separator_id: Optional[int] = None) -> None:
        self.n_channels = n_channels
        self.next_node = next_node
        self.separator_id = separator_id  # join A/B channel split point
        self.live = set(range(n_channels))

    def _tag(self, ch: int, msg: Any) -> None:
        if self.separator_id is not None:
            msg.stream_tag = 0 if ch < self.separator_id else 1

    def handle_msg(self, ch: int, msg: Any) -> None:
        raise NotImplementedError

    def on_channel_eos(self, ch: int) -> None:
        self.live.discard(ch)

    def terminate(self) -> None:
        pass

    # -- checkpointing (aligned snapshots, windflow_tpu_torch.checkpoint) --
    # Collectors buffer pre-barrier messages the replica has not seen yet
    # (ordering and K-slack heaps, id sequencing), so their buffers are
    # part of the worker's snapshot. ``live`` is not snapshotted: a
    # restored graph starts with every channel open and its sources replay.
    def snapshot_state(self) -> dict:
        return {}

    def restore_state(self, state: dict) -> None:
        pass


class WatermarkCollector(BasicCollector):
    def __init__(self, n_channels: int, next_node: Any,
                 separator_id: Optional[int] = None) -> None:
        super().__init__(n_channels, next_node, separator_id)
        self._ch_wm = [0] * n_channels

    def _out_wm(self) -> int:
        if not self.live:
            return max(self._ch_wm) if self._ch_wm else 0
        return min(self._ch_wm[c] for c in self.live)

    def handle_msg(self, ch: int, msg: Any) -> None:
        wm = msg.min_watermark()
        if wm > self._ch_wm[ch]:
            self._ch_wm[ch] = wm
        self._tag(ch, msg)
        msg.wm = self._out_wm()
        self.next_node.handle_msg(0, msg)

    def snapshot_state(self) -> dict:
        return {"ch_wm": list(self._ch_wm)}

    def restore_state(self, state: dict) -> None:
        wm = state.get("ch_wm")
        if wm is not None and len(wm) == len(self._ch_wm):
            self._ch_wm = list(wm)


class OrderingCollector(BasicCollector):
    """Each input channel is locally ordered (per-destination ids are
    assigned monotonically by emitters); merge to a total order. A message is
    releasable once every live channel has something buffered (its head is a
    lower bound for anything that channel will send)."""

    def __init__(self, n_channels: int, next_node: Any,
                 separator_id: Optional[int] = None) -> None:
        super().__init__(n_channels, next_node, separator_id)
        self._bufs: List[deque] = [deque() for _ in range(n_channels)]

    def _key(self, msg: Any):
        if isinstance(msg, Batch):
            ts = msg.rows[0][1] if msg.rows else 0
        else:
            ts = msg.ts
        return (ts, msg.id)

    def handle_msg(self, ch: int, msg: Any) -> None:
        if msg.is_punct:  # no punctuations in DETERMINISTIC mode; absorb
            return
        self._tag(ch, msg)
        self._bufs[ch].append(msg)
        self._drain()

    def _drain(self) -> None:
        """Release heads in (ts, id) order while every open channel holds
        something. Ties break by channel index whether or not the channel
        is still open: a closed channel's leftovers tie-break exactly as
        they did before its EOS arrived, so the merged order does not
        depend on when the EOS landed (the JAX package visits open
        channels first, which lets an early EOS reorder equal keys)."""
        while True:
            best_ch = -1
            best_key = None
            for c in range(self.n_channels):
                buf = self._bufs[c]
                if not buf:
                    if c in self.live:
                        return  # an open channel is empty: cannot release
                    continue
                k = self._key(buf[0])
                if best_key is None or k < best_key:
                    best_key, best_ch = k, c
            if best_ch < 0:
                return
            self.next_node.handle_msg(0, self._bufs[best_ch].popleft())

    def on_channel_eos(self, ch: int) -> None:
        super().on_channel_eos(ch)
        self._drain()

    def terminate(self) -> None:
        # all channels closed: total merge of leftovers
        heap = []
        for c, buf in enumerate(self._bufs):
            for i, m in enumerate(buf):
                heapq.heappush(heap, (self._key(m), c, i, m))
        while heap:
            _, _, _, m = heapq.heappop(heap)
            self.next_node.handle_msg(0, m)
        self._bufs = [deque() for _ in range(self.n_channels)]

    def snapshot_state(self) -> dict:
        return {"bufs": copy.deepcopy([list(b) for b in self._bufs])}

    def restore_state(self, state: dict) -> None:
        bufs = state.get("bufs")
        if bufs is not None and len(bufs) == len(self._bufs):
            self._bufs = [deque(b) for b in bufs]


class IDSequencerCollector(BasicCollector):
    """Per-key id sequencer in front of WLQ/REDUCE window stages (used in
    EVERY execution mode — reference ``wf/multipipe.hpp:221-224`` installs an
    Ordering_Collector in ID mode for ``Parallel_Windows_WLQ/REDUCE``).

    Upstream PLQ/MAP replicas stamp each partial result with a dense global
    id per key (pane id, or ``gwid*map_parallelism + replica``); this
    collector releases them in exactly id order per key, so the consumer's
    count-based windows see a deterministic sequence regardless of arrival
    interleaving. Gaps never persist (the id space is dense per key across
    producers); leftovers are drained in id order at EOS."""

    def __init__(self, n_channels: int, next_node: Any,
                 key_extractor) -> None:
        super().__init__(n_channels, next_node, None)
        self.key_of = key_extractor
        self._next: dict = {}  # key -> next expected id
        self._pending: dict = {}  # key -> {id: msg}

    def handle_msg(self, ch: int, msg: Any) -> None:
        if msg.is_punct:
            return  # watermark progress is carried by released messages
        key = self.key_of(msg.payload)
        nxt = self._next.get(key, 0)
        if msg.id == nxt:
            self.next_node.handle_msg(0, msg)
            nxt += 1
            pend = self._pending.get(key)
            while pend:
                m = pend.pop(nxt, None)
                if m is None:
                    break
                self.next_node.handle_msg(0, m)
                nxt += 1
            self._next[key] = nxt
        else:
            self._pending.setdefault(key, {})[msg.id] = msg

    def terminate(self) -> None:
        for key, pend in self._pending.items():
            for i in sorted(pend):
                self.next_node.handle_msg(0, pend[i])
        self._pending.clear()

    def snapshot_state(self) -> dict:
        return {"next": dict(self._next),
                "pending": copy.deepcopy(
                    {k: dict(v) for k, v in self._pending.items()})}

    def restore_state(self, state: dict) -> None:
        self._next = dict(state.get("next", {}))
        self._pending = {k: dict(v)
                         for k, v in state.get("pending", {}).items()}


class DPJoinCollector(BasicCollector):
    """For DP-mode Interval_Join in DEFAULT mode (reference
    ``wf/join_collector.hpp``): every broadcast replica must observe the
    SAME tuple sequence so their round-robin storage assignment agrees.
    Messages buffer until the min watermark across channels STRICTLY
    passes their timestamp, then release in total (ts, channel, id) order —
    a content-determined order identical on every replica regardless of
    arrival interleaving (releasing ts == bound on arrival would expose
    cross-channel arrival order for ties). Punctuations are forwarded after
    the releases they trigger."""

    def __init__(self, n_channels: int, next_node: Any,
                 separator_id: Optional[int] = None) -> None:
        super().__init__(n_channels, next_node, separator_id)
        self._ch_wm = [0] * n_channels
        self._heap: list = []  # (ts, ch, id, msg)

    def _min_wm(self) -> int:
        if not self.live:
            return MAX_WM
        return min(self._ch_wm[c] for c in self.live)

    def handle_msg(self, ch: int, msg: Any) -> None:
        wm = msg.min_watermark()
        if wm > self._ch_wm[ch]:
            self._ch_wm[ch] = wm
        self._tag(ch, msg)
        if not msg.is_punct:
            if isinstance(msg, Batch):
                # flatten: ordering whole batches by their first row would
                # break the per-row ts order the DP purge frontier relies on
                for ri, (payload, ts) in enumerate(msg.rows):
                    row = Single(payload, (msg.id << 20) | ri, ts, msg.wm)
                    row.stream_tag = msg.stream_tag
                    heapq.heappush(self._heap, (ts, ch, row.id, row))
            else:
                heapq.heappush(self._heap, (msg.ts, ch, msg.id, msg))
        bound = self._min_wm()
        self._release(bound)
        if msg.is_punct:
            msg.wm = bound if bound < MAX_WM else wm
            self.next_node.handle_msg(0, msg)

    def _release(self, bound: int) -> None:
        # strict: a message with ts == bound could still be followed by a
        # same-ts message on another channel
        while self._heap and self._heap[0][0] < bound:
            _, _, _, m = heapq.heappop(self._heap)
            if bound < MAX_WM:
                m.wm = bound
            # post-EOS drain (bound == MAX_WM): keep each message's own
            # watermark — inflating it would purge the join archives while
            # pending pairs still need them
            self.next_node.handle_msg(0, m)

    def on_channel_eos(self, ch: int) -> None:
        super().on_channel_eos(ch)
        self._release(self._min_wm())

    def terminate(self) -> None:
        while self._heap:
            _, _, _, m = heapq.heappop(self._heap)
            self.next_node.handle_msg(0, m)

    def snapshot_state(self) -> dict:
        return {"ch_wm": list(self._ch_wm),
                "heap": copy.deepcopy(list(self._heap))}

    def restore_state(self, state: dict) -> None:
        wm = state.get("ch_wm")
        if wm is not None and len(wm) == len(self._ch_wm):
            self._ch_wm = list(wm)
        self._heap = list(state.get("heap", []))
        heapq.heapify(self._heap)


class KSlackCollector(BasicCollector):
    """Adaptive K-slack (``wf/kslack_collector.hpp:99-118``): K tracks the
    maximum observed disorder ``max_ts - ts``; buffered tuples are released in
    timestamp order once ``ts <= max_ts - K``. Tuples older than the released
    frontier are dropped and counted."""

    def __init__(self, n_channels: int, next_node: Any,
                 dropped_counter: Optional[AtomicCounter] = None,
                 separator_id: Optional[int] = None) -> None:
        super().__init__(n_channels, next_node, separator_id)
        self.K = 0
        self._max_ts = 0
        self._frontier = -1  # max ts already released
        self._heap: list = []  # (ts, seq, msg)
        self._seq = 0
        self.dropped = dropped_counter if dropped_counter is not None else AtomicCounter()

    @staticmethod
    def _ts_of(msg: Any) -> int:
        if isinstance(msg, Batch):
            return msg.rows[0][1] if msg.rows else 0
        return msg.ts

    def handle_msg(self, ch: int, msg: Any) -> None:
        if msg.is_punct:
            return
        self._tag(ch, msg)
        ts = self._ts_of(msg)
        # adapt K from EVERY arrival (including late ones we then drop) —
        # otherwise K never learns the stream's disorder and the frontier
        # drops everything behind it
        if ts > self._max_ts:
            self._max_ts = ts
        delay = self._max_ts - ts
        if delay > self.K:
            self.K = delay
        if ts <= self._frontier:
            n = msg.size if isinstance(msg, Batch) else 1
            self.dropped.add(n)
            return
        heapq.heappush(self._heap, (ts, self._seq, msg))
        self._seq += 1
        self._release(self._max_ts - self.K)

    def _release(self, up_to: int) -> None:
        while self._heap and self._heap[0][0] <= up_to:
            ts, _, m = heapq.heappop(self._heap)
            if ts > self._frontier:
                self._frontier = ts
            self.next_node.handle_msg(0, m)

    def terminate(self) -> None:
        self._release(MAX_WM)

    def snapshot_state(self) -> dict:
        return {"K": self.K, "max_ts": self._max_ts,
                "frontier": self._frontier,
                "heap": copy.deepcopy(list(self._heap)),
                "seq": self._seq}

    def restore_state(self, state: dict) -> None:
        self.K = state.get("K", 0)
        self._max_ts = state.get("max_ts", 0)
        self._frontier = state.get("frontier", -1)
        self._seq = state.get("seq", 0)
        self._heap = list(state.get("heap", []))
        heapq.heapify(self._heap)
