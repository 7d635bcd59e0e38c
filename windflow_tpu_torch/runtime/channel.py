"""Bounded channels and ports connecting replicas.

Copy of ``windflow_tpu/runtime/channel.py``: every consumer worker owns
one bounded MPSC ``Channel`` that merges its input edges (like FastFlow's
``ff_minode``); each producer edge is a ``QueuePort`` stamping the
consumer-side channel index; chained stages talk through ``InlinePort``.
A channel counts the time producers spend blocked on it when full and its
consumer when empty (the autoscaler's backpressure and starvation
signals, and ``ch_put_blocked`` / ``ch_get_blocked`` spans in the calling
thread's flight ring), and ``close()`` poisons it for a supervised
teardown. ``native.NativeChannel`` is the same contract over the C++
ring (``PipeGraph(native_channels=True)``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional, Tuple

from ..basic import DEFAULT_BUFFER_CAPACITY, SupervisorTeardown
from ..message import EOS_SENTINEL
# flight-recorder spans of blocked puts and gets go to the CALLING
# thread's ring (a producer blocks on its consumer's channel); only the
# blocked paths read it
from ..monitoring.flightrec import thread_recorder


def _teardown() -> SupervisorTeardown:
    return SupervisorTeardown(
        "channel closed: the supervisor is rebuilding the runtime plane")


class Channel:
    """Bounded blocking MPSC queue of ``(channel_idx, msg)`` pairs."""

    __slots__ = ("_q", "_lock", "_not_empty", "_not_full", "capacity",
                 "n_inputs", "depth_max", "puts_blocked", "blocked_put_ns",
                 "blocked_get_ns", "closed")

    def __init__(self, capacity: int = DEFAULT_BUFFER_CAPACITY) -> None:
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.capacity = capacity
        self.n_inputs = 0  # number of producer edges; assigned at wiring
        # supervised teardown: close() poisons the channel, every blocked
        # and future put/get raises SupervisorTeardown
        self.closed = False
        # backpressure (producers blocked on a full queue: this stage is
        # the bottleneck) and starvation (the consumer blocked on an empty
        # one); clocks are read on the blocked paths only
        self.depth_max = 0
        self.puts_blocked = 0
        self.blocked_put_ns = 0
        self.blocked_get_ns = 0

    def register_input(self) -> int:
        idx = self.n_inputs
        self.n_inputs += 1
        return idx

    def put(self, ch_idx: int, msg: Any) -> None:
        with self._not_full:
            if self.closed:
                raise _teardown()
            if len(self._q) >= self.capacity:
                self.puts_blocked += 1
                t0 = time.monotonic_ns()
                while len(self._q) >= self.capacity:
                    self._not_full.wait()
                    if self.closed:
                        raise _teardown()
                dt = time.monotonic_ns() - t0
                self.blocked_put_ns += dt
                rec = thread_recorder()
                if rec is not None:
                    rec.event("ch_put_blocked", dt / 1e3)
            self._q.append((ch_idx, msg))
            if len(self._q) > self.depth_max:
                self.depth_max = len(self._q)
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[int, Any]]:
        """Blocking pop; with ``timeout`` (seconds) returns None if the
        channel stays empty that long (the worker's idle tick). The timeout
        is a single deadline: spurious wakeups do not restart it. A closed
        channel still hands out what it holds; empty, it raises."""
        with self._not_empty:
            if not self._q:
                if self.closed:
                    raise _teardown()
                t0 = time.monotonic_ns()
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while not self._q:
                    if self.closed:
                        raise _teardown()
                    if deadline is None:
                        self._not_empty.wait()
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.blocked_get_ns += time.monotonic_ns() - t0
                        return None
                    self._not_empty.wait(remaining)
                dt = time.monotonic_ns() - t0
                self.blocked_get_ns += dt
                # data arrived after a real wait (a timeout returns above
                # without a span: idle waits would flood the ring)
                rec = thread_recorder()
                if rec is not None:
                    rec.event("ch_get_blocked", dt / 1e3)
            item = self._q.popleft()
            self._not_full.notify()
            return item

    def close(self) -> None:
        """Poison the channel (supervised teardown): every blocked and
        future put/get raises ``SupervisorTeardown``; buffered messages
        still drain through ``get``. Idempotent."""
        with self._lock:
            self.closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class Port:
    """Destination of an emitter edge."""

    __slots__ = ()

    def send(self, msg: Any) -> None:
        raise NotImplementedError

    def send_eos(self) -> None:
        raise NotImplementedError


class QueuePort(Port):
    """Edge to a replica running in another thread."""

    __slots__ = ("channel", "ch_idx")

    def __init__(self, channel: Channel) -> None:
        self.channel = channel
        self.ch_idx = channel.register_input()

    def send(self, msg: Any) -> None:
        self.channel.put(self.ch_idx, msg)

    def send_eos(self) -> None:
        self.channel.put(self.ch_idx, EOS_SENTINEL)


class InlinePort(Port):
    """Edge to a replica chained in the same thread: ``send`` calls the
    downstream replica's message handler directly."""

    __slots__ = ("node",)

    def __init__(self, node: Any) -> None:
        self.node = node

    def send(self, msg: Any) -> None:
        self.node.handle_msg(0, msg)

    def send_eos(self) -> None:
        # EOS through a chain is driven by the worker's termination cascade
        pass
