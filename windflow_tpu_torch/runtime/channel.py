"""Bounded channels and ports connecting replicas.

Copy of ``windflow_tpu/runtime/channel.py`` without the flight-recorder
spans: every consumer worker owns one bounded MPSC ``Channel`` that
merges its input edges (like FastFlow's ``ff_minode``); each producer
edge is a ``QueuePort`` stamping the consumer-side channel index; chained
stages talk through ``InlinePort``. A channel counts the time producers
spend blocked on it when full and its consumer when empty (the
autoscaler's backpressure and starvation signals), and ``close()``
poisons it for a supervised teardown.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional, Tuple

from ..basic import DEFAULT_BUFFER_CAPACITY, SupervisorTeardown
from ..message import EOS_SENTINEL


def _teardown() -> SupervisorTeardown:
    return SupervisorTeardown(
        "channel closed: the supervisor is rebuilding the runtime plane")


class Channel:
    """Bounded blocking MPSC queue of ``(channel_idx, msg)`` pairs."""

    __slots__ = ("_q", "_lock", "_not_empty", "_not_full", "capacity",
                 "n_inputs", "depth_max", "blocked_put_ns",
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
                t0 = time.monotonic_ns()
                while len(self._q) >= self.capacity:
                    self._not_full.wait()
                    if self.closed:
                        raise _teardown()
                self.blocked_put_ns += time.monotonic_ns() - t0
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
                self.blocked_get_ns += time.monotonic_ns() - t0
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
