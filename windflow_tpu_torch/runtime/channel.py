"""Bounded channels and ports connecting replicas.

Copy of ``windflow_tpu/runtime/channel.py`` without the supervised-teardown
poisoning and the flight-recorder spans: every consumer worker owns one
bounded MPSC ``Channel`` that merges its input edges (like FastFlow's
``ff_minode``); each producer edge is a ``QueuePort`` stamping the
consumer-side channel index; chained stages talk through ``InlinePort``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Optional, Tuple

from ..basic import DEFAULT_BUFFER_CAPACITY
from ..message import EOS_SENTINEL


class Channel:
    """Bounded blocking MPSC queue of ``(channel_idx, msg)`` pairs."""

    __slots__ = ("_q", "_lock", "_not_empty", "_not_full", "capacity",
                 "n_inputs", "depth_max")

    def __init__(self, capacity: int = DEFAULT_BUFFER_CAPACITY) -> None:
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self.capacity = capacity
        self.n_inputs = 0  # number of producer edges; assigned at wiring
        self.depth_max = 0

    def register_input(self) -> int:
        idx = self.n_inputs
        self.n_inputs += 1
        return idx

    def put(self, ch_idx: int, msg: Any) -> None:
        with self._not_full:
            while len(self._q) >= self.capacity:
                self._not_full.wait()
            self._q.append((ch_idx, msg))
            if len(self._q) > self.depth_max:
                self.depth_max = len(self._q)
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[int, Any]]:
        """Blocking pop; with ``timeout`` (seconds) returns None if the
        channel stays empty that long (the worker's idle tick). The timeout
        is a single deadline: spurious wakeups do not restart it."""
        with self._not_empty:
            if timeout is None:
                while not self._q:
                    self._not_empty.wait()
            else:
                deadline = time.monotonic() + timeout
                while not self._q:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._not_empty.wait(remaining)
            item = self._q.popleft()
            self._not_full.notify()
            return item

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
