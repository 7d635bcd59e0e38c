"""Collectors: the routing plane on the consumer side.

Trimmed copy of ``windflow_tpu/runtime/collectors.py``: the port runs
DEFAULT mode only, so the one collector is ``WatermarkCollector``
(per-input-channel max watermark; outgoing watermark = min over still-open
channels, ``wf/watermark_collector.hpp:65-80``), fused in front of the
first replica of a stage with several input channels.
"""

from __future__ import annotations

import threading
from typing import Any


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
