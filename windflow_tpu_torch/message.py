"""Stream messages: Single (one tuple) and Batch (micro-batch of tuples).

Copy of ``windflow_tpu/message.py`` without the latency-tracing stamps. ``Single`` mirrors ``wf/single_t.hpp:50-197``;
``Batch`` mirrors ``wf/batch_cpu_t.hpp:51-221`` (watermark = min over its
constituents). Device batches live in ``windflow_tpu_torch.gpu.batch``
and share the same metadata protocol.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple


class StreamMsg:
    """Common metadata protocol for everything traveling on a channel."""

    __slots__ = ()

    is_punct = False

    def min_watermark(self) -> int:
        raise NotImplementedError


class Single(StreamMsg):
    __slots__ = ("payload", "id", "ts", "wm", "is_punct", "stream_tag")

    def __init__(self, payload: Any, id: int = 0, ts: int = 0, wm: int = 0,
                 is_punct: bool = False, stream_tag: int = 0) -> None:
        self.payload = payload
        self.id = id
        self.ts = ts
        self.wm = wm
        self.is_punct = is_punct
        self.stream_tag = stream_tag

    def min_watermark(self) -> int:
        return self.wm

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.is_punct:
            return f"<Punct wm={self.wm}>"
        return (f"<Single {self.payload!r} id={self.id} ts={self.ts} "
                f"wm={self.wm}>")


def make_punctuation(wm: int, stream_tag: int = 0) -> Single:
    """Watermark punctuation: no payload, only a watermark."""
    return Single(None, 0, 0, wm, True, stream_tag)


class Batch(StreamMsg):
    """Row-major CPU micro-batch. ``rows`` is a list of ``(payload, ts)``."""

    __slots__ = ("rows", "wm", "is_punct", "stream_tag", "id")

    def __init__(self, rows: Optional[List[Tuple[Any, int]]] = None,
                 wm: int = 0, is_punct: bool = False,
                 stream_tag: int = 0) -> None:
        self.rows = rows if rows is not None else []
        self.wm = wm
        self.is_punct = is_punct
        self.stream_tag = stream_tag
        self.id = 0

    def add_tuple(self, payload: Any, ts: int, wm: int) -> None:
        if not self.rows or wm < self.wm:
            self.wm = wm
        self.rows.append((payload, ts))

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def size(self) -> int:
        return len(self.rows)

    def min_watermark(self) -> int:
        return self.wm

    def copy_for_dest(self) -> "Batch":
        """Broadcast copy: its own row list, shared payload objects."""
        return Batch(list(self.rows), self.wm, self.is_punct, self.stream_tag)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<Batch n={len(self.rows)} wm={self.wm}>"


class Barrier(StreamMsg):
    """Aligned-checkpoint barrier (a Chandy-Lamport marker, Flink-style).

    Injected by a source replica when the ``CheckpointCoordinator`` opens
    an epoch, and forwarded one per producer -> consumer edge (like EOS,
    unlike punctuations it is never merged or reordered): every tuple sent
    before the barrier on a channel belongs to checkpoint ``ckpt_id``,
    every tuple after it does not. A worker with several input channels
    aligns the barriers (``runtime/collectors.py:BarrierAligner``) before
    it snapshots; barriers never reach collectors or replicas."""

    __slots__ = ("ckpt_id", "stream_tag")

    def __init__(self, ckpt_id: int, stream_tag: int = 0) -> None:
        self.ckpt_id = ckpt_id
        self.stream_tag = stream_tag

    def min_watermark(self) -> int:
        return 0

    def copy_for_dest(self) -> "Barrier":
        return Barrier(self.ckpt_id, self.stream_tag)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<Barrier ckpt={self.ckpt_id}>"


class EOS:
    """End-of-stream sentinel; one is sent per producer->consumer edge."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<EOS>"


EOS_SENTINEL = EOS()
