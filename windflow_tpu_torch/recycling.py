"""Staging-buffer recycling.

The port of ``windflow_tpu/recycling.py`` (parity: ``wf/recycling.hpp`` /
``wf/recycling_gpu.hpp``: every reference emitter owns a pool, and
consumers return messages to the producer's pool instead of freeing
them). The allocations that matter on the device boundary are the
staging buffers of the CPU -> device edge, one host buffer per field per
staged batch. On a card they are page-locked tensors, which are costly
to allocate:

- ``ArrayPool`` keeps free lists of host buffers keyed by (dtype,
  capacity); the staging edge (``gpu/emitters_gpu.py:GPUStageEmitter``)
  fills the buffers it acquires in place;
- ``InFlightRecycler`` returns a batch's buffers to the pool once its
  ``non_blocking`` H2D copies have provably read them. The release signal
  is a CUDA event recorded right after the copies
  (``gpu/batch.py:BatchGPU.stage_prefilled``); the recycler keeps a
  bounded FIFO of in-flight batches and releases the oldest one's buffers
  only on the blocking pop past ``max_in_flight``, which waits on its
  event (``event.synchronize()``, where the JAX package waits with
  ``block_until_ready``). At depth N the copy waited on was queued N
  batches ago and has normally landed; when it has not, the stall is the
  backpressure the reference gets from an exhausted pool.
- ``ObjectPool`` is a generic free list.

On ``device="cpu"`` the recycler is off, as the JAX package's is on its
CPU backend: ``torch.from_numpy`` and a CPU ``.to()`` ALIAS the staging
buffer, so a batch's column is the buffer itself and no point ever makes
its reuse safe. ``force=True`` turns it on anyway, for tests of the FIFO
mechanics only. The port reads no ``WF_NO_RECYCLING``: the pool follows
the device.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .basic import WindFlowError
from .runtime import dispatch


def host_view(buf) -> np.ndarray:
    """The numpy view of a pooled buffer (a host tensor or an array)."""
    return buf if isinstance(buf, np.ndarray) else buf.numpy()


def _zeros(dtype, capacity: int) -> np.ndarray:
    return np.zeros(capacity, dtype=dtype)


class ArrayPool:
    """Thread-safe free lists of host buffers keyed by (dtype, capacity).
    ``alloc(dtype, capacity)`` makes a zeroed buffer on a miss (numpy
    arrays by default; the staging edge allocates pinned tensors)."""

    def __init__(self, max_per_bucket: int = 32,
                 alloc: Optional[Callable[[np.dtype, int], Any]] = None
                 ) -> None:
        self._free: Dict[Tuple[str, int], List[Any]] = defaultdict(list)
        self._lock = threading.Lock()
        self._alloc = alloc or _zeros
        self.max_per_bucket = max_per_bucket
        self.hits = 0
        self.misses = 0

    def acquire(self, dtype, capacity: int):
        dt = np.dtype(dtype)
        with self._lock:
            bucket = self._free.get((str(dt), capacity))
            if bucket:
                self.hits += 1
                buf = bucket.pop()
                host_view(buf).fill(0)
                return buf
            self.misses += 1
        return self._alloc(dt, capacity)

    def release(self, buf) -> None:
        view = host_view(buf)
        key = (str(view.dtype), view.shape[0])
        with self._lock:
            bucket = self._free[key]
            if len(bucket) < self.max_per_bucket:
                bucket.append(buf)


class InFlightRecycler:
    """Recycling of staging buffers over asynchronous H2D copies (see the
    module doc): ``track(event, buffers)`` after each staged batch, the
    event recorded after its copies; ``drain()`` at EOS."""

    def __init__(self, pool: ArrayPool, max_in_flight: Optional[int] = None,
                 force: bool = False, device=None) -> None:
        self.pool = pool
        if max_in_flight is None:
            # the consumers' dispatch queues park commits (and the copies
            # queued ahead of their kernels) behind them: stay well deeper
            # than the queue, so the blocking pop lands on copies whose
            # batches have long been processed
            max_in_flight = max(8, 4 * dispatch.DISPATCH_DEPTH)
        self.max_in_flight = max_in_flight
        self.forced = force
        dev = torch.device("cpu" if device is None else device)
        self.enabled = force or dev.type == "cuda"
        self._q: "deque[Tuple[Any, List[Any]]]" = deque()

    def track(self, event, host_buffers) -> None:
        """One staged batch: its copies' release ``event`` and the host
        buffers they read."""
        if not self.enabled:
            return
        if event is None and not self.forced:
            raise WindFlowError(
                "staging recycler: a pooled batch recorded no release "
                "event; its buffers could never be reused safely")
        self._q.append((event, list(host_buffers)))
        while len(self._q) > self.max_in_flight:
            self._release_oldest()

    def _release_oldest(self) -> None:
        event, bufs = self._q.popleft()
        if event is not None:
            event.synchronize()  # the copies have read the buffers
        for b in bufs:
            self.pool.release(b)

    def drain(self) -> None:
        """Release every tracked buffer (blocking; the staging edge drains
        at EOS)."""
        while self._q:
            self._release_oldest()


class ObjectPool:
    """Generic free list for message objects."""

    def __init__(self, factory: Callable[[], Any],
                 reset: Callable[[Any], None], max_size: int = 256) -> None:
        self._factory = factory
        self._reset = reset
        self._free: list = []
        self._lock = threading.Lock()
        self.max_size = max_size

    def acquire(self):
        with self._lock:
            if self._free:
                obj = self._free.pop()
                self._reset(obj)
                return obj
        return self._factory()

    def release(self, obj) -> None:
        with self._lock:
            if len(self._free) < self.max_size:
                self._free.append(obj)
