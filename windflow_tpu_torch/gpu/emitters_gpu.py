"""Device-plane edge emitters (reference ``wf/forward_emitter_gpu.hpp`` /
``wf/keyby_emitter_gpu.hpp``, template cases <inputGPU, outputGPU>).

The port of ``windflow_tpu/tpu/emitters_tpu.py``'s main-path edges:

- ``GPUStageEmitter`` (CPU -> device): rows or column blocks accumulate in
  page-locked staging tensors (plain host tensors for ``device="cpu"``)
  filled in place, and ship as one ``BatchGPU`` per ``output_batch_size``
  tuples with a ``non_blocking`` H2D copy. KEYBY routing keeps one staging
  buffer per destination (vectorized modulo routing for non-negative int
  key columns). A partial batch older than ``MAX_STAGING_MS``
  (25 ms) ships on the next append or idle tick.
- ``GPUForwardEmitter`` (device -> device): whole batches round-robin.
- ``GPUExitEmitter`` / ``GPUColumnarExitEmitter`` (device -> CPU): the
  D2H is pipelined (``_D2HPipeline``): an arriving batch starts its
  asynchronous copies into pinned memory and enters a FIFO; it is
  delivered when later batches push it out, at punctuation/flush/EOS, or
  on the worker's idle tick.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import ExecutionMode, WindFlowError
from ..runtime.emitters import BasicEmitter
from .batch import BatchGPU, bucket_capacity, host_buffer
from .schema import TupleSchema

# a partial staging batch older than this ships on the next append or tick
MAX_STAGING_MS = 25.0
# exit D2H pipeline: batches in flight, and the age that forces delivery
EXIT_PIPELINE_DEPTH = 4
PIPELINE_MAX_AGE_MS = 100.0


def _dest_of_key(key, num_dests: int) -> int:
    return hash(key) % num_dests


def _block_dests(kcol: np.ndarray, num_dests: int) -> np.ndarray:
    """KEYBY destinations of a key column: ``key % n`` where that equals
    the per-row ``hash(key) % n`` (non-negative ints), else per row."""
    if kcol.dtype.kind in "iub" and (len(kcol) == 0 or kcol.min() >= 0):
        return kcol.astype(np.int64) % num_dests
    return np.fromiter((_dest_of_key(k, num_dests) for k in kcol.tolist()),
                       dtype=np.int64, count=len(kcol))


class GPUStageEmitter(BasicEmitter):
    """CPU -> device staging. Routing: ``forward`` round-robins full
    batches, ``keyby`` partitions rows by key."""

    def __init__(self, num_dests: int, output_batch_size: int,
                 schema: Optional[TupleSchema],
                 key_extractor: Optional[Callable],
                 routing: str, execution_mode: ExecutionMode,
                 key_field: Optional[str], device: torch.device) -> None:
        super().__init__(num_dests, output_batch_size, execution_mode)
        if routing not in ("forward", "keyby"):
            raise WindFlowError(f"{routing} routing onto a device operator "
                                "is not yet ported")
        self.schema = schema
        self.key_extractor = key_extractor
        self.key_field = key_field
        self.routing = routing
        self.device = device
        n_bufs = num_dests if routing == "keyby" else 1
        self._rows: List[list] = [[] for _ in range(n_bufs)]
        self._keys: List[list] = [[] for _ in range(n_bufs)]
        self._wms: List[int] = [0] * n_bufs
        # block staging: per-destination host tensors filled in place
        self._cbuf: List[Optional[Dict[str, torch.Tensor]]] = [None] * n_bufs
        self._cnp: List[Optional[Dict[str, np.ndarray]]] = [None] * n_bufs
        self._cts: List[Optional[np.ndarray]] = [None] * n_bufs
        self._ckparts: List[list] = [[] for _ in range(n_bufs)]
        self._ccount: List[int] = [0] * n_bufs
        self._rr = 0
        self._stage_age_s = MAX_STAGING_MS / 1e3
        self._first_append: List[Optional[float]] = [None] * n_bufs

    # -- row path ----------------------------------------------------------
    def emit(self, payload: Any, ts: int, wm: int) -> None:
        if self.schema is None:
            self.schema = TupleSchema.infer(payload)
        key = (self.key_extractor(payload)
               if self.key_extractor is not None else None)
        buf = (_dest_of_key(key, self.num_dests)
               if self.routing == "keyby" else 0)
        if self._ccount[buf]:
            self._ship(buf)  # block-staged partials precede this row
        rows = self._rows[buf]
        if not rows:
            self._wms[buf] = wm
            self._first_append[buf] = time.monotonic()
        elif wm < self._wms[buf]:
            self._wms[buf] = wm
        rows.append((payload, ts))
        if self.key_extractor is not None:
            self._keys[buf].append(key)
        if len(rows) >= self.output_batch_size:
            self._ship(buf)
        self._ship_aged()
        self._maybe_generate_punctuation(wm)

    def _ship_aged(self) -> bool:
        """Ship partial batches older than the staging bound."""
        now = time.monotonic()
        did = False
        for b, t0 in enumerate(self._first_append):
            if t0 is not None and now - t0 >= self._stage_age_s:
                self._ship(b)
                did = True
        return did

    def on_idle(self) -> bool:
        return self._ship_aged()

    def _ship(self, buf: int) -> None:
        if self._ccount[buf]:
            self._ship_cbuf(buf)
        rows = self._rows[buf]
        if not rows:
            return
        keys = self._keys[buf] if self.key_extractor is not None else None
        cap = bucket_capacity(max(self.output_batch_size, len(rows)))
        batch = BatchGPU.stage_rows(rows, self.schema, self._wms[buf],
                                    self.device, keys, cap)
        self._rows[buf] = []
        self._keys[buf] = []
        self._dispatch_batch(buf, batch, len(rows))

    def _ship_cbuf(self, buf: int) -> None:
        """Ship a block-staged buffer (already padded and filled in
        place): concatenate the key parts and issue the H2D copies.
        Ownership of the staging tensors moves to the batch."""
        n = self._ccount[buf]
        kparts = self._ckparts[buf]
        keys = None
        if kparts:
            keys = kparts[0] if len(kparts) == 1 else np.concatenate(kparts)
        batch = BatchGPU.stage_prefilled(
            self._cbuf[buf], self._cts[buf], n, self.schema,
            self._wms[buf], self.device, keys)
        self._cbuf[buf] = self._cnp[buf] = self._cts[buf] = None
        self._ckparts[buf] = []
        self._ccount[buf] = 0
        self._dispatch_batch(buf, batch, n)

    def _dispatch_batch(self, buf: int, batch: BatchGPU, n: int) -> None:
        if self.stats is not None:
            self.stats.outputs_sent += n
            self.stats.device_bytes_h2d += batch.nbytes()
        self._first_append[buf] = None
        dest = buf if self.routing == "keyby" else self._rr
        batch.id = self._next_ids[dest]
        self._next_ids[dest] += 1
        self.ports[dest].send(batch)
        if self.routing != "keyby":
            self._rr = (self._rr + 1) % self.num_dests

    def flush(self) -> None:
        for buf in range(len(self._rows)):
            self._ship(buf)

    # -- columnar path -------------------------------------------------------
    def emit_columns(self, cols, ts_arr, wm: int) -> None:
        if self.routing == "keyby" and self.key_field is None:
            # a callable key extractor has no column to route by
            return super().emit_columns(cols, ts_arr, wm)
        n = len(ts_arr)
        if n == 0:
            return
        if self.schema is None:
            self.schema = TupleSchema(
                {k: np.asarray(v).dtype for k, v in cols.items()})
        if self.routing == "keyby":
            kcol = np.asarray(cols[self.key_field])
            if self.num_dests == 1:
                self._append_part(0, cols, ts_arr, np.array(kcol), wm)
            else:
                dests = _block_dests(kcol, self.num_dests)
                order = np.argsort(dests, kind="stable")
                counts = np.bincount(dests, minlength=self.num_dests)
                scols = {k: np.asarray(v)[order] for k, v in cols.items()}
                sts, skeys = ts_arr[order], kcol[order]
                off = 0
                for d in range(self.num_dests):
                    c = int(counts[d])
                    if c:
                        sl = slice(off, off + c)
                        self._append_part(
                            d, {k: v[sl] for k, v in scols.items()},
                            sts[sl], skeys[sl], wm)
                    off += c
        else:
            keys = (np.array(cols[self.key_field])
                    if self.key_field is not None else None)
            self._append_part(0, cols, ts_arr, keys, wm)
        self._ship_aged()
        self._emit_count += max(0, n - 1)  # punctuation cadence is per tuple
        self._maybe_generate_punctuation(wm)

    def _append_part(self, buf: int, pcols, pts, pkeys, wm: int) -> None:
        """Copy one destination's slice of a column block into its staging
        buffer, shipping whenever the buffer reaches the output batch
        size (the single host copy per column happens here, so callers may
        reuse their arrays)."""
        if self._rows[buf]:
            self._ship(buf)  # row-staged partials precede this block
        n = len(pts)
        obs = self.output_batch_size
        cap = bucket_capacity(obs if obs > 0 else n)
        size = obs if obs > 0 else n
        names = list(self.schema.fields)
        off = 0
        while off < n:
            if self._cbuf[buf] is None:
                self._cbuf[buf] = {
                    nm: host_buffer(dt, cap, self.device)
                    for nm, dt in self.schema.fields.items()}
                self._cnp[buf] = {nm: t.numpy()
                                  for nm, t in self._cbuf[buf].items()}
                self._cts[buf] = np.zeros(cap, dtype=np.int64)
            cnt = self._ccount[buf]
            if cnt == 0:
                self._wms[buf] = wm
                self._first_append[buf] = time.monotonic()
            elif wm < self._wms[buf]:
                self._wms[buf] = wm
            take = min(n - off, size - cnt)
            end = off + take
            cnp = self._cnp[buf]
            for nm in names:
                cnp[nm][cnt:cnt + take] = pcols[nm][off:end]
            self._cts[buf][cnt:cnt + take] = pts[off:end]
            if pkeys is not None:
                self._ckparts[buf].append(pkeys[off:end])
            self._ccount[buf] = cnt + take
            off = end
            if cnt + take >= size:
                self._ship_cbuf(buf)


class GPUForwardEmitter(BasicEmitter):
    """Device -> device forward: whole batches round-robin."""

    def emit_device_batch(self, batch: BatchGPU) -> None:
        d = getattr(self, "_rr", 0)
        batch.id = self._next_ids[d]
        self._next_ids[d] += 1
        if self.stats is not None:
            self.stats.outputs_sent += batch.size
        self.ports[d].send(batch)
        self._rr = (d + 1) % self.num_dests


class _D2HPipeline:
    """FIFO of device batches with asynchronous host copies in flight
    (default ``EXIT_PIPELINE_DEPTH`` = 4; 0 = synchronous). An entry is
    delivered when a later batch pushes it out, when it is older than
    ``PIPELINE_MAX_AGE_MS`` (100 ms), or at a drain point."""

    def _pipe_init(self, depth: Optional[int] = None) -> None:
        self.depth = EXIT_PIPELINE_DEPTH if depth is None else depth
        self._max_age_s = PIPELINE_MAX_AGE_MS / 1e3
        self._pending: "deque[Tuple[float, BatchGPU]]" = deque()

    def _pipe_process(self, batch: BatchGPU) -> None:
        raise NotImplementedError

    def _pipe_add(self, batch: BatchGPU) -> None:
        batch.prefetch_host()
        self._pending.append((time.monotonic(), batch))
        stats = getattr(self, "stats", None)
        if stats is not None:
            stats.note_pipe_depth(len(self._pending))
        while len(self._pending) > self.depth:
            self._pipe_process(self._pending.popleft()[1])
        horizon = time.monotonic() - self._max_age_s
        while self._pending and self._pending[0][0] < horizon:
            self._pipe_process(self._pending.popleft()[1])

    def _drain(self) -> None:
        while self._pending:
            self._pipe_process(self._pending.popleft()[1])

    def on_idle(self) -> bool:
        had = bool(self._pending)
        self._drain()
        return had


class GPUColumnarExitEmitter(BasicEmitter, _D2HPipeline):
    """Device -> columnar CPU sink: whole batches flow to the sink
    replica, which reads each column once (no row boxing)."""

    def __init__(self, num_dests: int,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT,
                 depth: Optional[int] = None) -> None:
        super().__init__(num_dests, 0, execution_mode)
        self._pipe_init(depth=depth)
        self._rr = 0

    def emit_device_batch(self, batch: BatchGPU) -> None:
        self._pipe_add(batch)

    def _pipe_process(self, batch: BatchGPU) -> None:
        if self.stats is not None:
            self.stats.device_bytes_d2h += batch.nbytes()
        self._send_batch(self._rr, batch)
        self._rr = (self._rr + 1) % self.num_dests

    def flush(self) -> None:
        self._drain()
        super().flush()


class GPUExitEmitter(BasicEmitter, _D2HPipeline):
    """Device -> CPU rows: D2H the batch, then route its rows through a
    wrapped CPU emitter (which owns the real ports and batching policy)."""

    def __init__(self, inner: BasicEmitter,
                 depth: Optional[int] = None) -> None:
        super().__init__(inner.num_dests, inner.output_batch_size,
                         inner.execution_mode)
        self.inner = inner
        self._pipe_init(depth=depth)

    def set_ports(self, ports) -> None:
        self.inner.set_ports(ports)
        self.ports = self.inner.ports

    def set_stats(self, stats) -> None:
        self.stats = stats
        self.inner.stats = stats

    def _pipe_process(self, batch: BatchGPU) -> None:
        if self.stats is not None:
            self.stats.device_bytes_d2h += batch.nbytes()
        for payload, ts in batch.to_rows():
            self.inner.emit(payload, ts, batch.wm)

    def emit_device_batch(self, batch: BatchGPU) -> None:
        self._pipe_add(batch)

    def emit(self, payload: Any, ts: int, wm: int) -> None:
        self._drain()  # single-row emits must not overtake queued batches
        self.inner.emit(payload, ts, wm)

    def propagate_punctuation(self, wm: int) -> None:
        self._drain()  # rows behind the punctuation carry older watermarks
        self.inner.propagate_punctuation(wm)

    def flush(self) -> None:
        self._drain()
        self.inner.flush()

    def send_eos_all(self) -> None:
        self._drain()
        self.inner.send_eos_all()

    def eos_ports(self):
        return self.inner.eos_ports()
