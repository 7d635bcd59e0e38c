"""Device-plane edge emitters (reference ``wf/forward_emitter_gpu.hpp`` /
``wf/keyby_emitter_gpu.hpp`` / ``wf/broadcast_emitter_gpu.hpp``, template
cases <inputGPU, outputGPU>).

The port of ``windflow_tpu/tpu/emitters_tpu.py``:

- ``GPUStageEmitter`` (CPU -> device): rows or column blocks accumulate in
  page-locked staging tensors (plain host tensors for ``device="cpu"``)
  filled in place, and ship as one ``BatchGPU`` per ``output_batch_size``
  tuples with a ``non_blocking`` H2D copy. KEYBY routing keeps one staging
  buffer per destination (``routing.key_dests``); BROADCAST ships the
  batch to every destination, sharing its device columns. A partial batch
  older than ``MAX_STAGING_MS`` (25 ms) is due to ship; like the
  punctuation cadence it waits for a watermark step (it ships just before
  the first push whose watermark differs from the newest in it). At a
  lull no push comes, and the idle tick ships it once the backstop,
  ``TIMER_CUT_BACKSTOP_USEC``, has passed since it fell due: the rows left
  at a lull wait that long (``runtime/emitters.py``: that backstop is the
  one scheduling dependence of the cuts). On a card the staging tensors
  come from the emitter's pool and return to it once the event after
  their copies has fired (``recycling.py``; ``Staging_pool_hits`` /
  ``_misses``). Each staged batch leaves a ``host_prep`` span in the
  flight recorder, as in the JAX package.
- ``GPUForwardEmitter`` / ``GPUBroadcastEmitter`` (device -> device):
  whole batches round-robin, or one to every destination (sharing the
  columns). A keyed consumer's key column starts its copy to the host
  here, so the consumer's read does not wait for a fresh D2H.
- ``GPUKeyByEmitter`` (device -> device, KEYBY): per-destination
  sub-batches gathered on the device by host-built index vectors
  (``gather_sub_batch``). A batch without host keys reads its key column
  back through the D2H FIFO below first.
- ``GPUExitEmitter`` / ``GPUColumnarExitEmitter`` (device -> CPU): the
  D2H is pipelined (``_D2HPipeline``): an arriving batch starts its
  asynchronous copies into pinned memory and enters a FIFO; it is
  delivered when later batches push it out, at punctuation/flush/EOS, or
  on the worker's idle tick.
- ``GPUSplittingEmitter`` (``MultiPipe.split`` after a device operator):
  the branch of each row is decided on the host — from ONE column read
  back when the split logic names a field, else from the rows — and each
  branch gets a device gather of its rows through its own edge emitter.

A composite key (``with_key_by(("a", "b"))``) travels as a structured
host column: the staging edge stacks the key fields of each block
(``routing._stack_key_fields``), and a keyed re-shard of a batch without
host keys reads the key field columns back
(``composite_keys_from_device``).

Barriers: every emitter that holds batches in a D2H pipeline delivers
them before a checkpoint barrier goes out (``send_barrier_all``), so no
pre-barrier row lands behind the barrier.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import ExecutionMode, WindFlowError
from ..recycling import ArrayPool, InFlightRecycler
from ..runtime.emitters import (BasicEmitter, SplittingEmitter,
                                check_branch_index)
from .batch import (BatchGPU, bucket_capacity, host_buffer, key_column_np,
                    to_device)
from .routing import _dest_of_key, _stack_key_fields, key_dests
from .schema import TupleSchema

# a partial staging batch older than this ships at the next watermark step
MAX_STAGING_MS = 25.0
# D2H pipelines: batches in flight at an exit and at a keyed re-shard, and
# the age that forces delivery
EXIT_PIPELINE_DEPTH = 4
KEYBY_PIPELINE_DEPTH = 2
SPLIT_PIPELINE_DEPTH = 2
PIPELINE_MAX_AGE_MS = 100.0


class GPUStageEmitter(BasicEmitter):
    """CPU -> device staging. Routing: ``forward`` round-robins full
    batches, ``keyby`` partitions rows by key, ``broadcast`` ships every
    batch to every destination."""

    def __init__(self, num_dests: int, output_batch_size: int,
                 schema: Optional[TupleSchema],
                 key_extractor: Optional[Callable],
                 routing: str, execution_mode: ExecutionMode,
                 key_field: Optional[str], device: torch.device,
                 key_fields: Optional[Tuple[str, ...]] = None) -> None:
        super().__init__(num_dests, output_batch_size, execution_mode)
        self.schema = schema
        self.key_extractor = key_extractor
        self.key_field = key_field  # string extractor: the key column
        self.key_fields = key_fields  # composite: stacked key columns
        self.routing = routing
        self.device = device
        n_bufs = num_dests if routing == "keyby" else 1
        self._rows: List[list] = [[] for _ in range(n_bufs)]
        self._keys: List[list] = [[] for _ in range(n_bufs)]
        self._wms: List[int] = [0] * n_bufs  # lowest watermark of a buffer
        self._wm_new: List[int] = [0] * n_bufs  # and its newest
        # block staging: per-destination host tensors filled in place
        self._cbuf: List[Optional[Dict[str, torch.Tensor]]] = [None] * n_bufs
        self._cnp: List[Optional[Dict[str, np.ndarray]]] = [None] * n_bufs
        self._cts: List[Optional[np.ndarray]] = [None] * n_bufs
        self._ckparts: List[list] = [[] for _ in range(n_bufs)]
        self._ccount: List[int] = [0] * n_bufs
        self._rr = 0
        self._stage_age_s = MAX_STAGING_MS / 1e3
        self._first_append: List[Optional[float]] = [None] * n_bufs
        # per-buffer min/max origin stamps of traced rows (latency tracing)
        self._trace_lo: List[int] = [0] * n_bufs
        self._trace_hi: List[int] = [0] * n_bufs
        # the native staging encoders (on unless a comparison run sets
        # PipeGraph._native_encoders to False)
        self.native = False
        # staging-buffer recycling over the asynchronous H2D copies (the
        # reference's per-emitter pools and in-transit counters,
        # recycling_gpu.hpp); off on the CPU
        self.recycler = InFlightRecycler(
            ArrayPool(alloc=lambda dt, cap: host_buffer(dt, cap, device)),
            device=device)
        self._pool_seen = (0, 0)  # (hits, misses) already in the stats

    def _update_pool_stats(self) -> None:
        """Add the pool's counter DELTAS: emitters of several split
        branches may share one stats record."""
        p = self.recycler.pool
        h0, m0 = self._pool_seen
        self.stats.staging_pool_hits += p.hits - h0
        self.stats.staging_pool_misses += p.misses - m0
        self._pool_seen = (p.hits, p.misses)

    # -- row path ----------------------------------------------------------
    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        if self._held:
            self._release_held(wm)
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
        self._wm_new[buf] = wm
        rows.append((payload, ts))
        if self.trace_ts:  # traced row: fold its stamp into the buffer
            self._fold_trace(buf, self.trace_ts)
            self.trace_ts = 0
        if self.key_extractor is not None:
            self._keys[buf].append(key)
        if len(rows) >= self.output_batch_size:
            self._ship(buf)
        self._ship_aged()
        self._maybe_generate_punctuation(wm)

    def _fold_trace(self, buf: int, t0: int) -> None:
        if self._trace_lo[buf] == 0 or t0 < self._trace_lo[buf]:
            self._trace_lo[buf] = t0
        if t0 > self._trace_hi[buf]:
            self._trace_hi[buf] = t0

    def _ship_aged(self) -> bool:
        """A partial batch older than the staging bound falls due and is
        held for a watermark step (``BasicEmitter._release_held``); held
        cuts past the backstop ship now. Whether one shipped."""
        now = time.monotonic()
        did = False
        if self._held:
            did = self._release_held(None, round(now * 1e6)) > 0
        for b, t0 in enumerate(self._first_append):
            if t0 is not None and now - t0 >= self._stage_age_s \
                    and b not in self._held:
                self._held[b] = (self._wm_new[b], round(now * 1e6))
        return did

    def _ship_held(self, buf: int) -> None:
        self._ship(buf)

    def _holds_rows(self) -> bool:
        return any(self._rows) or any(self._ccount)

    def on_idle(self) -> bool:
        # a held cut is pending work: the worker's idle backoff must not
        # carry its tick past the backstop
        return self._ship_aged() or bool(self._held)

    def prewarm(self, caps) -> None:
        """``PipeGraph.with_prewarm``: fill the staging pool with the
        buffers batch 0 will take (one per field at the emitter's bucket,
        for every in-flight slot), so the first batches pay no pinned
        allocation. Needs the schema (declared) and the pool (a card)."""
        if self.schema is None or not self.recycler.enabled:
            return
        cap = bucket_capacity(max(1, self.output_batch_size))
        pool = self.recycler.pool
        depth = min(pool.max_per_bucket, self.recycler.max_in_flight + 2)
        for dt in self.schema.fields.values():
            bufs = [pool.acquire(dt, cap) for _ in range(depth)]
            for b in bufs:
                pool.release(b)
        self._update_pool_stats()

    def _ship(self, buf: int) -> None:
        if self._ccount[buf]:
            self._ship_cbuf(buf)
        rows = self._rows[buf]
        if not rows:
            return
        rec = self.stats.recorder if self.stats is not None else None
        t0 = time.perf_counter_ns() if rec is not None else 0
        keys = self._keys[buf] if self.key_extractor is not None else None
        cap = bucket_capacity(max(self.output_batch_size, len(rows)))
        batch = BatchGPU.stage_rows(rows, self.schema, self._wms[buf],
                                    self.device, keys, cap, self.recycler,
                                    self.native, self.stats)
        self._rows[buf] = []
        self._keys[buf] = []
        if rec is not None:
            # staging is the source thread's host prep: encode, pad, H2D
            rec.event("host_prep", (time.perf_counter_ns() - t0) / 1e3,
                      len(rows))
        self._dispatch_batch(buf, batch, len(rows))

    def _ship_cbuf(self, buf: int) -> None:
        """Ship a block-staged buffer (already padded and filled in
        place): concatenate the key parts and issue the H2D copies.
        Ownership of the staging tensors moves to the batch."""
        n = self._ccount[buf]
        rec = self.stats.recorder if self.stats is not None else None
        t0 = time.perf_counter_ns() if rec is not None else 0
        kparts = self._ckparts[buf]
        keys = None
        if kparts:
            keys = kparts[0] if len(kparts) == 1 else np.concatenate(kparts)
        batch = BatchGPU.stage_prefilled(
            self._cbuf[buf], self._cts[buf], n, self.schema,
            self._wms[buf], self.device, keys, self.recycler)
        if rec is not None:
            # the buffers were filled in place: key concat and H2D only
            rec.event("host_prep", (time.perf_counter_ns() - t0) / 1e3, n)
        self._cbuf[buf] = self._cnp[buf] = self._cts[buf] = None
        self._ckparts[buf] = []
        self._ccount[buf] = 0
        self._dispatch_batch(buf, batch, n)

    def _dispatch_batch(self, buf: int, batch: BatchGPU, n: int) -> None:
        if self.stats is not None:
            self.stats.outputs_sent += n
            self.stats.device_bytes_h2d += batch.nbytes()
            self._update_pool_stats()
        self._first_append[buf] = None
        self._held.pop(buf, None)
        batch.trace_min = self._trace_lo[buf]
        batch.trace_max = self._trace_hi[buf]
        self._trace_lo[buf] = self._trace_hi[buf] = 0
        if self.routing == "broadcast":
            _send_to_all(self, batch)
            return
        dest = buf if self.routing == "keyby" else self._rr
        batch.id = self._next_ids[dest]
        self._next_ids[dest] += 1
        self.ports[dest].send(batch)
        if self.routing != "keyby":
            self._rr = (self._rr + 1) % self.num_dests

    def flush(self) -> None:
        for buf in range(len(self._rows)):
            self._ship(buf)

    def send_eos_all(self) -> None:
        super().send_eos_all()
        # every tracked staging buffer back to the pool. Only here: the
        # JAX package drains at every flush (punctuation too), but the
        # release events sit on the card's shared stream, so a drain
        # waits for all the work queued before them
        self.recycler.drain()

    # -- columnar path -------------------------------------------------------
    def _key_column(self, cols, n: int) -> Optional[np.ndarray]:
        """The block's key column: the key field (copied: the caller may
        reuse its arrays), the stacked fields of a composite key, or None
        without a field-name extractor."""
        if self.key_field is not None:
            return np.array(cols[self.key_field])
        if self.key_fields is not None:
            return _stack_key_fields(cols, self.key_fields, n)
        return None

    def emit_columns(self, cols, ts_arr, wm: int, trace_rows=None) -> None:
        if self.routing == "keyby" and self.key_field is None \
                and self.key_fields is None:
            # a callable key extractor has no column to route by
            return super().emit_columns(cols, ts_arr, wm, trace_rows)
        n = len(ts_arr)
        if n == 0:
            return
        if self._held:
            self._release_held(wm)
        # the traced rows of the block: a destination's buffer folds the
        # block's stamp iff one of ITS rows is traced
        t_trace = self.trace_ts
        self.trace_ts = 0
        tmask = None
        if t_trace and trace_rows is not None and len(trace_rows):
            tmask = np.zeros(n, dtype=bool)
            tmask[trace_rows] = True
        elif t_trace:
            t_trace = 0
        if self.schema is None:
            self.schema = TupleSchema(
                {k: np.asarray(v).dtype for k, v in cols.items()})
        if self.routing == "keyby":
            kcol = self._key_column(cols, n)
            if self.num_dests == 1:
                self._append_part(0, cols, ts_arr, kcol, wm, t_trace, tmask)
            else:
                dests = key_dests(kcol, n, self.num_dests)
                order = np.argsort(dests, kind="stable")
                counts = np.bincount(dests, minlength=self.num_dests)
                scols = {k: np.asarray(v)[order] for k, v in cols.items()}
                sts, skeys = ts_arr[order], kcol[order]
                smask = tmask[order] if tmask is not None else None
                off = 0
                for d in range(self.num_dests):
                    c = int(counts[d])
                    if c:
                        sl = slice(off, off + c)
                        self._append_part(
                            d, {k: v[sl] for k, v in scols.items()},
                            sts[sl], skeys[sl], wm, t_trace,
                            smask[sl] if smask is not None else None)
                    off += c
        else:
            self._append_part(0, cols, ts_arr, self._key_column(cols, n),
                              wm, t_trace, tmask)
        self._ship_aged()
        self._emit_count += max(0, n - 1)  # punctuation cadence is per tuple
        self._maybe_generate_punctuation(wm)

    def _append_part(self, buf: int, pcols, pts, pkeys, wm: int,
                     t_trace: int = 0, tmask=None) -> None:
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
                pool = self.recycler.pool if self.recycler.enabled else None
                self._cbuf[buf] = {
                    nm: (pool.acquire(dt, cap) if pool is not None
                         else host_buffer(dt, cap, self.device))
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
            self._wm_new[buf] = wm
            take = min(n - off, size - cnt)
            end = off + take
            cnp = self._cnp[buf]
            for nm in names:
                cnp[nm][cnt:cnt + take] = pcols[nm][off:end]
            self._cts[buf][cnt:cnt + take] = pts[off:end]
            if pkeys is not None:
                self._ckparts[buf].append(pkeys[off:end])
            if t_trace and (tmask is None or tmask[off:end].any()):
                self._fold_trace(buf, t_trace)
            self._ccount[buf] = cnt + take
            off = end
            if cnt + take >= size:
                self._ship_cbuf(buf)


def _prefetch_key(batch: BatchGPU, field: Optional[str]) -> None:
    """Start the D2H of the key column a keyed device consumer will read
    (the batch has no host keys: its key was computed on the device)."""
    if field is not None and batch.host_keys is None \
            and field in batch.fields:
        batch.prefetch_host((field,))


class GPUForwardEmitter(BasicEmitter):
    """Device -> device forward: whole batches round-robin.
    ``prefetch_field`` (set by the graph wiring) names the consumer's key
    column."""

    prefetch_field: Optional[str] = None

    def emit_device_batch(self, batch: BatchGPU) -> None:
        _prefetch_key(batch, self.prefetch_field)
        d = getattr(self, "_rr", 0)
        batch.id = self._next_ids[d]
        self._next_ids[d] += 1
        if self.stats is not None:
            self.stats.outputs_sent += batch.size
        self.ports[d].send(batch)
        self._rr = (d + 1) % self.num_dests


def _send_to_all(em: BasicEmitter, batch: BatchGPU) -> None:
    """Broadcast: every destination gets the batch, its device columns
    shared (no operator writes an input column)."""
    for d in range(em.num_dests):
        out = batch.copy_for_dest() if d > 0 else batch
        out.id = em._next_ids[d]
        em._next_ids[d] += 1
        em.ports[d].send(out)


class GPUBroadcastEmitter(BasicEmitter):
    """Device -> device broadcast (see ``_send_to_all``)."""

    prefetch_field: Optional[str] = None

    def emit_device_batch(self, batch: BatchGPU) -> None:
        _prefetch_key(batch, self.prefetch_field)
        if self.stats is not None:
            self.stats.outputs_sent += batch.size * self.num_dests
        _send_to_all(self, batch)


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
        """Queue ``batch``; its host copies are already in flight."""
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
        batch.prefetch_host()
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
        if batch.trace_min:
            # one traced row re-materializes per traced batch: the inner
            # emitter consumes the stamp on its first emit
            self.inner.trace_ts = batch.trace_min
        for payload, ts in batch.to_rows():
            self.inner.emit(payload, ts, batch.wm)
        self.inner.trace_ts = 0

    def emit_device_batch(self, batch: BatchGPU) -> None:
        batch.prefetch_host()
        self._pipe_add(batch)

    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        self._drain()  # single-row emits must not overtake queued batches
        self.inner.emit(payload, ts, wm, msg_id)

    def propagate_punctuation(self, wm: int) -> None:
        self._drain()  # rows behind the punctuation carry older watermarks
        self.inner.propagate_punctuation(wm)

    def flush(self) -> None:
        self._drain()
        self.inner.flush()

    def send_eos_all(self) -> None:
        self._drain()
        self.inner.send_eos_all()

    def send_barrier_all(self, barrier) -> None:
        self._drain()  # pre-barrier rows go out ahead of the barrier
        self.inner.send_barrier_all(barrier)

    def eos_ports(self):
        return self.inner.eos_ports()

    def emitter_state(self) -> dict:
        return self.inner.emitter_state()

    def restore_emitter_state(self, state: dict) -> None:
        self.inner.restore_emitter_state(state)


def gather_sub_batch(batch: BatchGPU, idx: np.ndarray,
                     host_keys=None) -> BatchGPU:
    """The ``idx`` rows of a device batch as a new device batch, gathered
    on the device: one gather per column from a host-built index vector
    (shipped from its own fresh pinned buffer, so a later batch never
    overwrites an index still in flight). Shared by the keyed re-shard
    and the splitting emitter; host keys follow the rows."""
    cap = bucket_capacity(idx.size)
    gather = np.zeros(cap, dtype=np.int32)
    gather[:idx.size] = idx
    gidx = to_device(gather, batch.device)
    if host_keys is None and batch.host_keys is not None:
        hk = batch.host_keys
        host_keys = (hk[idx] if isinstance(hk, np.ndarray)
                     else [hk[j] for j in idx])
    sub = BatchGPU({k: v[gidx] for k, v in batch.fields.items()},
                   batch.ts_host[gather], idx.size, batch.schema, batch.wm,
                   host_keys)
    sub.stream_tag = batch.stream_tag
    return sub.copy_trace_from(batch)


class GPUKeyByEmitter(BasicEmitter, _D2HPipeline):
    """Device -> device keyed re-shard: per-destination sub-batches
    gathered on the device with host-computed index vectors.

    Batches WITHOUT host keys (the key was computed on the device) need
    their key column on the host before routing: they enter the D2H FIFO
    with that column's copy in flight. Batches WITH host keys route at
    once, after the FIFO drains (stream order)."""

    def __init__(self, num_dests: int,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT,
                 key_field: Optional[str] = None,
                 key_fields: Optional[Tuple[str, ...]] = None) -> None:
        super().__init__(num_dests, 0, execution_mode)
        self.key_field = key_field
        self.key_fields = key_fields
        self._pipe_init(depth=KEYBY_PIPELINE_DEPTH)

    def _keys_of(self, batch: BatchGPU):
        if batch.host_keys is not None:
            return batch.host_keys
        if self.key_field is not None:
            return key_column_np(batch, self.key_field)
        if self.key_fields:
            return composite_keys_from_device(batch, self.key_fields)
        raise WindFlowError(
            "a keyed device -> device edge needs host key metadata or a "
            "field-name key extractor (with_key_by('field') or a tuple of "
            "fields)")

    def emit_device_batch(self, batch: BatchGPU) -> None:
        if self.num_dests == 1:
            self._drain()
            _prefetch_key(batch, self.key_field)
            batch.id = self._next_ids[0]
            self._next_ids[0] += 1
            if self.stats is not None:
                self.stats.outputs_sent += batch.size
            self.ports[0].send(batch)
            return
        if batch.host_keys is None and (self.key_field is not None
                                        or self.key_fields):
            for f in ((self.key_field,) if self.key_field is not None
                      else self.key_fields):
                _prefetch_key(batch, f)
            self._pipe_add(batch)
            return
        self._drain()  # keep stream order ahead of an immediate route
        self._pipe_process(batch)

    def flush(self) -> None:
        # propagate_punctuation / send_eos_all call flush() first, so
        # draining here covers every ordering point
        self._drain()
        super().flush()

    def _pipe_process(self, batch: BatchGPU) -> None:
        keys = self._keys_of(batch)
        dests = key_dests(keys, batch.size, self.num_dests)
        for d in range(self.num_dests):
            idx = np.flatnonzero(dests == d)
            if idx.size == 0:
                continue
            sub = gather_sub_batch(
                batch, idx, keys[idx] if isinstance(keys, np.ndarray)
                else [keys[j] for j in idx])
            sub.id = self._next_ids[d]
            self._next_ids[d] += 1
            if self.stats is not None:
                self.stats.outputs_sent += sub.size
            self.ports[d].send(sub)


def composite_keys_from_device(batch: BatchGPU, key_fields) -> np.ndarray:
    """Structured key column for a composite-keyed consumer fed WITHOUT
    host key metadata (an unkeyed device edge upstream): read the key
    field columns back and stack them. The fields must be device columns —
    non-numeric composite members only travel as host metadata from a
    keyed staging edge."""
    for f in key_fields:
        if f not in batch.fields:
            raise WindFlowError(
                f"composite key field {f!r} is not a device column of "
                "this batch; non-numeric composite keys must be keyed at "
                "the staging edge (with_key_by on the operator fed by the "
                "CPU plane), which carries them as host metadata")
    cols = batch.host_columns(tuple(key_fields))
    return _stack_key_fields(cols, key_fields, batch.size)


class GPUSplittingEmitter(SplittingEmitter, _D2HPipeline):
    """Device-plane split (reference ``wf/splitting_emitter_gpu.hpp:48-341``,
    wired at ``wf/multipipe.hpp:698-708``): per-branch sub-batches after a
    device operator. Only the routing decision touches the host; each
    branch receives a device gather of its rows (the keyed re-shard's
    ``gather_sub_batch``) through its own edge emitter.

    ``splitting_logic`` forms:

    - a string field name: that int column holds each row's branch index
      (one column read back, no per-tuple Python); an index outside
      ``[0, n_branches)`` raises;
    - a callable ``payload -> int | iterable[int] | None``: the rows are
      materialized once per batch to evaluate it.

    The read-back is pipelined (``_D2HPipeline``, depth
    ``SPLIT_PIPELINE_DEPTH``); every ordering point — punctuation, flush,
    EOS, a checkpoint barrier — routes what is in flight first, then fans
    out to the branches as the host ``SplittingEmitter`` does."""

    def __init__(self, splitting_logic, inner_emitters: List[BasicEmitter],
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT
                 ) -> None:
        super().__init__(splitting_logic, inner_emitters, execution_mode)
        self._pipe_init(depth=SPLIT_PIPELINE_DEPTH)

    def _branch_rows(self, batch: BatchGPU) -> List[np.ndarray]:
        """Row indices per branch (the host-side routing decision)."""
        n_branches = len(self.inner)
        logic = self.splitting_logic
        if isinstance(logic, str):
            col = batch.host_columns((logic,))[logic][:batch.size]
            if self.stats is not None:
                self.stats.device_bytes_d2h += int(col.nbytes)
            if col.size and (col.min() < 0 or col.max() >= n_branches):
                raise WindFlowError(
                    f"split field {logic!r} holds branch index "
                    f"{int(col.min())}..{int(col.max())} outside "
                    f"[0, {n_branches})")
            return [np.flatnonzero(col == b) for b in range(n_branches)]
        sel: List[list] = [[] for _ in range(n_branches)]
        if self.stats is not None:
            self.stats.device_bytes_d2h += batch.nbytes()
        for i, (payload, _ts) in enumerate(batch.to_rows()):
            s = logic(payload)
            if s is None:
                continue
            if isinstance(s, int):
                sel[check_branch_index(s, n_branches)].append(i)
            else:
                for b in s:
                    sel[check_branch_index(b, n_branches)].append(i)
        return [np.asarray(ix, dtype=np.int64) for ix in sel]

    def _pipe_process(self, batch: BatchGPU) -> None:
        for b, idx in enumerate(self._branch_rows(batch)):
            if idx.size == 0:
                continue
            if idx.size == batch.size:
                # every row selected this branch: no gather (nothing
                # writes a sent batch's columns; copy the wrapper only)
                sub = batch.copy_for_dest()
            else:
                sub = gather_sub_batch(batch, idx)
            self.inner[b].emit_device_batch(sub)

    def emit_device_batch(self, batch: BatchGPU) -> None:
        logic = self.splitting_logic
        batch.prefetch_host((logic,) if isinstance(logic, str) else None)
        self._pipe_add(batch)

    def on_idle(self) -> bool:
        # our routing FIFO first, then the branch emitters' own FIFOs (a
        # device -> host branch nests an exit emitter the worker can't see)
        did = bool(self._pending)
        self._drain()
        for e in self.inner:
            f = getattr(e, "on_idle", None)
            if f is not None:
                did = bool(f()) or did
        return did

    def propagate_punctuation(self, wm: int) -> None:
        self._drain()
        super().propagate_punctuation(wm)

    def flush(self) -> None:
        self._drain()
        super().flush()

    def send_eos_all(self) -> None:
        self._drain()
        super().send_eos_all()

    def send_barrier_all(self, barrier) -> None:
        self._drain()
        super().send_barrier_all(barrier)
