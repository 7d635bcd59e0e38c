"""BatchGPU: a micro-batch resident in device memory.

The port's twin of ``windflow_tpu/tpu/batch.py:BatchTPU`` and the sibling
of the reference's ``Batch_GPU_t`` (``wf/batch_gpu_t.hpp:51-243``): a dict
of device columns padded to a power-of-two capacity bucket, an explicit
host-side ``size``, host int64 timestamps and host key metadata, with the
CPU batches' message protocol (watermark, punctuation flag, stream tag).

Transfers (in place of ``jax.device_put`` / ``copy_to_host_async``):

- H2D: the staging emitter fills page-locked host tensors in place and
  ``stage_prefilled`` issues ``non_blocking`` copies on the current
  stream. The tensors come from the emitter's staging pool
  (``recycling.py``): a CUDA event recorded right after the copies is
  their release signal, and the ``InFlightRecycler`` hands them out again
  only once it has fired. On ``device="cpu"`` the batch's column IS the
  staging buffer (``torch.from_numpy`` aliases it), so the pool is off:
  the staging emitter hands ownership over and allocates fresh buffers
  for the next batch, and nothing writes to a buffer a batch still
  reads.
- D2H: ``prefetch_host`` starts ``non_blocking`` copies of the columns
  (all, or the ones named: a keyed edge needs only the key) into pinned
  host tensors and records one CUDA event (``host_copies``);
  ``host_columns`` waits on that event only.

A device batch never changes after it is sent: operators build new
columns, and a broadcast shares the same tensors between destinations.
``trace_min`` / ``trace_max`` carry the latency-tracing origin stamps of
its traced rows (0 = none; ``monitoring/tracing.py``): set at staging,
copied by ``with_fields``, and given by the dispatch queue to every batch
a traced batch's commit emits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..message import StreamMsg
from .schema import TupleSchema, torch_dtype


def key_column_to_list(batch: "BatchGPU", field: str) -> list:
    """D2H of the key column as a host list (one C call, no per-item
    boxing loops)."""
    return key_column_np(batch, field).tolist()


def key_column_np(batch: "BatchGPU", field: str) -> np.ndarray:
    """D2H of the key column as the raw numpy array (waits only for the
    key column's copy, started early by a keyed edge's prefetch)."""
    return batch.host_columns((field,))[field][:batch.size]


def host_copies(tensors: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Optional[Any]]:
    """Start the asynchronous D2H of device tensors: each into a fresh
    pinned host tensor (``non_blocking``), then one CUDA event after the
    copies. CPU tensors come back as they are, with no event. The caller
    waits on the event before it reads the host tensors."""
    if all(v.device.type == "cpu" for v in tensors.values()):
        return dict(tensors), None
    host = {}
    for name, v in tensors.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        host[name] = h
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A fresh host array as a device tensor. On a card the copy goes
    through page-locked memory with ``non_blocking``, so it never waits
    for the kernels already queued; on the CPU the tensor aliases the
    array (each caller hands over a freshly built one)."""
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def bucket_capacity(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c <<= 1
    return c


def host_buffer(dtype: np.dtype, capacity: int, device: torch.device
                ) -> torch.Tensor:
    """A zeroed host staging tensor for ``device``: page-locked when the
    batch goes to a CUDA card (required for an asynchronous H2D copy)."""
    return torch.zeros(capacity, dtype=torch_dtype(dtype),
                       pin_memory=device.type == "cuda")


def zero_fields(schema: TupleSchema, capacity: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Zero device columns of ``schema`` at one capacity bucket (what a
    replica's ``prewarm`` runs its device program on: no state, no
    emit)."""
    return {name: torch.zeros(capacity, dtype=torch_dtype(dt),
                              device=device)
            for name, dt in schema.fields.items()}


class BatchGPU(StreamMsg):
    __slots__ = ("fields", "ts_host", "size", "capacity", "wm", "is_punct",
                 "stream_tag", "id", "schema", "host_keys", "_host",
                 "_d2h_event", "trace_min", "trace_max")

    def __init__(self, fields: Dict[str, torch.Tensor], ts_host: np.ndarray,
                 size: int, schema: TupleSchema, wm: int = 0,
                 host_keys: Optional[Any] = None) -> None:
        self.fields = fields  # name -> tensor (capacity,) on the device
        self.ts_host = ts_host  # np.int64 (capacity,)
        self.size = size
        self.capacity = len(ts_host)
        self.wm = wm
        self.is_punct = False
        self.stream_tag = 0
        self.id = 0
        self.schema = schema
        self.host_keys = host_keys  # host key metadata, len == size
        self._host: Dict[str, torch.Tensor] = {}  # host copies by column
        self._d2h_event = None
        self.trace_min = 0
        self.trace_max = 0

    def min_watermark(self) -> int:
        return self.wm

    def __len__(self) -> int:
        return self.size

    @property
    def device(self) -> torch.device:
        return next(iter(self.fields.values())).device

    def nbytes(self) -> int:
        return sum(v.element_size() * self.capacity
                   for v in self.fields.values())

    # -- construction ------------------------------------------------------
    @staticmethod
    def stage_prefilled(cols: Dict[str, torch.Tensor], ts: np.ndarray,
                        n: int, schema: TupleSchema, wm: int,
                        device: torch.device, keys: Optional[Any] = None,
                        recycler=None) -> "BatchGPU":
        """CPU->device from host staging tensors ALREADY padded to the
        capacity bucket and filled in place. Ownership of ``cols`` and
        ``ts`` moves to the batch: the caller must not touch them again.
        With an enabled ``recycler`` the column tensors go back to its
        pool once the event recorded after their copies has fired."""
        if device.type == "cpu":
            dev = {name: cols[name] for name in schema.fields}
        else:
            dev = {name: cols[name].to(device, non_blocking=True)
                   for name in schema.fields}
        if recycler is not None and recycler.enabled:
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            recycler.track(event, [cols[name] for name in schema.fields])
        return BatchGPU(dev, ts, n, schema, wm, keys)

    @staticmethod
    def stage_rows(rows, schema: TupleSchema, wm: int, device: torch.device,
                   keys: Optional[List[Any]] = None,
                   capacity: Optional[int] = None,
                   recycler=None, native: bool = False,
                   stats=None) -> "BatchGPU":
        """CPU->device from row tuples: columnarize (into pooled staging
        tensors with an enabled ``recycler``; with the native encoders
        when ``native``, counted in ``stats``), then stage."""
        cap = capacity or bucket_capacity(len(rows))
        pooled = recycler is not None and recycler.enabled
        cols, ts, encoded = schema.to_columns(
            rows, cap, recycler.pool if pooled else None, native)
        if encoded:
            from ..native import note_encoded_batch
            note_encoded_batch()
            if stats is not None:
                stats.native_encode_batches += 1
        if pooled:
            host = cols
        else:
            host = {}
            for name, col in cols.items():
                buf = host_buffer(col.dtype, cap, device)
                buf.numpy()[:] = col
                host[name] = buf
        return BatchGPU.stage_prefilled(host, ts, len(rows), schema, wm,
                                        device, keys, recycler)

    def with_fields(self, new_fields: Dict[str, torch.Tensor]
                    ) -> "BatchGPU":
        """Same metadata, new device columns (an operator's output)."""
        b = BatchGPU(new_fields, self.ts_host, self.size, self.schema,
                     self.wm, self.host_keys)
        b.stream_tag = self.stream_tag
        b.id = self.id
        return b.copy_trace_from(self)

    def copy_trace_from(self, src: "BatchGPU") -> "BatchGPU":
        """Carry ``src``'s latency-tracing stamps (an operator's output
        batch keeps its input's cohort)."""
        self.trace_min = src.trace_min
        self.trace_max = src.trace_max
        return self

    def copy_for_dest(self) -> "BatchGPU":
        """Broadcast copy: the device columns and the host copies already
        started are shared (nothing writes either after the batch is
        sent); each copy starts its own further host copies."""
        b = self.with_fields(dict(self.fields))
        b._host = dict(self._host)
        b._d2h_event = self._d2h_event
        return b

    # -- exit to host ------------------------------------------------------
    def prefetch_host(self, names: Optional[Sequence[str]] = None) -> None:
        """Start the asynchronous D2H of the named columns (default: every
        column) that are not on the host yet (the reference's
        ``prefetch2CPU``, ``batch_gpu_t_u.hpp:203``)."""
        want = {n: self.fields[n] for n in (self.fields if names is None
                                            else names)
                if n not in self._host}
        if not want:
            return
        host, ev = host_copies(want)
        self._host.update(host)
        if ev is not None:
            # the newest event follows every earlier copy on the stream
            self._d2h_event = ev

    def host_columns(self, names: Optional[Sequence[str]] = None
                     ) -> Dict[str, np.ndarray]:
        """Host numpy view of the named columns (default: every column);
        waits for their copies."""
        self.prefetch_host(names)
        if self._d2h_event is not None:
            self._d2h_event.synchronize()
            self._d2h_event = None
        return {name: self._host[name].numpy()
                for name in (self.fields if names is None else names)}

    def to_rows(self):
        """Device->CPU rows (the reference's ``transfer2CPU``)."""
        return self.schema.from_columns(self.host_columns(), self.ts_host,
                                        self.size)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<BatchGPU n={self.size}/{self.capacity} wm={self.wm}>"
