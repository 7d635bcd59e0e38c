"""BatchGPU: a micro-batch resident in device memory.

The port's twin of ``windflow_tpu/tpu/batch.py:BatchTPU`` and the sibling
of the reference's ``Batch_GPU_t`` (``wf/batch_gpu_t.hpp:51-243``): a dict
of device columns padded to a power-of-two capacity bucket, an explicit
host-side ``size``, host int64 timestamps and host key metadata, with the
CPU batches' message protocol (watermark, punctuation flag, stream tag).

Transfers (in place of ``jax.device_put`` / ``copy_to_host_async``):

- H2D: the staging emitter fills page-locked host tensors in place and
  ``stage_prefilled`` issues ``non_blocking`` copies on the current
  stream. PyTorch's pinned-memory allocator records the copy's event, so a
  staging buffer is never handed out again before its copy has landed. On
  ``device="cpu"`` the batch's column IS the staging buffer
  (``torch.from_numpy`` aliases it); the staging emitter hands ownership
  over and allocates fresh buffers for the next batch, so nothing writes
  to a buffer a batch still reads.
- D2H: ``prefetch_host`` starts ``non_blocking`` copies of every column
  into pinned host tensors and records one CUDA event; ``host_columns``
  waits on that event only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..message import StreamMsg
from .schema import TupleSchema, torch_dtype


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


class BatchGPU(StreamMsg):
    __slots__ = ("fields", "ts_host", "size", "capacity", "wm", "is_punct",
                 "stream_tag", "id", "schema", "host_keys", "_host",
                 "_d2h_event")

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
        self._host: Optional[Dict[str, torch.Tensor]] = None
        self._d2h_event = None

    def min_watermark(self) -> int:
        return self.wm

    def __len__(self) -> int:
        return self.size

    def nbytes(self) -> int:
        return sum(v.element_size() * self.capacity
                   for v in self.fields.values())

    # -- construction ------------------------------------------------------
    @staticmethod
    def stage_prefilled(cols: Dict[str, torch.Tensor], ts: np.ndarray,
                        n: int, schema: TupleSchema, wm: int,
                        device: torch.device,
                        keys: Optional[Any] = None) -> "BatchGPU":
        """CPU->device from host staging tensors ALREADY padded to the
        capacity bucket and filled in place. Ownership of ``cols`` and
        ``ts`` moves to the batch: the caller must not touch them again."""
        if device.type == "cpu":
            dev = {name: cols[name] for name in schema.fields}
        else:
            dev = {name: cols[name].to(device, non_blocking=True)
                   for name in schema.fields}
        return BatchGPU(dev, ts, n, schema, wm, keys)

    @staticmethod
    def stage_rows(rows, schema: TupleSchema, wm: int, device: torch.device,
                   keys: Optional[List[Any]] = None,
                   capacity: Optional[int] = None) -> "BatchGPU":
        """CPU->device from row tuples: columnarize, then stage."""
        cap = capacity or bucket_capacity(len(rows))
        cols, ts = schema.to_columns(rows, cap)
        host = {}
        for name, col in cols.items():
            buf = host_buffer(col.dtype, cap, device)
            buf.numpy()[:] = col
            host[name] = buf
        return BatchGPU.stage_prefilled(host, ts, len(rows), schema, wm,
                                        device, keys)

    # -- exit to host ------------------------------------------------------
    def prefetch_host(self) -> None:
        """Start the asynchronous D2H of every column (the reference's
        ``prefetch2CPU``, ``batch_gpu_t_u.hpp:203``): one pinned host
        tensor per column, one event after the copies."""
        if self._host is not None:
            return
        if all(v.device.type == "cpu" for v in self.fields.values()):
            self._host = self.fields
            return
        host = {}
        for name, v in self.fields.items():
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            host[name] = h
        ev = torch.cuda.Event()
        ev.record()
        self._host = host
        self._d2h_event = ev

    def host_columns(self) -> Dict[str, np.ndarray]:
        """Host numpy view of every column (waits for the prefetch)."""
        if self._host is None:
            self.prefetch_host()
        if self._d2h_event is not None:
            self._d2h_event.synchronize()
            self._d2h_event = None
        return {name: t.numpy() for name, t in self._host.items()}

    def to_rows(self):
        """Device->CPU rows (the reference's ``transfer2CPU``)."""
        return self.schema.from_columns(self.host_columns(), self.ts_host,
                                        self.size)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<BatchGPU n={self.size}/{self.capacity} wm={self.wm}>"
