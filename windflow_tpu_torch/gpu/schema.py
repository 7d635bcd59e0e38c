"""Tuple schemas: the bridge between row-Python payloads and columnar
device batches.

Copy of ``windflow_tpu/tpu/schema.py`` plus the torch twin of
``broadcast_scalar_fields``. ``to_columns(..., native=True)`` fills the
columns with the native staging encoders (``native/``: one C pass per
column instead of a Python loop per row and field); the Python loop stays
for schemas with a column the encoders do not cover and after the first
encoder failure on a schema (a payload type the C pass refuses), as in the
JAX package. An int beyond the column's dtype raises ``OverflowError`` on
both paths. Numeric Python types map to
int32 / float32 / bool, as the JAX package's do with x64 off: the port
never lets torch's int64 / float64 defaults into a device column.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..basic import WindFlowError
from ..recycling import host_view

_DTYPE_MAP = {
    int: np.int32,
    float: np.float32,
    bool: np.bool_,
}

# x64-off canonicalization of device columns (the JAX package's dtypes)
_CANON = {torch.int64: torch.int32, torch.float64: torch.float32,
          torch.int16: torch.int32, torch.int8: torch.int32,
          torch.uint8: torch.int32, torch.float16: torch.float32,
          torch.bfloat16: torch.float32}


class TupleSchema:
    """Ordered field name -> numpy dtype, plus a row constructor."""

    def __init__(self, fields: Dict[str, Any],
                 constructor: Optional[Callable] = None) -> None:
        self.fields: Dict[str, np.dtype] = {
            name: np.dtype(dt) for name, dt in fields.items()}
        self.constructor = constructor  # None => rows come back as dicts
        self._names = list(self.fields)
        # native encoders: None = untried, False = off for this schema
        self._native_ok: Optional[bool] = None

    @staticmethod
    def infer(payload: Any) -> "TupleSchema":
        """Infer from a sample tuple: dataclass instances or dicts with
        numeric scalar fields."""
        if dataclasses.is_dataclass(payload):
            items = [(f.name, getattr(payload, f.name))
                     for f in dataclasses.fields(payload)]
            ctor = type(payload)
        elif isinstance(payload, dict):
            items = list(payload.items())
            ctor = None
        else:
            raise WindFlowError(
                f"cannot infer a device schema from {type(payload).__name__}; "
                "use dataclass/dict tuples or pass an explicit TupleSchema")
        flds = {}
        for k, v in items:
            dt = _DTYPE_MAP.get(type(v))
            flds[k] = dt if dt is not None else np.asarray(v).dtype
        return TupleSchema(flds, ctor)

    def to_columns(self, rows: Sequence[Tuple[Any, int]], capacity: int,
                   pool=None, native: bool = False
                   ) -> Tuple[Dict[str, Any], np.ndarray, bool]:
        """Rows [(payload, ts)] -> padded columnar arrays, int64 ts, and
        whether the native encoders filled them. With ``pool`` (a
        ``recycling.ArrayPool``) the column buffers come from its free
        lists and are returned as it hands them out (pinned tensors on the
        staging edge); the caller returns them to it once the H2D copies
        have read them. ``ts`` is never pooled: it becomes the batch's
        host metadata and lives as long as the batch."""
        if pool is not None:
            bufs = {name: pool.acquire(dt, capacity)
                    for name, dt in self.fields.items()}
            cols = {name: host_view(b) for name, b in bufs.items()}
        else:
            cols = bufs = {name: np.zeros(capacity, dtype=dt)
                           for name, dt in self.fields.items()}
        ts = np.zeros(capacity, dtype=np.int64)
        n = len(rows)
        if native and n and self._try_native(rows, cols, ts, n):
            return bufs, ts, True
        by_item = bool(rows) and isinstance(rows[0][0], dict)
        for i, (p, t) in enumerate(rows):
            ts[i] = t
            for name in self._names:
                cols[name][i] = p[name] if by_item else getattr(p, name)
        return bufs, ts, False

    def _try_native(self, rows, cols, ts, n: int) -> bool:
        """One C pass per column. The first failure turns the encoders
        off for this schema (retrying a C pass that fails would double the
        staging cost of every batch), except an ``OverflowError``, which
        raises: the Python path would refuse the same value."""
        if self._native_ok is False:
            return False
        from ..native import ENCODABLE_DTYPES, encode_column, \
            native_available
        if self._native_ok is None:
            if not native_available() or any(
                    str(dt) not in ENCODABLE_DTYPES
                    for dt in self.fields.values()):
                self._native_ok = False
                return False
        payloads = [r[0] for r in rows]
        try:
            for name in self._names:
                encode_column(payloads, name, cols[name])
        except OverflowError:
            raise
        except Exception:
            self._native_ok = False
            return False
        ts[:n] = [r[1] for r in rows]
        self._native_ok = True
        return True

    def from_columns(self, cols: Dict[str, np.ndarray], ts: np.ndarray,
                     n: int) -> List[Tuple[Any, int]]:
        """Columnar host arrays -> rows [(payload, ts)] for the CPU plane
        (one ``tolist()`` C pass per column)."""
        names = self._names
        ctor = self.constructor
        ts_list = np.asarray(ts[:n], dtype=np.int64).tolist()
        if not names:
            return [({}, t) for t in ts_list]
        lists = [np.asarray(cols[name])[:n].tolist() for name in names]
        if ctor is not None:
            return [(ctor(**dict(zip(names, vals))), t)
                    for vals, t in zip(zip(*lists), ts_list)]
        return [(dict(zip(names, vals)), t)
                for vals, t in zip(zip(*lists), ts_list)]

    def __repr__(self) -> str:  # pragma: no cover
        return f"TupleSchema({self.fields})"


def torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def canonical(t: torch.Tensor) -> torch.Tensor:
    """A device column in the JAX package's x64-off dtypes."""
    dt = _CANON.get(t.dtype)
    return t if dt is None else t.to(dt)


def broadcast_scalar_fields(vals: Dict[str, Any], n_rows: int,
                            device: torch.device) -> Dict[str, torch.Tensor]:
    """Broadcast per-tuple CONSTANT lift fields (e.g. a count seed
    ``{"n": 1.0}``) to the batch column shape, and canonicalize every lift
    column to int32 / float32 / bool."""
    out = {}
    for name, a in vals.items():
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(
                a, dtype=_DTYPE_MAP.get(type(a)))).to(device)
        if a.dim() == 0:
            a = a.expand(n_rows)
        out[name] = canonical(a)
    return out
