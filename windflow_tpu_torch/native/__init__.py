"""Native host runtime: the C++ channel ring and the staging encoders.

The port's own copy of ``windflow_tpu/native`` (``wfruntime.cpp`` here is
the port's source, not the JAX package's). It is host C++ built with g++,
loaded with ctypes; no device code.

- ``encode_column(rows, field, out)``: one C pass fills a numpy buffer
  (int32 / int64 / float32 / float64) from a field of every payload of a
  list, in place of the staging edge's per-row, per-field Python loop
  (``gpu/schema.py:TupleSchema.to_columns``). An int beyond int32 raises
  ``OverflowError`` as a numpy store does.
- ``NativeChannel``: the C++ bounded MPSC ring with the port channel's
  contract (``runtime/channel.py``): ``put`` / ``get(timeout)`` /
  ``close()`` (a supervised teardown raises ``SupervisorTeardown`` in
  every blocked and later put or get) and the ``Queue_*`` gauges the
  autoscaler and the overload governor read. A graph takes it with
  ``PipeGraph(native_channels=True)`` (the JAX package's
  ``WF_NATIVE_CHANNELS=1``).

The library is built on first use with ``g++ -O3 -shared -fPIC
-std=c++17`` against the Python headers into ``build/native/`` at the root
of the checkout (listed in ``.gitignore``), named by a digest of the
source and the flags, so an edited source is never served by a stale
build; nothing is built next to the source. A failed build is kept:
``native_available()`` is False, ``native_build_error()`` returns the
compiler's message, and ``native_state()`` (the graph's
``get_stats()["Native"]``) reports both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Any, Dict, Optional

from ..basic import SupervisorTeardown

SRC = Path(__file__).resolve().parent / "wfruntime.cpp"
BUILD_DIR = SRC.parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
ENCODABLE_DTYPES = ("int32", "int64", "float32", "float64")

_lock = threading.Lock()
_lib = None  # CDLL: the ring (GIL released while blocking)
_pylib = None  # PyDLL: the encoders (called with the GIL held)
_build_error: Optional[str] = None
_build_seconds = 0.0
#: staged batches the encoders filled in this process
ENCODE_BATCHES = 0


def _so_path() -> Path:
    inc = sysconfig.get_paths()["include"]
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(
        GXX_FLAGS + [inc]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"wfruntime-{digest}.so"


def _build(so: Path) -> Optional[str]:
    global _build_seconds
    import time
    inc = sysconfig.get_paths()["include"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, f"-I{inc}", str(SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"native build failed: {e}"
    _build_seconds = time.perf_counter() - t0
    if r.returncode != 0:
        return f"native build failed: {r.stderr[-800:]}"
    os.replace(tmp, so)  # atomic publish: concurrent builders agree
    return None


def _load() -> bool:
    global _lib, _pylib, _build_error
    with _lock:
        if _lib is not None:
            return True
        if _build_error is not None:
            return False
        so = _so_path()
        if not so.exists():
            err = _build(so)
            if err is not None:
                _build_error = err
                return False
        try:
            lib = ctypes.CDLL(str(so))
            pylib = ctypes.PyDLL(str(so))
        except OSError as e:
            _build_error = str(e)
            return False
        lib.wf_queue_create.restype = ctypes.c_void_p
        lib.wf_queue_create.argtypes = [ctypes.c_size_t]
        lib.wf_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.wf_queue_push.restype = ctypes.c_int
        lib.wf_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_size_t]
        lib.wf_queue_pop.restype = ctypes.c_int
        lib.wf_queue_pop.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_size_t),
                                     ctypes.c_long]
        lib.wf_queue_close.argtypes = [ctypes.c_void_p]
        lib.wf_queue_len.restype = ctypes.c_size_t
        lib.wf_queue_len.argtypes = [ctypes.c_void_p]
        lib.wf_queue_gauges.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int64)]
        for fn in ("wf_encode_i64", "wf_encode_f64", "wf_encode_i32",
                   "wf_encode_f32"):
            f = getattr(pylib, fn)
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.py_object, ctypes.py_object,
                          ctypes.c_void_p]
        _lib, _pylib = lib, pylib
        return True


def native_available() -> bool:
    """Build (once) and load the runtime; False when that failed."""
    return _load()


def native_build_error() -> Optional[str]:
    _load()
    return _build_error


def native_state() -> Dict[str, Any]:
    """What the graph's stats report, without triggering a build."""
    return {"Native_loaded": _lib is not None,
            "Native_build_error": _build_error,
            "Native_build_sec": round(_build_seconds, 3),
            "Native_encode_batches": ENCODE_BATCHES}


def _teardown() -> SupervisorTeardown:
    return SupervisorTeardown(
        "channel closed: the supervisor is rebuilding the runtime plane")


class NativeChannel:
    """The C++ ring behind the port channel's interface. Each queued
    message holds one reference taken at ``put`` and handed to the
    consumer at ``get``."""

    __slots__ = ("_h", "capacity", "n_inputs", "_closed")

    def __init__(self, capacity: int = 2048) -> None:
        if not _load():
            raise RuntimeError(_build_error or "native runtime unavailable")
        self._h = _lib.wf_queue_create(capacity)
        if not self._h:
            raise MemoryError("wf_queue_create failed")
        self.capacity = capacity
        self.n_inputs = 0
        self._closed = False

    def register_input(self) -> int:
        idx = self.n_inputs
        self.n_inputs += 1
        return idx

    def put(self, ch_idx: int, msg: Any) -> None:
        obj = ctypes.py_object(msg)
        ctypes.pythonapi.Py_IncRef(obj)
        if not _lib.wf_queue_push(self._h, ch_idx, id(msg)):
            ctypes.pythonapi.Py_DecRef(obj)  # the ring did not take it
            raise _teardown()

    def _pop(self, ms: int):
        tag = ctypes.c_int64()
        handle = ctypes.c_size_t()
        rc = _lib.wf_queue_pop(self._h, ctypes.byref(tag),
                               ctypes.byref(handle), ms)
        if rc == 0:
            return None
        if rc < 0:
            raise _teardown()
        msg = ctypes.cast(handle.value, ctypes.py_object).value
        ctypes.pythonapi.Py_DecRef(ctypes.py_object(msg))
        return tag.value, msg

    def get(self, timeout: Optional[float] = None):
        """Blocking pop; with ``timeout`` (seconds) None when the ring
        stays empty that long (the worker's idle tick). A closed ring
        hands out what it holds, then raises."""
        return self._pop(-1 if timeout is None
                         else max(1, int(timeout * 1000)))

    def close(self) -> None:
        self._closed = True
        _lib.wf_queue_close(self._h)

    @property
    def closed(self) -> bool:
        return self._closed

    def _gauges(self):
        out = (ctypes.c_int64 * 4)()
        _lib.wf_queue_gauges(self._h, out)
        return out

    @property
    def depth_max(self) -> int:
        return int(self._gauges()[0])

    @property
    def blocked_put_ns(self) -> int:
        return int(self._gauges()[1])

    @property
    def blocked_get_ns(self) -> int:
        return int(self._gauges()[2])

    @property
    def puts_blocked(self) -> int:
        return int(self._gauges()[3])

    def __len__(self) -> int:
        return int(_lib.wf_queue_len(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if not h or _lib is None:
            return  # no ring yet, or the interpreter is shutting down
        try:
            while self._pop(0) is not None:
                pass
        except BaseException:
            pass  # a closed ring raises once it is empty
        _lib.wf_queue_destroy(h)
        self._h = None


def encode_column(rows: list, field: str, out) -> None:
    """Fill ``out`` (a C-contiguous 1-D numpy int32/int64/float32/float64
    array, at least ``len(rows)`` long) from each payload's ``field``.
    The payload's own exception (KeyError, AttributeError, TypeError,
    OverflowError) propagates."""
    import numpy as np

    if not _load():
        raise RuntimeError(_build_error or "native runtime unavailable")
    if not out.flags["C_CONTIGUOUS"] or len(out) < len(rows):
        raise ValueError("encode_column: out must be C-contiguous and "
                         "hold every row")
    fns = {np.dtype(np.int64): _pylib.wf_encode_i64,
           np.dtype(np.float64): _pylib.wf_encode_f64,
           np.dtype(np.int32): _pylib.wf_encode_i32,
           np.dtype(np.float32): _pylib.wf_encode_f32}
    fn = fns.get(out.dtype)
    if fn is None:
        raise TypeError(f"encode_column: unsupported dtype {out.dtype}")
    if fn(rows, field, out.ctypes.data) != 0:  # pragma: no cover
        raise RuntimeError(f"native encode failed for field {field!r}")


def note_encoded_batch() -> None:
    global ENCODE_BATCHES
    with _lock:
        ENCODE_BATCHES += 1
