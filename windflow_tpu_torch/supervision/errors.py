"""Per-record failure containment: error policies and the dead-letter
queue.

The port of ``windflow_tpu/supervision/errors.py``. The default
(``ErrorPolicy.FAIL``) is the plain behaviour: a functor exception kills
the worker and, without supervision, the graph. Any other policy wraps
functor invocation so that one poison record no longer takes the
pipeline down:

- ``SKIP``: drop the record, count it (``Dlq_skipped``);
- ``RETRY(n)``: re-invoke with exponential backoff, then apply the
  ``on_exhausted`` fallback (default ``dead_letter``);
- ``DEAD_LETTER``: quarantine the record and its exception in the
  graph's ``DeadLetterQueue`` (``Dlq_records``).

Host path: ``BasicReplica`` swaps its ``process`` for a guarded wrapper
at construction (an instance attribute: the FAIL default pays nothing).
Device path: a whole batch runs as one program, so a failing batch is
BISECTED (``split_batch``) until the offending record is alone, and the
policy applies to that record (``GPUReplicaBase._process_batch_guarded``).

Only ``Exception`` is contained: ``BaseException`` signals
(``RescaleTeardown``/``SupervisorTeardown``, KeyboardInterrupt) always
propagate. So does a STICKY device error (``is_sticky_device_error``): an
illegal address or a device-side assert poisons the CUDA context, every
later call on it fails the same way, and bisecting or retrying on it
would only loop. The port tells the two apart by the error's message,
the only form in which the CUDA runtime reports it through torch: the
sticky ``cudaError`` strings below. A Python exception in prep or a
host-side torch error has no such message and is bisected.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from ..basic import WindFlowError

_KINDS = ("fail", "skip", "retry", "dead_letter")

# the CUDA runtime errors that leave the context unusable (cudaError
# strings as torch reports them: "CUDA error: <string>")
_STICKY_CUDA_ERRORS = (
    "an illegal memory access was encountered",
    "device-side assert triggered",
    "unspecified launch failure",
    "an illegal instruction was encountered",
    "misaligned address",
    "uncorrectable ECC error encountered",
    "the launch timed out and was terminated",
)


def is_sticky_device_error(exc: BaseException) -> bool:
    """True when ``exc`` (or an exception it was raised from) is a CUDA
    error that poisons the device context."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        msg = str(exc)
        if "CUDA error" in msg and any(s in msg
                                       for s in _STICKY_CUDA_ERRORS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


class ErrorPolicy:
    """Per-operator record-failure policy. Use the factory constructors
    (``ErrorPolicy.FAIL``/``SKIP``/``DEAD_LETTER`` or
    ``ErrorPolicy.RETRY(n, ...)``) rather than ``__init__``."""

    __slots__ = ("kind", "retries", "backoff_s", "backoff_factor",
                 "on_exhausted", "dlq")

    FAIL: "ErrorPolicy"
    SKIP: "ErrorPolicy"
    DEAD_LETTER: "ErrorPolicy"

    def __init__(self, kind: str, retries: int = 0, backoff_s: float = 0.0,
                 backoff_factor: float = 2.0,
                 on_exhausted: str = "dead_letter") -> None:
        if kind not in _KINDS:
            raise WindFlowError(
                f"ErrorPolicy: unknown kind {kind!r} (choose from {_KINDS})")
        if on_exhausted not in ("fail", "skip", "dead_letter"):
            raise WindFlowError(
                f"ErrorPolicy: on_exhausted must be fail/skip/dead_letter, "
                f"got {on_exhausted!r}")
        self.kind = kind
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.on_exhausted = on_exhausted
        # an explicit queue; otherwise the graph gives each operator its
        # own (never stored here: DEAD_LETTER is a shared singleton)
        self.dlq: Optional["DeadLetterQueue"] = None

    @classmethod
    def RETRY(cls, retries: int, backoff_s: float = 0.01,
              backoff_factor: float = 2.0,
              on_exhausted: str = "dead_letter") -> "ErrorPolicy":
        """Re-invoke the functor up to ``retries`` extra times with
        exponential backoff (``backoff_s * factor**attempt`` sleeps), then
        apply ``on_exhausted`` ("fail" | "skip" | "dead_letter"). A functor
        with side effects before its raise repeats them on retry: retry
        suits pure functors."""
        if retries < 1:
            raise WindFlowError("ErrorPolicy.RETRY: retries must be >= 1")
        return cls("retry", retries, backoff_s, backoff_factor, on_exhausted)

    @property
    def is_fail(self) -> bool:
        return self.kind == "fail"

    @property
    def may_dead_letter(self) -> bool:
        return self.kind == "dead_letter" or (
            self.kind == "retry" and self.on_exhausted == "dead_letter")

    @classmethod
    def parse(cls, spec: str) -> "ErrorPolicy":
        """The string form: ``fail`` | ``skip`` | ``dead_letter`` |
        ``retry:N``."""
        s = spec.strip().lower()
        if s.startswith("retry"):
            n = int(s.split(":", 1)[1]) if ":" in s else 1
            return cls.RETRY(n)
        return {"fail": cls.FAIL, "skip": cls.SKIP,
                "dead_letter": cls.DEAD_LETTER}.get(s) or cls(s)

    def __repr__(self) -> str:
        if self.kind == "retry":
            return (f"ErrorPolicy.RETRY({self.retries}, "
                    f"on_exhausted={self.on_exhausted!r})")
        return f"ErrorPolicy.{self.kind.upper()}"


ErrorPolicy.FAIL = ErrorPolicy("fail")
ErrorPolicy.SKIP = ErrorPolicy("skip")
ErrorPolicy.DEAD_LETTER = ErrorPolicy("dead_letter")


def _safe_repr(payload: Any, limit: int = 512) -> str:
    try:
        r = repr(payload)
    except Exception:
        r = f"<unreprable {type(payload).__name__}>"
    return r if len(r) <= limit else r[:limit] + "…"


class DeadLetterQueue:
    """The graph's quarantine side channel: a bounded in-memory ring of
    dead-letter records (newest kept), and with ``dir`` one JSON line per
    record in ``<dir>/<graph>.dlq.jsonl`` (the durable queue a re-drive
    job reads). Record::

        {"operator": str, "replica": int, "payload": repr, "ts": int,
         "error": "Type: message", "traceback": str, "wall_time": float}

    The ring also keeps the payload object itself under
    ``"payload_obj"``. Subclasses (the overload plane's ``ShedLog``)
    override ``_suffix`` and feed ``put_raw`` their own records."""

    _suffix = ".dlq.jsonl"

    def __init__(self, graph_name: str = "pipegraph", capacity: int = 10_000,
                 dir: Optional[str] = None) -> None:
        self.graph_name = graph_name
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total = 0  # ever quarantined (the ring may have evicted)
        self._dir = dir
        self._path: Optional[str] = None
        if self._dir:
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in graph_name) or "pipegraph"
            self._path = os.path.join(self._dir, f"{safe}{self._suffix}")

    def put_raw(self, rec: Dict[str, Any],
                ring_extra: Optional[Dict[str, Any]] = None) -> None:
        """Append one composed record: to the ring (with ``ring_extra``
        in-memory-only keys) and, with a directory, to the JSONL file."""
        with self._lock:
            self.total += 1
            self._ring.append(rec if ring_extra is None
                              else {**rec, **ring_extra})
            if self._path is not None:
                self._append_jsonl(rec)

    def put(self, operator: str, replica: int, payload: Any, ts: int,
            exc: BaseException) -> Dict[str, Any]:
        rec = {
            "operator": operator,
            "replica": int(replica),
            "payload": _safe_repr(payload),
            "ts": int(ts),
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
            "wall_time": time.time(),
        }
        self.put_raw(rec, ring_extra={"payload_obj": payload})
        return rec

    def _append_jsonl(self, rec: Dict[str, Any]) -> None:
        import json
        try:
            os.makedirs(self._dir, exist_ok=True)
            with open(self._path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # a full disk must not turn quarantine into a crash

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def path(self) -> Optional[str]:
        return self._path


_DEFAULT_DLQ: Optional[DeadLetterQueue] = None


def _default_dlq() -> DeadLetterQueue:
    """Fallback quarantine for replicas driven outside a PipeGraph."""
    global _DEFAULT_DLQ
    if _DEFAULT_DLQ is None:
        _DEFAULT_DLQ = DeadLetterQueue("standalone")
    return _DEFAULT_DLQ


# ---------------------------------------------------------------------------
# the host path (wired by BasicReplica when the policy is not FAIL)
# ---------------------------------------------------------------------------
def apply_record_policy(replica, policy: ErrorPolicy, payload: Any, ts: int,
                        exc: Exception, invoke=None) -> None:
    """One failed record under a non-FAIL policy. ``invoke`` re-runs the
    record for RETRY (None = not retryable here: the fallback applies at
    once)."""
    stats = replica.stats
    kind = policy.kind
    if kind == "retry" and invoke is not None:
        last = exc
        for attempt in range(policy.retries):
            stats.dlq_retries += 1
            delay = policy.backoff_s * (policy.backoff_factor ** attempt)
            if delay > 0:
                time.sleep(delay)
            try:
                invoke()
                return  # healed
            except Exception as e:  # noqa: BLE001 — policy boundary
                last = e
        exc, kind = last, policy.on_exhausted
    elif kind == "retry":
        kind = policy.on_exhausted
    if kind == "fail":
        raise exc
    if kind == "skip":
        stats.dlq_skipped += 1
        stats.inputs_ignored += 1
        return
    # dead_letter: the operator's queue (injected by the graph), else the
    # policy's explicit one, else the module default
    dlq = getattr(replica.op, "_dlq", None)
    if dlq is None:  # is-None: an EMPTY queue is falsy (__len__)
        dlq = policy.dlq
    if dlq is None:
        dlq = _default_dlq()
    dlq.put(replica.op.name, replica.idx, payload, ts, exc)
    stats.dlq_records += 1
    stats.inputs_ignored += 1


def make_guarded_process(replica, policy: ErrorPolicy):
    """The host-path wrapper installed over ``replica.process`` (the bound
    method captured once; an instance attribute, so operators on the FAIL
    default pay nothing)."""
    raw = replica.process

    def guarded(payload, ts, wm, tag):
        try:
            return raw(payload, ts, wm, tag)
        except Exception as exc:  # noqa: BLE001 — the policy boundary
            apply_record_policy(replica, policy, payload, ts, exc,
                                invoke=lambda: raw(payload, ts, wm, tag))

    return guarded


# ---------------------------------------------------------------------------
# the device path: batch bisection
# ---------------------------------------------------------------------------
def split_batch(batch) -> List[Any]:
    """Halve a ``BatchGPU`` for poison isolation: slices (views) of the
    device columns and the matching host timestamps and keys."""
    from ..gpu.batch import BatchGPU

    n = batch.size
    mid = n // 2
    out = []
    for lo, hi in ((0, mid), (mid, n)):
        if hi <= lo:
            continue
        fields = {name: col[lo:hi] for name, col in batch.fields.items()}
        keys = (batch.host_keys[lo:hi] if batch.host_keys is not None
                else None)
        nb = BatchGPU(fields, batch.ts_host[lo:hi], hi - lo, batch.schema,
                      batch.wm, keys)
        nb.stream_tag = batch.stream_tag
        out.append(nb)
    return out


def batch_row_payload(batch, idx: int = 0) -> Dict[str, Any]:
    """One row of a device batch as a host dict (the dead-letter payload
    of an isolated poison record)."""
    row = {}
    for name, col in batch.fields.items():
        try:
            row[name] = col[idx].item()
        except Exception:
            row[name] = f"<unreadable column {name}>"
    return row
