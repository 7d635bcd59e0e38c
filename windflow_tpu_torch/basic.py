"""Core enums, constants and small helpers of the PyTorch port.

A trimmed copy of ``windflow_tpu/basic.py`` (the port imports nothing of
the JAX package): the enums mirror ``wf/basic.hpp:78-93``, the watermark
cadence mirrors ``wf/basic.hpp:199-216`` and the channel capacity
FastFlow's ``DEFAULT_BUFFER_CAPACITY``. A key extractor is a callable, a
field name, or a tuple of field names (a composite key, extracted as a
tuple on the row path and routed as stacked columns on the device plane).
"""

from __future__ import annotations

import enum
import time


class ExecutionMode(enum.Enum):
    """How out-of-order input is handled (``wf/basic.hpp:78-82``)."""

    DEFAULT = "default"
    DETERMINISTIC = "deterministic"
    PROBABILISTIC = "probabilistic"


class TimePolicy(enum.Enum):
    """Where timestamps come from (``wf/basic.hpp:85-88``)."""

    INGRESS_TIME = "ingress_time"
    EVENT_TIME = "event_time"


class WinType(enum.Enum):
    """Window semantics (``wf/basic.hpp:91-93``)."""

    CB = "count_based"
    TB = "time_based"


class RoutingMode(enum.Enum):
    NONE = "none"
    FORWARD = "forward"
    KEYBY = "keyby"
    BROADCAST = "broadcast"
    REBALANCING = "rebalancing"


class OpType(enum.Enum):
    SOURCE = "source"
    BASIC = "basic"
    SINK = "sink"
    GPU = "gpu"
    WIN_GPU = "win_gpu"


# --- watermark / punctuation cadence (wf/basic.hpp:199-216) -----------------
DEFAULT_WM_INTERVAL_USEC = 100_000  # punctuation cadence: 100 ms
DEFAULT_WM_AMOUNT = 64  # check elapsed time once every N emitted tuples

# --- queue capacity (FastFlow DEFAULT_BUFFER_CAPACITY) ----------------------
DEFAULT_BUFFER_CAPACITY = 2048


def current_time_usecs() -> int:
    """Microseconds from an arbitrary monotonic origin."""
    return time.monotonic_ns() // 1_000


class WindFlowError(RuntimeError):
    """Topology / runtime error, raised so callers can assert on misuse."""


class KeyCapacityError(WindFlowError):
    """A keyed device structure refused new keys: the distinct-key count
    exceeded the declared dense capacity (``K_pad`` — the padded slot
    count of the device table). Typed so callers can tell "grow the
    capacity / enable tiering" apart from generic topology errors, and
    carries the operator, the padded capacity, and how many keys were
    refused. This stays the loud failure mode when tiering is NOT
    enabled; ``with_tiering(...)`` makes the capacity elastic instead."""

    def __init__(self, op_name: str, k_pad: int, refused: int,
                 hint: str = "") -> None:
        self.op_name = op_name
        self.k_pad = int(k_pad)
        self.refused = int(refused)
        msg = (f"{op_name}: {self.refused} new key(s) refused — distinct "
               f"key count exceeds the device key capacity K_pad="
               f"{self.k_pad}")
        if hint:
            msg += f"; {hint}"
        super().__init__(msg)


class CorruptCheckpointError(WindFlowError):
    """Saved state failed content verification: a digest recorded with it
    does not match its bytes (a checkpoint blob against its manifest, a
    tier blob's cold image or hot table), a manifested blob is missing, or
    a manifest or blob cannot be decoded. The message names the bad file."""


class WorkerFailuresError(WindFlowError):
    """Aggregate of several workers' errors (``PipeGraph.wait_end``)."""

    def __init__(self, worker_errors) -> None:
        self.worker_errors = dict(worker_errors)
        parts = [f"{name} ({type(e).__name__}: {e})"
                 for name, e in self.worker_errors.items()]
        super().__init__(
            f"{len(self.worker_errors)} workers died: " + "; ".join(parts))


def as_key_fn(key):
    """Normalize a key extractor: callables pass through; a string names a
    tuple field (dataclass attribute or dict key); a tuple of strings
    names the fields of a composite key, extracted as a tuple."""
    if key is None or callable(key):
        return key
    if isinstance(key, str):
        def field_key(payload, _name=key):
            if isinstance(payload, dict):
                return payload[_name]
            return getattr(payload, _name)
        return field_key
    names = key_fields_names(key)
    if names is not None:
        def fields_key(payload, _names=names):
            if isinstance(payload, dict):
                return tuple(payload[f] for f in _names)
            return tuple(getattr(payload, f) for f in _names)
        return fields_key
    raise WindFlowError(f"invalid key extractor: {key!r}")


def key_field_name(key):
    """The device column name of a key extractor, or None for callables."""
    return key if isinstance(key, str) else None


def key_fields_names(key):
    """The device column names of a COMPOSITE key extractor (a tuple or
    list of field names, e.g. ``("campaign", "ad")``), or None. On the
    row path the key is a tuple; the device plane routes it as stacked
    columns (a structured numpy column) with no per-row Python. A name
    given twice is refused here, at ``with_key_by()``/build time: the
    columnar path would otherwise fail mid-stream building the structured
    dtype."""
    if isinstance(key, (tuple, list)) and key \
            and all(isinstance(f, str) for f in key):
        names = tuple(key)
        if len(set(names)) != len(names):
            raise WindFlowError(
                f"composite key repeats a field name: {names}")
        return names
    return None
