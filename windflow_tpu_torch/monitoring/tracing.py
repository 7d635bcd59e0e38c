"""Sampled per-tuple latency tracing — configuration and span helpers.

The port's copy of ``windflow_tpu/monitoring/tracing.py``. The tracing
plane has three parts (none replaces the EWMAs):

- SOURCES stamp a sampled subset of tuples with a wall-clock origin
  (``current_time_usecs``). The stamp rides ``Single.trace_ts``; host
  batches carry ``trace_min`` / ``trace_max`` over their traced rows, and
  the device staging path carries the same pair through ``BatchGPU`` —
  device batches never hold per-tuple stamps.
- SINKS record end-to-end latency (now - origin) into their replica's
  ``LatencyHistogram``; every replica also records sampled service time
  and (device plane) dispatch prep/commit latency.
- Device-plane stages run inside ``torch.profiler.record_function``
  spans (``wf:prep:<op>`` / ``wf:commit:<op>``, where the JAX package
  uses ``jax.profiler.TraceAnnotation``), so a ``torch.profiler`` trace of
  the card lines up with these host stats and shows which commit launched
  which kernel.

The sampling rate is set per operator by the builders'
``with_latency_tracing(rate)``, or for the whole graph by
``PipeGraph(latency_sample=rate)`` (the JAX package's
``WF_LATENCY_SAMPLE``). A rate is ``1`` (every tuple), a fraction
``"1/64"``, a float ``0.01``, or ``0`` (off, the default: no clock reads
and no histogram work on the hot path, and ``device_span`` is a
``nullcontext``). A rate becomes a sampling INTERVAL (record every Nth),
so sampling is deterministic and divides exactly under test.
"""

from __future__ import annotations

from contextlib import nullcontext

__all__ = ["parse_sample_rate", "resolve_sample_every", "device_span"]


def parse_sample_rate(value) -> int:
    """Sampling rate -> interval N (record every Nth sample; 0 = off).

    Accepts 1 / "1" (every tuple), "1/64" (every 64th), a float in
    (0, 1], or 0/""/None (off). Malformed values fall back to off.
    Intervals round UP to a power of two: the source's per-tuple sampling
    gate is then one integer AND against ``interval - 1``, the same cost
    whether sampling is on or off."""
    if value is None:
        return 0
    if isinstance(value, str):
        value = value.strip()
        if not value:
            return 0
        if "/" in value:
            try:
                num, den = value.split("/", 1)
                rate = float(num) / float(den)
            except (ValueError, ZeroDivisionError):
                return 0
        else:
            try:
                rate = float(value)
            except ValueError:
                return 0
    else:
        try:
            rate = float(value)
        except (TypeError, ValueError):
            return 0
    if rate <= 0:
        return 0
    if rate >= 1:
        return 1
    n = max(1, round(1.0 / rate))
    return 1 << (n - 1).bit_length()  # next power of two >= n


def resolve_sample_every(op) -> int:
    """Per-operator interval: the builder's ``with_latency_tracing`` wins
    over the graph's ``latency_sample`` (set on the operator at
    configure). Always 0 or a power of two (the mask-gate contract)."""
    s = getattr(op, "latency_sample", None)
    if s is None:
        s = getattr(op, "graph_latency_sample", 0) or 0
    s = max(0, int(s))
    if s & (s - 1):  # direct op.latency_sample writes may skip the parse
        s = 1 << (s - 1).bit_length()
    return s


def device_span(name: str, enabled: bool = True):
    """A ``torch.profiler.record_function`` span (visible in a
    ``torch.profiler`` trace, around the kernels launched inside it), or
    a ``nullcontext`` when tracing is off for the operator."""
    if not enabled:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(name)
