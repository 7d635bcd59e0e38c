"""Overload-protection plane: SLO-driven admission control, priority load
shedding, and graceful degradation past the autoscaler's MAX_PAR.

The port's copy of ``windflow_tpu/overload``. Blocking backpressure
(bounded channels) and elastic scale-out (``scaling/``) bound latency only
while parallelism headroom exists. An :class:`OverloadGovernor` control
loop (``PipeGraph.with_slo(p99_ms)``) reads the sink-side end-to-end
latency histograms, the queues' backpressure and the autoscaler, and
walks an escalation ladder when the SLO is breached — TUNE (halve dispatch
depths and host output batches), SCALE (rescale the bottleneck, bounded by
MAX_PAR), SHED (token-bucket admission at the sources with a
``drop_newest`` / ``drop_oldest`` / ``probabilistic`` / ``key_priority``
policy, before the barriers and the exactly-once plane) — and recovers
with hysteresis and cooldown. Every shed is accounted: ``Shed_records`` /
``Shed_bytes``, ``shed:*`` / ``overload:*`` flight-recorder spans, and the
``ShedLog`` JSONL audit log in ``GovernorPolicy(shed_dir=...)``.
"""

from .admission import (SHED_POLICIES, AdmissionGate, ShedLog, TokenBucket,
                        parse_shed_policy)
from .governor import SLO_STATES, GovernorPolicy, OverloadGovernor

__all__ = [
    "AdmissionGate", "TokenBucket", "ShedLog", "SHED_POLICIES",
    "parse_shed_policy", "GovernorPolicy", "OverloadGovernor",
    "SLO_STATES",
]
