"""Self-healing supervision (the port of ``windflow_tpu/supervision/``).

- ``supervisor``: graph-level auto-recovery. A supervisor thread watches
  worker deaths, tears the runtime plane down, restores from the newest
  committed checkpoint that verifies and resumes the sources from their
  recorded positions, under a jittered exponential-backoff
  ``RestartPolicy`` with a bounded restart budget.
- ``errors``: per-record failure containment. Operator-level error
  policies (``FAIL`` default, ``SKIP``, ``RETRY(n)``, ``DEAD_LETTER``)
  wrap functor invocation on the host path and bisect device batches to
  isolate the offending record on the device path; quarantined records
  land in a ``DeadLetterQueue`` with their exception.
- ``health``: the device-health probe and failure-domain map.
"""

from .errors import DeadLetterQueue, ErrorPolicy, is_sticky_device_error
from .health import (DeviceHealthProbe, StaticDeviceProbe, TorchDeviceProbe,
                     failure_domain_map)
from .policy import RestartPolicy
from .supervisor import SupervisionEscalated, Supervisor

__all__ = ["DeadLetterQueue", "DeviceHealthProbe", "ErrorPolicy",
           "RestartPolicy", "StaticDeviceProbe", "SupervisionEscalated",
           "Supervisor", "TorchDeviceProbe", "failure_domain_map",
           "is_sticky_device_error"]
