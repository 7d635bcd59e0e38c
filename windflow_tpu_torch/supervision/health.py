"""Device-health probing and failure-domain mapping.

The port of ``windflow_tpu/supervision/health.py``:

- a pluggable ``DeviceHealthProbe`` answering "which device ids are dead
  right now?"; ``TorchDeviceProbe`` (the JAX package's
  ``JaxDeviceProbe``) runs a one-element op and a synchronize on each
  CUDA device, and tests inject a ``StaticDeviceProbe`` with a mutable
  dead set;
- ``failure_domain_map``: device id -> the mesh operators whose sharded
  state lives on it.

Scope in the port: dead devices are excluded from the rebuilt device
MESHES, and the port has no mesh operator yet (the mesh plane is a later
slice). Until then the supervisor consults a wired probe before every
rebuild and reports what it found (``Recovery_degraded_devices``), but
there is nothing to exclude: every device operator runs on the graph's
one device, and ``failure_domain_map`` returns an empty map.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List

__all__ = ["DeviceHealthProbe", "StaticDeviceProbe", "TorchDeviceProbe",
           "failure_domain_map"]


class DeviceHealthProbe:
    """Answers which accelerator device ids are dead. The supervisor
    calls ``dead_devices`` before every rebuild. Implementations must be
    cheap and must not raise on a healthy system; a probe exception is
    treated as "no new information". (The JAX package's ``interval_s``
    paces the mesh re-expansion polls, which come with the mesh plane.)"""

    def dead_devices(self) -> FrozenSet[int]:
        raise NotImplementedError


class TorchDeviceProbe(DeviceHealthProbe):
    """Default probe: a one-element op and a synchronize per CUDA device,
    errors caught per device. A failed or unreachable card raises (a
    poisoned context raises on every call), a healthy one costs
    microseconds. With no card it reports nothing dead."""

    def dead_devices(self) -> FrozenSet[int]:
        import torch

        if not torch.cuda.is_available():
            return frozenset()
        dead = set()
        for i in range(torch.cuda.device_count()):
            try:
                (torch.ones((), device=f"cuda:{i}") + 1).item()
                torch.cuda.synchronize(i)
            except Exception:
                dead.add(i)
        return frozenset(dead)


class StaticDeviceProbe(DeviceHealthProbe):
    """Test probe: reports exactly the mutable ``dead`` set."""

    def __init__(self, dead: Iterable[int] = ()) -> None:
        self.dead = set(int(d) for d in dead)

    def dead_devices(self) -> FrozenSet[int]:
        return frozenset(self.dead)


def failure_domain_map(graph) -> Dict[int, List[str]]:
    """Device id -> sorted names of the mesh operators whose device mesh
    places shards on it. Non-mesh operators have no entry: their failure
    domain is the graph's one device. The port has no mesh operator yet,
    so the map of every port graph is empty until the mesh plane lands."""
    return {}
