"""Device-health probing and failure-domain mapping.

The port of ``windflow_tpu/supervision/health.py``:

- a pluggable ``DeviceHealthProbe`` answering "which device ids are dead
  right now?"; ``TorchDeviceProbe`` (the JAX package's
  ``JaxDeviceProbe``) runs a one-element op and a synchronize on each
  CUDA device, and tests inject a ``StaticDeviceProbe`` with a mutable
  dead set;
- ``failure_domain_map``: device id -> the mesh operators whose sharded
  state lives on it, read from the built replicas' meshes.

The supervisor reads the probe before every rebuild and publishes the
dead set into the mesh exclusion registry
(``mesh/core.py:set_excluded_devices``): the rebuilt mesh operators come
up on the surviving devices (the ids ``mesh.visible_devices`` gives: the
virtual devices of ``ensure_virtual_devices``, else the physical cards),
restoring their sharded state through the slot-row relayout. Non-mesh
device operators run on the graph's one device and have no domain entry.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List

__all__ = ["DeviceHealthProbe", "StaticDeviceProbe", "TorchDeviceProbe",
           "failure_domain_map"]


class DeviceHealthProbe:
    """Answers which device ids are dead. The supervisor calls
    ``dead_devices`` before every rebuild and every ``interval_s`` seconds
    while the graph runs degraded (the re-expansion poll).
    Implementations must be cheap and must not raise on a healthy system;
    a probe exception is treated as "no new information"."""

    interval_s: float = 1.0

    def dead_devices(self) -> FrozenSet[int]:
        raise NotImplementedError


class TorchDeviceProbe(DeviceHealthProbe):
    """Default probe: a one-element op and a synchronize per CUDA device,
    errors caught per device. A failed or unreachable card raises (a
    poisoned context raises on every call), a healthy one costs
    microseconds. With no card it reports nothing dead. It names
    physical card indices: with virtual devices
    (``mesh.ensure_virtual_devices``) a test probe names the virtual
    ids instead."""

    def __init__(self, interval_s: float = 1.0) -> None:
        self.interval_s = float(interval_s)

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
    """Test probe: reports exactly the mutable ``dead`` set, so a test can
    simulate device loss (``probe.dead.add(7)``) and return
    (``probe.dead.clear()``)."""

    def __init__(self, dead: Iterable[int] = (),
                 interval_s: float = 0.05) -> None:
        self.dead = set(int(d) for d in dead)
        self.interval_s = float(interval_s)

    def dead_devices(self) -> FrozenSet[int]:
        return frozenset(self.dead)


def failure_domain_map(graph) -> Dict[int, List[str]]:
    """Device id -> sorted names of the mesh operators whose mesh places
    shards on it, read from the BUILT replicas (empty before the lazy
    mesh construction ran). Non-mesh operators have no entry: their
    failure domain is the graph's one device."""
    out: Dict[int, set] = {}
    for op in getattr(graph, "_ops", []):
        for r in op.replicas:
            mesh = getattr(r, "_mesh", None)
            if mesh is None:
                continue
            for d in mesh.device_ids:
                out.setdefault(int(d), set()).add(op.name)
    return {dev: sorted(names) for dev, names in sorted(out.items())}
