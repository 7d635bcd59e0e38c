"""Live rescaling: checkpoint-driven repartitioning of keyed state, and
the autoscaler loop over it (the port of ``windflow_tpu/scaling/``).

- ``repartition``: split/merge per-replica keyed checkpoint blobs N -> M
  by the KEYBY routing function;
- ``controller``: ``RescaleController``: quiesce at an aligned barrier,
  rebuild the runtime plane at the new parallelism, restore the
  repartitioned blobs, resume (no replay from the start);
- ``autoscaler``: ``AutoscalePolicy`` / ``Autoscaler``: scale the
  backpressured operator up and starved ones down, with hysteresis and a
  cooldown.

The entry points are on ``PipeGraph``: ``rescale(op, parallelism)`` and
``with_autoscaler(policy)``.
"""

from .autoscaler import Autoscaler, AutoscalePolicy
from .controller import RescaleController, RescaleReport
from .repartition import (repartition_refusal, split_collector_states,
                          split_operator_states)

__all__ = ["Autoscaler", "AutoscalePolicy", "RescaleController",
           "RescaleReport", "repartition_refusal",
           "split_collector_states", "split_operator_states"]
