"""Aligned-barrier checkpointing and crash recovery, FULL and synchronous.

The port of ``windflow_tpu/checkpoint`` without its opt-in parts (delta
snapshots, the async uploader): Flink-style aligned snapshots over the
dataflow graph.

- a ``CheckpointCoordinator`` (owned by the ``PipeGraph``) opens a
  checkpoint epoch on a timer or on request; source replicas notice at
  their next tuple (or block) boundary, snapshot their replay position and
  inject a ``Barrier`` (``message.py``) downstream on every edge;
- each worker aligns barriers across its input channels (post-barrier
  input from already-barriered channels is buffered, so no post-barrier
  tuple reaches a pre-barrier snapshot), drains its device dispatch
  queues, flushes its emitters (the D2H pipelines included), forwards the
  barrier, and snapshots every replica of its chain (device state copied
  to host numpy) into the ``CheckpointStore``;
- when every worker has acknowledged, the coordinator commits the
  checkpoint atomically (manifest + directory rename);
- ``PipeGraph.run(restore_from=...)`` rebuilds the topology, restores
  every replica from the manifest's blobs and resumes the sources from
  their recorded positions.

Blobs hold numpy arrays and Python values, never tensors: a checkpoint
taken on a card restores on the CPU and the other way round.
"""

from .coordinator import CheckpointCoordinator
from .store import CheckpointStore, CorruptCheckpointError

__all__ = ["CheckpointCoordinator", "CheckpointStore",
           "CorruptCheckpointError"]
