"""Sink-side delivery guarantees: the port of ``windflow_tpu.sinks``.

``transactional`` upgrades the sinks from at-least-once to exactly-once
with an epoch-fenced two-phase commit driven by the aligned-barrier
checkpoint plane (``windflow_tpu_torch.checkpoint``): a sink stages its
output per epoch, pre-commits it when the barrier reaches it, and makes
it visible only when the coordinator finalizes the epoch.
"""

from .transactional import (EpochSegmentStore, EpochTxnDriver,
                            FencedWriteError, SegmentBackend,
                            read_committed_records, txn_dir_for)

__all__ = ["EpochSegmentStore", "EpochTxnDriver", "FencedWriteError",
           "SegmentBackend", "read_committed_records", "txn_dir_for"]
