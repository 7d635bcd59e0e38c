"""Shared machinery of the device operators.

The port of ``TPUOperatorBase`` and ``TPUReplicaBase``
(``windflow_tpu/tpu/ops_tpu.py:320-541``), without error policies and
checkpoint hooks. A device replica processes whole ``BatchGPU`` messages
and never iterates rows; its per-batch work is split into a host-prep
stage and a device-commit stage pipelined through a
``DeviceDispatchQueue`` (see ``runtime/dispatch.py``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from ..basic import ExecutionMode, OpType, RoutingMode, WindFlowError
from ..operators.base import BasicOperator, BasicReplica
from ..runtime.dispatch import DeviceDispatchQueue
from .batch import BatchGPU
from .schema import TupleSchema


def op_batch_keys_np(op, batch: BatchGPU):
    """``(keys, keys_arr)`` of one batch for ``op``: the host key metadata
    when the staging edge attached it, else the key column read back to
    the host (an int column serves as both forms)."""
    keys = batch.host_keys
    if keys is None:
        if op.key_field is None:
            raise WindFlowError(
                f"{op.name}: device batch carries no host keys and the "
                "key extractor is not a field name")
        arr = batch.host_columns()[op.key_field][:batch.size]
        return arr, arr
    if isinstance(keys, np.ndarray):
        return keys, keys
    return keys, np.asarray(keys)


class GPUReplicaBase(BasicReplica):
    """Processes whole device batches through the dispatch pipeline; the
    queue drains at every ordering point (punctuation, EOS, idle tick)."""

    def __init__(self, op: BasicOperator, idx: int) -> None:
        super().__init__(op, idx)
        self.device = op.device
        self.dispatch = DeviceDispatchQueue(stats=self.stats)

    def handle_msg(self, ch: int, msg: Any) -> None:
        if msg.is_punct:
            self.stats.punct_received += 1
            self._advance_wm(msg.wm)
            # in-flight batches emit BEFORE the punctuation propagates
            self.dispatch.drain(forced=True)
            self.on_punctuation(msg.wm)
            return
        if not isinstance(msg, BatchGPU):
            raise WindFlowError(
                f"{self.op.name}: device operator received a non-device "
                f"message ({type(msg).__name__}); the upstream operator must "
                "declare an output batch size > 0")
        self.stats.start_svc()
        self.stats.inputs_received += msg.size
        self.stats.device_batches_in += 1
        self._advance_wm(msg.wm)
        msg.wm = self.cur_wm
        t0 = time.perf_counter()
        commit = self.prep_device_batch(msg)
        prep_us = (time.perf_counter() - t0) * 1e6
        if commit is not None:
            self.dispatch.submit(commit, prep_us)
        else:
            self.stats.note_host_prep(prep_us)
        self.stats.end_svc(msg.size)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        """Host-prep stage: return this batch's device-commit thunk (or
        None when the batch needs no device work)."""
        raise NotImplementedError

    def on_idle(self) -> bool:
        return self.dispatch.on_idle()

    def terminate(self) -> None:
        if not self.terminated:
            self.dispatch.drain(forced=True)
        super().terminate()

    def _emit_batch(self, batch: BatchGPU) -> None:
        self.stats.device_batches_out += 1
        self.emitter.emit_device_batch(batch)


class GPUOperatorBase(BasicOperator):
    op_type = OpType.GPU
    is_gpu = True

    def __init__(self, name: str, parallelism: int, input_routing: RoutingMode,
                 key_extractor, output_batch_size: int,
                 schema: Optional[TupleSchema]) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.schema = schema  # None => inferred at the staging boundary

    @property
    def is_chainable(self) -> bool:
        return False

    def configure(self, execution_mode, time_policy, device) -> None:
        if execution_mode is not ExecutionMode.DEFAULT:
            # reference: GPU operators only in DEFAULT mode
            # (map_gpu.hpp:470-478)
            raise WindFlowError(
                f"{self.name}: GPU operators require DEFAULT execution mode")
        super().configure(execution_mode, time_policy, device)
