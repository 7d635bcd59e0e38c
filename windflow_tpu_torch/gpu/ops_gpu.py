"""Device operators Map_GPU, Filter_GPU and Reduce_GPU, and the machinery
every device operator shares.

The port of ``windflow_tpu/tpu/ops_tpu.py`` (reference: WindFlow's
``wf/map_gpu.hpp``, ``wf/filter_gpu.hpp``, ``wf/reduce_gpu.hpp``), without
error policies, checkpoint hooks and the stateful keyed variants. A device
replica processes whole ``BatchGPU`` messages and never iterates rows;
its per-batch work is split into a host-prep stage and a device-commit
stage pipelined through a ``DeviceDispatchQueue`` (see
``runtime/dispatch.py``).

User functions are torch functions over a dict of columns
(struct-of-arrays) on the operator's device; they must not write their
input tensors in place, since a broadcast edge shares one batch's columns
between replicas.

- ``Map_GPU``: ``func(fields) -> fields``.
- ``Filter_GPU``: ``pred(fields)`` gives the keep mask (bool or int 0/1);
  the batch compacts by a stable keepers-first permutation built from two
  cumsums and one scatter (``compact_order``; the reference uses
  ``thrust::copy_if``, ``filter_gpu.hpp:331-335``). The kept count and the
  order come back to the host for the timestamps and host keys: the
  device work starts in the host-prep stage, and the readback waits in
  the deferred commit, by when later batches are already queued.
- ``Reduce_GPU`` keyed: one output per distinct key per batch (reference
  ``reduce_by_key``, ``reduce_gpu.hpp:245-251``). The HOST sorts the keys
  once (``reduce_order_and_slots``) and ships the gather order, the
  segment flags and the segment tails; the device gathers, runs the
  segmented scan of ``gpu/scan.py`` with the user combine and gathers the
  tails into a batch of ``bucket_capacity(keys)`` rows (the JAX package
  keeps the input's capacity: the rows past the size are padding either
  way). Int keys emit in ascending key order, others in first-appearance
  order. The combine must be associative and commutative (``API:78-80``).
- ``Reduce_GPU`` global (no key): the whole batch folds to ONE tuple by a
  validity-masked pairwise tree (``masked_tree_reduce``; reference
  ``thrust::reduce``, ``reduce_gpu.hpp:269-272``).

Each operator names its ``fusion_role`` (``topology/stage.py`` legality):
Map and Filter are transforms whose ``device_kernel`` composes mid-chain
(a Filter narrows the chain's ``valid`` mask instead of compacting), and
the Reduce variants may only end a fused chain (``gpu/fused_ops.py``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..basic import ExecutionMode, OpType, RoutingMode, WindFlowError
from ..operators.base import BasicOperator, BasicReplica
from ..runtime.dispatch import DeviceDispatchQueue
from .batch import (BatchGPU, bucket_capacity, host_copies,
                    key_column_np, key_column_to_list, to_device)
from .keymap import stable_group_argsort
from .scan import segmented_scan
from .schema import TupleSchema, canonical


# ---------------------------------------------------------------------------
# host key metadata
# ---------------------------------------------------------------------------
def op_batch_keys(op, batch: BatchGPU):
    """Per-batch keys for ``op``: the host metadata when the staging edge
    attached it, else the device key column named by a string key
    extractor, read back to the host."""
    keys = batch.host_keys
    if keys is None:
        if op.key_field is None or op.key_field not in batch.fields:
            raise WindFlowError(
                f"{op.name}: keyed device operator needs keyed staging "
                "(with_key_by on the op) or a field-name key that is a "
                "column of the batch")
        keys = key_column_to_list(batch, op.key_field)
    return keys


def op_batch_keys_np(op, batch: BatchGPU):
    """``(keys, keys_arr)`` with at most ONE conversion: an int key column
    serves as both forms."""
    keys = batch.host_keys
    if keys is None and op.key_field is not None \
            and op.key_field in batch.fields:
        arr = key_column_np(batch, op.key_field)
        if arr.dtype.kind in "iu":
            return arr, arr
    if keys is None:
        keys = op_batch_keys(op, batch)
    return keys, np.asarray(keys)


def op_batch_slots_np(op, batch: BatchGPU):
    """Per-batch dense slot ids (host numpy, padding rows in one extra
    slot) and the slot -> key map. Int keys take a vectorized unique (slot
    order = sorted keys); others keep first-appearance order."""
    keys = op_batch_keys(op, batch)
    n = batch.size
    keys_arr = np.asarray(keys)
    # ndim guard: tuple-of-int keys become a 2-D int array
    if n and keys_arr.ndim == 1 and keys_arr.dtype.kind in "iu":
        uniq, inv = np.unique(keys_arr[:n], return_inverse=True)
        slots = np.full(batch.capacity, len(uniq), dtype=np.int32)
        slots[:n] = inv
        return slots, {int(k): i for i, k in enumerate(uniq)}
    slot_of_key: Dict[Any, int] = {}
    slots = np.zeros(batch.capacity, dtype=np.int32)
    for i, k in enumerate(keys):
        slots[i] = slot_of_key.setdefault(k, len(slot_of_key))
    slots[n:] = len(slot_of_key)  # padding segment
    return slots, slot_of_key


def reduce_order_and_slots(op, batch: BatchGPU):
    """(order, sorted slot ids, slot -> key map) for a keyed reduce over
    ``batch``, with ONE sort: int keys sort directly (group boundaries give
    the sorted slot ids); other keys go through the slot map and a radix
    argsort of the small dense ids. Padding rows form the last segment."""
    n = batch.size
    cap = batch.capacity
    _, keys_arr = op_batch_keys_np(op, batch)
    if n and keys_arr.ndim == 1 and keys_arr.dtype.kind in "iu":
        k = keys_arr[:n]
        # numpy's stable sort is a radix sort for <= 16-bit ints only:
        # keys that fit int16 take it through a cast, in the same order
        if -2**15 <= int(k.min()) and int(k.max()) < 2**15:
            order_n = np.argsort(k.astype(np.int16), kind="stable")
        else:
            order_n = np.argsort(k, kind="stable")
        sk = k[order_n]
        new_grp = np.r_[True, sk[1:] != sk[:-1]]
        uniq = sk[new_grp]
        slot_of_key = {int(k): i for i, k in enumerate(uniq)}
        order = np.empty(cap, dtype=np.int32)
        order[:n] = order_n
        order[n:] = np.arange(n, cap)
        ssorted = np.full(cap, len(uniq), dtype=np.int32)
        ssorted[:n] = np.cumsum(new_grp) - 1
        return order, ssorted, slot_of_key
    slots_np, slot_of_key = op_batch_slots_np(op, batch)
    order = stable_group_argsort(
        slots_np, len(slot_of_key) + 1).astype(np.int32)
    return order, slots_np[order], slot_of_key


def segment_tails(ssorted: np.ndarray, n_out: int, out_cap: int
                  ) -> np.ndarray:
    """Positions of the last row of each of the first ``n_out`` segments
    of the sorted slot ids, padded to ``out_cap`` with the last row (what
    ``jnp.nonzero(is_last, size=n, fill_value=n - 1)`` gives, taken on
    the host from the order it already has: ``torch.nonzero`` would wait
    for the card)."""
    is_last = np.r_[ssorted[1:] != ssorted[:-1], True]
    tails = np.full(out_cap, len(ssorted) - 1, dtype=np.int32)
    tails[:n_out] = np.flatnonzero(is_last)[:n_out]
    return tails


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------
def compact_order(keep: torch.Tensor):
    """``(order, count)``: the stable keepers-first permutation as GATHER
    indices (int32), via two cumsums and one scatter (equivalent to
    ``argsort(~keep, stable)`` without a sort), and the kept count."""
    keep = keep.to(torch.bool)  # int 0/1 masks: ~keep would be bitwise NOT
    n = keep.shape[0]
    count = keep.sum()
    p_keep = torch.cumsum(keep, 0) - 1
    p_drop = count + torch.cumsum(~keep, 0) - 1
    pos = torch.where(keep, p_keep, p_drop)
    order = torch.empty(n, dtype=torch.int32, device=keep.device)
    order[pos] = torch.arange(n, dtype=torch.int32, device=keep.device)
    return order, count


def masked_tree_reduce(combine: Callable, fields: Dict[str, torch.Tensor],
                       valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Whole-batch fold to one tuple: a validity-masked pairwise halving
    (log2 passes; associativity is the contract). A field the combine
    does not return passes through from the later half. The result is
    garbage when no row is valid: callers skip empty batches."""
    n = next(iter(fields.values())).shape[0]
    # pad to a power of two so the halving never drops an odd tail (an
    # upstream Ffat_Windows_GPU emits batches of num_win_per_batch rows)
    m = 1 << max(0, n - 1).bit_length()
    if m != n:
        fields = {k: torch.cat([v, v.new_zeros((m - n,) + v.shape[1:])])
                  for k, v in fields.items()}
        valid = torch.cat([valid, valid.new_zeros(m - n)])
    cur, vcur = fields, valid
    length = m
    while length > 1:
        half = length // 2
        a = {k: v[:half] for k, v in cur.items()}
        b = {k: v[half:] for k, v in cur.items()}
        va, vb = vcur[:half], vcur[half:]
        merged = combine(a, b)
        both = va & vb
        cur = {k: torch.where(both, merged.get(k, b[k]),
                              torch.where(va, a[k], b[k]))
               for k in cur}
        vcur = va | vb
        length = half
    return {k: v[:1] for k, v in cur.items()}


def row_mask(capacity: int, size: int, device: torch.device
             ) -> torch.Tensor:
    """The rows of a batch that hold tuples (the rest is padding)."""
    return torch.arange(capacity, device=device) < size


def filter_program(pred: Callable, fields: Dict[str, torch.Tensor],
                   size: int):
    """``(out, order, count)``: the keep mask of the first ``size`` rows,
    its compaction permutation and the columns gathered keepers first."""
    first = next(iter(fields.values()))
    keep = pred(dict(fields)).to(torch.bool) \
        & row_mask(first.shape[0], size, first.device)
    order, count = compact_order(keep)
    return {k: v[order] for k, v in fields.items()}, order, count


def keyed_reduce_program(combine: Callable, fields: Dict[str, torch.Tensor],
                         order: torch.Tensor, same_prev: torch.Tensor,
                         tails: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One partial per key: gather the rows in key order, scan each key's
    segment with the combine, gather the segment tails."""
    scanned = segmented_scan(combine, {k: v[order]
                                       for k, v in fields.items()},
                             same_prev)
    return {k: v[tails] for k, v in scanned.items()}


# ---------------------------------------------------------------------------
# shared replica machinery
# ---------------------------------------------------------------------------
class GPUReplicaBase(BasicReplica):
    """Processes whole device batches through the dispatch pipeline; the
    queue drains at every ordering point (punctuation, EOS, idle tick)."""

    def __init__(self, op: BasicOperator, idx: int) -> None:
        super().__init__(op, idx)
        self.device = op.device
        self.dispatch = DeviceDispatchQueue(stats=self.stats,
                                            megabatch=op.megabatch)

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
        None when the batch needs no device work). The default defers the
        whole ``process_device_batch`` to the commit stage."""
        return lambda: self.process_device_batch(batch)

    def process_device_batch(self, batch: BatchGPU) -> None:
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

    def emit_compacted(self, batch: BatchGPU, out_fields, order: np.ndarray,
                       count: int) -> None:
        """Emit a compaction result: device columns reordered keepers
        first, host ts and keys reordered to match; an empty result is
        dropped (watermarks travel by punctuation)."""
        new_size = int(count)
        self.stats.inputs_ignored += batch.size - new_size
        if new_size == 0:
            return
        keys2 = batch.host_keys
        if keys2 is not None:
            kept = order[:new_size]
            keys2 = (keys2[kept] if isinstance(keys2, np.ndarray)
                     else [keys2[j] for j in kept])
        nb = BatchGPU(out_fields, batch.ts_host[order], new_size,
                      batch.schema, batch.wm, keys2)
        nb.stream_tag = batch.stream_tag
        self._emit_batch(nb)


class GPUOperatorBase(BasicOperator):
    op_type = OpType.GPU
    is_gpu = True

    def __init__(self, name: str, parallelism: int, input_routing: RoutingMode,
                 key_extractor, output_batch_size: int,
                 schema: Optional[TupleSchema]) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size)
        self.schema = schema  # None => inferred at the staging boundary
        # megabatch width of the replicas' dispatch queues: the graph's
        # PipeGraph(megabatch=K), set before the replicas are built
        self.megabatch = 1

    @property
    def is_chainable(self) -> bool:
        return False

    @property
    def fusion_role(self) -> Optional[str]:
        """Device-chain fusion classification (``topology/stage.py``):
        ``"transform"`` composes mid-chain through its ``device_kernel``;
        ``"terminator"`` / ``"keyed_terminator"`` / ``"window_terminator"``
        may only end a fused chain; None never fuses."""
        return None

    def device_kernel(self) -> Callable:
        """The operator's composable ``(fields, valid, carry) -> (fields,
        valid, carry)`` kernel (stateless transforms only)."""
        raise WindFlowError(f"{self.name}: no composable device kernel")

    def configure(self, execution_mode, time_policy, device) -> None:
        if execution_mode is not ExecutionMode.DEFAULT:
            # reference: GPU operators only in DEFAULT mode
            # (map_gpu.hpp:470-478)
            raise WindFlowError(
                f"{self.name}: GPU operators require DEFAULT execution mode")
        super().configure(execution_mode, time_policy, device)


# ---------------------------------------------------------------------------
# Map_GPU
# ---------------------------------------------------------------------------
class Map_GPU(GPUOperatorBase):
    """Stateless: ``func(fields) -> fields`` over the batch's columns."""

    def __init__(self, func: Callable, name: str = "map_gpu",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None, output_batch_size: int = 0,
                 schema: Optional[TupleSchema] = None) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size, schema)
        self.func = func

    @property
    def fusion_role(self) -> Optional[str]:
        return "transform"

    def apply(self, fields: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """``func`` over the columns, its output in canonical dtypes."""
        out = self.func(dict(fields))
        if not isinstance(out, dict):
            raise WindFlowError(f"{self.name}: Map_GPU function must "
                                "return a dict of columns")
        return {k: canonical(v) for k, v in out.items()}

    def device_kernel(self) -> Callable:
        apply = self.apply

        def kernel(fields, valid, carry):
            return apply(fields), valid, carry

        return kernel

    def build_replicas(self) -> None:
        self.replicas = [MapGPUReplica(self, i)
                         for i in range(self.parallelism)]


class MapGPUReplica(GPUReplicaBase):
    def process_device_batch(self, batch: BatchGPU) -> None:
        out = self.op.apply(batch.fields)
        self.stats.device_programs_run += 1
        self._emit_batch(batch.with_fields(out))


# ---------------------------------------------------------------------------
# Filter_GPU
# ---------------------------------------------------------------------------
class Filter_GPU(GPUOperatorBase):
    """Stateless: ``pred(fields)`` gives the keep mask; the batch compacts
    and an empty result is dropped."""

    def __init__(self, pred: Callable, name: str = "filter_gpu",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None, output_batch_size: int = 0,
                 schema: Optional[TupleSchema] = None) -> None:
        super().__init__(name, parallelism, input_routing, key_extractor,
                         output_batch_size, schema)
        self.pred = pred

    @property
    def fusion_role(self) -> Optional[str]:
        return "transform"

    def device_kernel(self) -> Callable:
        pred = self.pred

        def kernel(fields, valid, carry):
            # narrow the keep mask instead of compacting: the chain exit
            # compacts once. An int 0/1 mask must not reach ``&`` raw
            return fields, valid & pred(dict(fields)).to(torch.bool), carry

        return kernel

    def build_replicas(self) -> None:
        self.replicas = [FilterGPUReplica(self, i)
                         for i in range(self.parallelism)]


class FilterGPUReplica(GPUReplicaBase):
    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        # the program is queued on the card now; the commit stage waits
        # for its (order, count) readback, by when later batches' programs
        # are queued behind it
        out, order, count = filter_program(self.op.pred, batch.fields,
                                           batch.size)
        self.stats.device_programs_run += 1
        host, event = host_copies({"order": order, "count": count})

        def commit() -> None:
            if event is not None:
                event.synchronize()
            self.emit_compacted(batch, out, host["order"].numpy(),
                                int(host["count"]))

        return commit


# ---------------------------------------------------------------------------
# Reduce_GPU
# ---------------------------------------------------------------------------
class Reduce_GPU(GPUOperatorBase):
    """Per-batch combine (``combine(fields_a, fields_b) -> fields``,
    associative and commutative). Keyed (key extractor given): one output
    per distinct key per batch. Global (no key): the whole batch folds to
    ONE output tuple."""

    def __init__(self, combine: Callable, key_extractor=None,
                 name: str = "reduce_gpu", parallelism: int = 1,
                 output_batch_size: int = 0,
                 schema: Optional[TupleSchema] = None) -> None:
        routing = (RoutingMode.KEYBY if key_extractor is not None
                   else RoutingMode.FORWARD)
        super().__init__(name, parallelism, routing, key_extractor,
                         output_batch_size, schema)
        self.combine = combine

    @property
    def fusion_role(self) -> Optional[str]:
        # both variants change cardinality, so both may only END a fused
        # chain; the keyed one only where its KEYBY shuffle is the
        # identity (topology/stage.py)
        return ("terminator" if self.key_extractor is None
                else "keyed_terminator")

    def build_replicas(self) -> None:
        cls = (ReduceGPUReplica if self.key_extractor is not None
               else GlobalReduceGPUReplica)
        self.replicas = [cls(self, i) for i in range(self.parallelism)]


class GlobalReduceGPUReplica(GPUReplicaBase):
    """Whole-batch fold to one tuple via ``masked_tree_reduce``; its ts is
    the batch's largest."""

    def process_device_batch(self, batch: BatchGPU) -> None:
        if batch.size == 0:
            return
        out = masked_tree_reduce(self.op.combine, batch.fields,
                                 row_mask(batch.capacity, batch.size,
                                          self.device))
        self.stats.device_programs_run += 1
        ts = np.array([int(batch.ts_host[:batch.size].max())],
                      dtype=np.int64)
        nb = BatchGPU(out, ts, 1, batch.schema, batch.wm)
        nb.stream_tag = batch.stream_tag
        self._emit_batch(nb)


class ReduceGPUReplica(GPUReplicaBase):
    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        # host prep: ONE key sort, the segment flags and tails; the
        # program and the output batch are the deferred commit stage
        order_np, ssorted, slot_of_key = reduce_order_and_slots(self.op,
                                                                batch)
        n_out = len(slot_of_key)
        if n_out == 0:
            return None
        out_cap = bucket_capacity(n_out)
        dev = self.device
        order = to_device(order_np, dev)
        same_prev = to_device(np.r_[False, ssorted[1:] == ssorted[:-1]],
                              dev)
        tails = to_device(segment_tails(ssorted, n_out, out_cap), dev)
        out_keys = list(slot_of_key)  # insertion order == slot order
        ts = np.full(out_cap, int(batch.ts_host[:batch.size].max()),
                     dtype=np.int64)

        def commit() -> None:
            out = keyed_reduce_program(self.op.combine, batch.fields, order,
                                       same_prev, tails)
            self.stats.device_programs_run += 1
            nb = BatchGPU(out, ts, n_out, batch.schema, batch.wm, out_keys)
            nb.stream_tag = batch.stream_tag
            self._emit_batch(nb)

        return commit
