"""Device operators Map_GPU, Filter_GPU and Reduce_GPU, and the machinery
every device operator shares.

The port of ``windflow_tpu/tpu/ops_tpu.py`` (reference: WindFlow's
``wf/map_gpu.hpp``, ``wf/filter_gpu.hpp``, ``wf/reduce_gpu.hpp``), without
error policies and the incremental (delta) snapshots of keyed state. A
device replica processes whole ``BatchGPU`` messages and never iterates
rows; its per-batch work is split into a host-prep stage and a
device-commit stage pipelined through a ``DeviceDispatchQueue`` (see
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
- Stateful ``Map_GPU`` / ``Filter_GPU`` (``state_init`` given, keyed):
  ``func(row, state) -> (row, state)`` / ``pred(row, state) -> (keep,
  state)`` over 0-d tensors, applied under ``torch.func.vmap`` (the
  counterpart of the JAX package's ``jax.vmap``: the same contract, no
  data-dependent Python control flow). Per-key state lives in a device
  table updated in arrival order by the keyed grid scan (K8 of the JAX
  package; ``kernels/grid_scan.py``: on a card a hand kernel with the step
  compiled in, one thread a key; on the CPU the plain version
  ``grid_scan_core``) driven by ``_KeyedStateScan``, optionally in front
  of the host cold tier of ``state/tiered.py``.
- ``Reduce_GPU`` keyed: one output per distinct key per batch (reference
  ``reduce_by_key``, ``reduce_gpu.hpp:245-251``). The HOST sorts the keys
  once (``reduce_order_and_slots``) and ships the gather order, the
  sorted slots and each slot's first sorted row (``slot_starts``) in one
  copy (``fold_rows_to_device``); the device folds each key's rows
  into its slot of a batch of ``bucket_capacity(keys)`` rows in one
  launch (K7, ``kernels/reduce_fold.py`` ``keyed_fold``; on the CPU its
  plain version, the segmented scan of ``gpu/scan.py``). The JAX package
  keeps the input's capacity: the rows past the size are padding either
  way (zeros here, the last key's fold there). Int keys emit in ascending
  key order, others in first-appearance order. The combine must be
  associative and commutative (``API:78-80``).
- ``Reduce_GPU`` global (no key): the whole batch folds to ONE tuple by a
  validity-masked pairwise tree (K6, ``kernels/reduce_fold.py``
  ``tree_reduce`` over the batch's first ``size`` rows, one launch;
  reference ``thrust::reduce``, ``reduce_gpu.hpp:269-272``).

On a card both reduces trace the combine at the first prep
(``reduce_fold.prepare``): a computed field outside the traced language
raises ``WindFlowError`` there; any other column passes through.

Each operator names its ``fusion_role`` (``topology/stage.py`` legality):
Map and Filter are transforms whose ``device_kernel`` composes mid-chain
(a Filter narrows the chain's ``valid`` mask instead of compacting; a
stateful one brings its grid-scan engine instead, ``gpu/fused_ops.py``),
and the Reduce variants may only end a fused chain.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..basic import (ExecutionMode, KeyCapacityError, OpType, RoutingMode,
                     WindFlowError)
from ..checkpoint import delta as ckpt_delta
from ..kernels.build import BUILD_INFO
from ..kernels import reduce_fold
from ..kernels.grid_scan import (HEAVY_ROWS, GridStep, KeyRows, grid_walk,
                                  heavy_keys)
from ..monitoring.flightrec import note_kernel_load
from ..operators.base import BasicOperator, BasicReplica
from ..pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..monitoring.tracing import device_span
from ..runtime.dispatch import DeviceDispatchQueue
from ..state.tiered import TieredKeyStore, hot_table_digest
from .batch import (BatchGPU, bucket_capacity, host_copies, zero_fields,
                    key_column_np, key_column_to_list, to_device)
from .keymap import (KeySlotMap, distinct_batch_keys,
                     stable_group_argsort, structured_unique)
from .schema import TupleSchema, canonical, numpy_dtype


# ---------------------------------------------------------------------------
# host key metadata
# ---------------------------------------------------------------------------
def op_batch_keys(op, batch: BatchGPU):
    """Per-batch keys for ``op``: the host metadata when the staging edge
    attached it, else the device key column named by a string key
    extractor (or the stacked columns of a composite key), read back to
    the host."""
    keys = batch.host_keys
    if keys is None:
        if op.key_fields:
            from .emitters_gpu import composite_keys_from_device
            return composite_keys_from_device(batch, op.key_fields)
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
    if n and keys_arr.ndim == 1 and keys_arr.dtype.kind == "V" \
            and keys_arr.dtype.names:
        # structured composite keys: one unique per batch, the slot map
        # keyed by plain tuples (the shared dedup of keymap.py; None: an
        # object field, the row loop below)
        uu = structured_unique(keys_arr, n)
        if uu is None:
            keys = keys_arr[:n].tolist()
        else:
            uniq, inv = uu
            slots = np.full(batch.capacity, len(uniq), dtype=np.int32)
            slots[:n] = inv
            return slots, {k.item(): i for i, k in enumerate(uniq)}
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


def slot_starts(ssorted: np.ndarray, n_slots: int):
    """``(starts, longest run)`` of the ascending slots ``ssorted`` (the
    padding rows on ``n_slots``, last): int32 ``starts[s]`` is slot s's
    first sorted row, ``starts[n_slots]`` the live rows' end (K7's
    ``starts``)."""
    starts = np.searchsorted(ssorted, np.arange(n_slots + 1,
                                                dtype=ssorted.dtype))
    return (starts.astype(np.int32),
            int(np.diff(starts).max()) if n_slots else 0)


def fold_rows_to_device(order: np.ndarray, ssorted: np.ndarray,
                        starts: np.ndarray, device: torch.device):
    """``(order, ssorted, starts)`` on ``device`` from ONE host-to-device
    copy of the three int32 arrays (views of one tensor)."""
    dev = to_device(np.concatenate([order, ssorted, starts]), device)
    n = len(order)
    return dev[:n], dev[n:2 * n], dev[2 * n:]


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


# ---------------------------------------------------------------------------
# shared replica machinery
# ---------------------------------------------------------------------------
class GPUReplicaBase(BasicReplica):
    """Processes whole device batches through the dispatch pipeline; the
    queue drains at every ordering point (punctuation, EOS, idle tick).

    Under a non-FAIL error policy (``supervision/errors.py``) a batch's
    commit runs synchronously, so that an error belongs to this exact
    batch, and a failing batch is halved until the poison record is alone
    and the policy applies to it (``_process_batch_guarded``)."""

    def __init__(self, op: BasicOperator, idx: int) -> None:
        super().__init__(op, idx)
        self.device = op.device
        self.dispatch = DeviceDispatchQueue(stats=self.stats,
                                            megabatch=op.megabatch)
        # the host-prep stage's profiler span (with tracing on; the commit
        # span lives in the dispatch queue)
        self._span_prep = f"wf:prep:{op.name}"
        pol = op.error_policy
        self._err_policy = pol if pol is not None and not pol.is_fail \
            else None

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
        st = self.stats
        st.start_svc()
        st.inputs_received += msg.size
        st.device_batches_in += 1
        if st.sample_every:  # per batch, not per tuple
            st._svc_rec = True
        self._advance_wm(msg.wm)
        msg.wm = self.cur_wm
        if self._err_policy is not None:
            self._process_batch_guarded(msg)
            self.stats.end_svc(msg.size)
            return
        t0 = time.perf_counter()
        with device_span(self._span_prep, st.sample_every > 0):
            commit = self.prep_device_batch(msg)
        prep_us = (time.perf_counter() - t0) * 1e6
        if commit is not None:
            self.dispatch.submit(commit, prep_us)
        else:
            self.stats.note_host_prep(prep_us)
        self.stats.end_svc(msg.size)

    def _process_batch_guarded(self, msg: BatchGPU) -> None:
        """The policy-guarded batch path: prep, then the commit at once
        (submit and a forced drain), so that an error attributes to this
        batch; a failing batch is bisected until the offender is alone.
        A stateless transform bisects safely; a stateful one whose failed
        commit already updated its table keeps that update (the FAIL
        policy is the strict choice for stateful device operators). A
        sticky CUDA error is not bisected: the context is poisoned and
        every half would fail the same way."""
        from ..supervision.errors import (apply_record_policy,
                                          batch_row_payload,
                                          is_sticky_device_error,
                                          split_batch)
        try:
            t0 = time.perf_counter()
            commit = self.prep_device_batch(msg)
            prep_us = (time.perf_counter() - t0) * 1e6
            if commit is not None:
                self.dispatch.submit(commit, prep_us)
                self.dispatch.drain(forced=True)
            else:
                self.stats.note_host_prep(prep_us)
        except Exception as exc:  # noqa: BLE001 — the policy boundary
            if is_sticky_device_error(exc):
                raise
            if msg.size <= 1:
                payload = batch_row_payload(msg, 0) if msg.size else {}
                ts = int(msg.ts_host[0]) if msg.size else 0
                apply_record_policy(self, self._err_policy, payload, ts,
                                    exc)
                return
            for half in split_batch(msg):
                self._process_batch_guarded(half)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        """Host-prep stage: return this batch's device-commit thunk (or
        None when the batch needs no device work). The default defers the
        whole ``process_device_batch`` to the commit stage."""
        return lambda: self.process_device_batch(batch)

    def process_device_batch(self, batch: BatchGPU) -> None:
        raise NotImplementedError

    def on_idle(self) -> bool:
        return self.dispatch.on_idle()

    # -- prewarm (PipeGraph.with_prewarm) -------------------------------------
    def _prewarm_schema(self) -> Optional[TupleSchema]:
        return self.op.schema

    def _warm_program(self, fields: Dict[str, torch.Tensor],
                      cap: int) -> None:
        """The replica's device program on zero columns of one capacity
        bucket, with no state and no emit; None (the default) marks a
        replica whose program depends on the stream (stateful)."""
        raise NotImplementedError

    def prewarm(self, caps) -> Optional[int]:
        """Run the device program once per capacity bucket before the
        stream starts: the first allocations of every bucket (the caching
        allocator's blocks, library handles) land here, not on batch 0.
        None when the schema is inferred at the staging boundary or the
        program depends on the stream (stateful replicas)."""
        sch = self._prewarm_schema()
        if sch is None or type(self)._warm_program \
                is GPUReplicaBase._warm_program:
            return None
        for cap in caps:
            self._warm_program(zero_fields(sch, cap, self.device), cap)
        return len(caps)

    def terminate(self) -> None:
        if not self.terminated:
            self.dispatch.drain(forced=True)
        super().terminate()

    def snapshot_state(self) -> dict:
        """The replica's state as a picklable dict, the JAX package's
        layout (stateful subclasses add their engine's under ``scan``);
        device state is never captured with commits in flight."""
        self.dispatch.drain(forced=True)
        return {"cur_wm": self.cur_wm}

    def restore_state(self, state: dict) -> None:
        """Inverse of ``snapshot_state``, before the replica's worker
        starts."""
        self.cur_wm = state.get("cur_wm", 0)
        self.stats.wm_current = self.cur_wm

    def _emit_batch(self, batch: BatchGPU) -> None:
        st = self.stats
        st.device_batches_out += 1
        rec = st.recorder
        if rec is not None:  # per device batch, not per tuple
            rec.event("emit", 0.0, batch.size)
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
        self._emit_batch(nb.copy_trace_from(batch))



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
def _stateful_routing(kind: str, name: str, state_init, tiering,
                      key_extractor, input_routing) -> RoutingMode:
    """The JAX package's refusals for keyed state; stateful means KEYBY."""
    if state_init is not None and key_extractor is None:
        raise WindFlowError(f"{name}: stateful {kind} requires a key "
                            "extractor (KEYBY)")
    if tiering is not None and state_init is None:
        raise WindFlowError(f"{name}: with_tiering requires keyed state "
                            "(with_state)")
    return RoutingMode.KEYBY if state_init is not None else input_routing


class Map_GPU(GPUOperatorBase):
    """Stateless: ``func(fields) -> fields`` over the batch's columns.
    Stateful (``state_init`` given): ``func(row, state) -> (row, state)``
    over 0-d tensors, scanned in arrival order with per-key state."""

    def __init__(self, func: Callable, name: str = "map_gpu",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None, output_batch_size: int = 0,
                 schema: Optional[TupleSchema] = None,
                 state_init: Any = None, tiering=None) -> None:
        routing = _stateful_routing("Map_GPU", name, state_init, tiering,
                                    key_extractor, input_routing)
        super().__init__(name, parallelism, routing, key_extractor,
                         output_batch_size, schema)
        self.func = func
        self.state_init = state_init
        self.tiering = tiering

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
        if self.state_init is not None:
            raise WindFlowError(f"{self.name}: stateful Map_GPU carries a "
                                "grid-scan engine, not a stateless kernel")
        apply = self.apply

        def kernel(fields, valid, carry):
            return apply(fields), valid, carry

        return kernel

    def build_replicas(self) -> None:
        cls = (StatefulMapGPUReplica if self.state_init is not None
               else MapGPUReplica)
        self.replicas = [cls(self, i) for i in range(self.parallelism)]


class MapGPUReplica(GPUReplicaBase):
    def _warm_program(self, fields, cap: int) -> None:
        self.op.apply(fields)

    def process_device_batch(self, batch: BatchGPU) -> None:
        out = self.op.apply(batch.fields)
        self.stats.device_programs_run += 1
        self._emit_batch(batch.with_fields(out))


# ---------------------------------------------------------------------------
# Filter_GPU
# ---------------------------------------------------------------------------
class Filter_GPU(GPUOperatorBase):
    """Stateless: ``pred(fields)`` gives the keep mask; the batch compacts
    and an empty result is dropped. Stateful (``state_init`` given):
    ``pred(row, state) -> (keep, state)`` over 0-d tensors with per-key
    state (grid scan)."""

    def __init__(self, pred: Callable, name: str = "filter_gpu",
                 parallelism: int = 1,
                 input_routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None, output_batch_size: int = 0,
                 schema: Optional[TupleSchema] = None,
                 state_init: Any = None, tiering=None) -> None:
        routing = _stateful_routing("Filter_GPU", name, state_init, tiering,
                                    key_extractor, input_routing)
        super().__init__(name, parallelism, routing, key_extractor,
                         output_batch_size, schema)
        self.pred = pred
        self.state_init = state_init
        self.tiering = tiering

    @property
    def fusion_role(self) -> Optional[str]:
        return "transform"

    def device_kernel(self) -> Callable:
        if self.state_init is not None:
            raise WindFlowError(f"{self.name}: stateful Filter_GPU carries "
                                "a grid-scan engine, not a stateless kernel")
        pred = self.pred

        def kernel(fields, valid, carry):
            # narrow the keep mask instead of compacting: the chain exit
            # compacts once. An int 0/1 mask must not reach ``&`` raw
            return fields, valid & pred(dict(fields)).to(torch.bool), carry

        return kernel

    def build_replicas(self) -> None:
        cls = (StatefulFilterGPUReplica if self.state_init is not None
               else FilterGPUReplica)
        self.replicas = [cls(self, i) for i in range(self.parallelism)]


class FilterGPUReplica(GPUReplicaBase):
    def _warm_program(self, fields, cap: int) -> None:
        filter_program(self.op.pred, fields, cap)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        # the program is queued on the card now; the commit stage waits
        # for its (order, count) readback, by when later batches' programs
        # are queued behind it
        out, order, count = filter_program(self.op.pred, batch.fields,
                                           batch.size)
        self.stats.device_programs_run += 1
        host, event = host_copies({"order": order, "count": count})

        def commit() -> None:
            rec = self.stats.recorder
            t0 = time.perf_counter() if rec is not None else 0.0
            if event is not None:
                event.synchronize()
            count = int(host["count"])
            if rec is not None:  # the compaction readback's wait
                rec.event("readback", (time.perf_counter() - t0) * 1e6,
                          {"kept": count, "of": batch.size})
            self.emit_compacted(batch, out, host["order"].numpy(), count)

        return commit


# ---------------------------------------------------------------------------
# keyed device state: the grid-scan engine and the stateful replicas
# ---------------------------------------------------------------------------
class _KeyedStateScan:
    """Keyed device state for stateful Map/Filter (the JAX package's
    ``_KeyedStateScan``, ``ops_tpu.py:623-990``).

    The reference runs one CUDA worker per distinct key walking its chain
    of tuples serially (``map_gpu.hpp:80-102``), and so does K8's kernel
    on a card (``kernels/grid_scan.py``: the step traced and compiled in,
    one thread a touched key walking the batch's rows grouped by key,
    ``KeyRows``); on the CPU the plain version, a (KB x M) GRID scan,
    walks the per-key POSITION axis (M = most tuples of one key in the
    batch) while ``vmap`` covers the batch's KB keys each step
    (``grid_scan_core``). A step the tracer refuses raises
    ``WindFlowError`` on a card at the first prep (a stateful op behind
    another in a fused chain: at its first commit), naming the operation.
    State lives in a device table pytree between
    batches: one ``(table_capacity + 1,)`` tensor per state leaf, the last
    row scratch, with a touched-slot ``dirty`` bitmap beside it. Commits
    update the touched rows in place, in commit order; growth copies the
    rows into a fresh table only after draining the commits in flight.
    With ``with_tiering`` the table is the hot tier of a
    ``TieredKeyStore``, fixed at ``hot_capacity``.

    Under ``with_checkpointing(delta=True)`` a FULL snapshot taken for a
    checkpoint becomes the engine's delta base: the bitmap (and a tiered
    store's cold WAL) restart from it, and later captures ship only the
    dirty rows (``snapshot_state``) until the FULL cadence is due, the
    table grows, or a restore starts a fresh lineage.
    """

    def __init__(self, replica, func: Callable, state_init: Any,
                 filter_mode: bool, op=None) -> None:
        self.replica = replica
        self.state_init = state_init
        # ``op`` overrides the owner: a fused chain replica hosts one
        # engine per stateful SUB-operator, each resolving keys with its
        # own op
        self.op = replica.op if op is None else op
        leaves, self._spec = tree_flatten(state_init)
        # the JAX package's x64-off dtypes: int64 -> int32, float64 ->
        # float32 (``{"acc": np.int64(0)}`` is an int32 table there)
        self._init = [canonical(torch.as_tensor(v).detach().cpu())
                      for v in leaves]
        if any(t.dim() for t in self._init):
            raise WindFlowError(f"{self.op.name}: state leaves must be "
                                "scalars (one value per key)")
        self._keymap = KeySlotMap()
        self.slot_of_key = self._keymap.slot_of_key  # shared dict
        self.table_capacity = 64
        self.table = None  # pytree of (table_capacity + 1,) tensors
        self.dirty = None  # (table_capacity + 1,) bool
        self.step = GridStep(func, filter_mode)
        self._loaded: set = set()  # step libraries this engine loaded
        # delta lineage: the epoch of the last FULL snapshot taken for a
        # checkpoint with deltas on, captures since, and the capacity and
        # key count at that base
        self._delta_base: Optional[int] = None
        self._snaps_since_full = 0
        self._base_capacity: Optional[int] = None
        self._base_nkeys: Optional[int] = None
        self.tier = None
        cfg = getattr(self.op, "tiering", None)
        if cfg is not None:
            self.tier = TieredKeyStore(
                f"{self.op.name}_r{replica.idx}_tier", cfg,
                stats=replica.stats)
            self.table_capacity = self.tier.hot_capacity

    # -- device program ----------------------------------------------------
    def load_step(self, fields: Dict[str, torch.Tensor]):
        """On a card: trace the step over columns like ``fields`` (cached
        per dtypes) and build or load its library, recording the first
        load per library as this replica's compile event. Raises
        ``WindFlowError`` for a step the kernel cannot take."""
        state = (self.table if self.table is not None
                 else tree_unflatten(self._spec, self._init))
        v = self.step.variant(fields, state)
        if v.tag not in self._loaded:
            t0 = time.perf_counter()
            v.load()
            built = BUILD_INFO.get(v.library, {}).get("seconds", 0.0) > 0
            note_kernel_load(self.replica.stats, v.library,
                             (time.perf_counter() - t0) * 1e6, built)
            self._loaded.add(v.tag)
        return v

    def run(self, fields, valid, rows: KeyRows):
        """One batch's keyed scan on the table as it is NOW (commit time):
        K8's kernel on a card, the plain version on the CPU."""
        if self.device.type == "cuda":
            self.load_step(fields)
        return grid_walk(self.step, fields, valid, rows, self.table,
                         self.dirty)

    # -- host side ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.replica.device

    def _fresh(self, cap: int) -> list:
        """Table leaves of ``cap`` rows (and the scratch row) at the
        initial state."""
        return [torch.empty(cap + 1, dtype=v.dtype, device=self.device)
                .fill_(v) for v in self._init]

    def _ensure_table(self, n_keys_needed: int) -> None:
        if self.table is None:
            self.table = tree_unflatten(self._spec,
                                        self._fresh(self.table_capacity))
        self._sync_dirty()
        if self.tier is not None:
            # tiered: the table IS the hot tier, fixed at hot_capacity;
            # plan_batch guarantees the mapped keys fit
            if n_keys_needed > self.table_capacity:  # pragma: no cover
                raise KeyCapacityError(self.op.name, self.table_capacity,
                                       n_keys_needed - self.table_capacity)
            return
        if n_keys_needed <= self.table_capacity:
            return
        # growth reads the CURRENT table: commits in flight update it in
        # place, so they must land first
        self.replica.dispatch.drain(forced=True)
        old_cap = self.table_capacity
        while n_keys_needed > self.table_capacity:
            self.table_capacity *= 2
        fresh = self._fresh(self.table_capacity)
        for f, o in zip(fresh, tree_leaves(self.table)):
            f[:old_cap] = o[:old_cap]
        self.table = tree_unflatten(self._spec, fresh)
        self._sync_dirty()

    def _sync_dirty(self) -> None:
        """Keep the dirty bitmap allocated and shaped like the table; growth
        carries the old bits over (grown rows hold the initial state and
        are marked when first touched)."""
        if self.table is None:
            return
        cap = self.table_capacity
        if self.dirty is None:
            self.dirty = torch.zeros(cap + 1, dtype=torch.bool,
                                     device=self.device)
        elif self.dirty.shape[0] != cap + 1:
            old = self.dirty[:-1]
            self.dirty = torch.zeros(cap + 1, dtype=torch.bool,
                                     device=self.device)
            self.dirty[:old.shape[0]] = old

    def grid_meta(self, batch: BatchGPU) -> KeyRows:
        """The batch's rows grouped by key, as host numpy arrays in a
        ``KeyRows``: ``order`` over the batch's capacity (each key's rows
        in arrival order, key after key, then the padding rows),
        ``starts``, the touched table rows padded to KB (a power of two),
        their count, the plain version's depth M (a power of two at
        or above the most rows of one key; megabatch groups key on it as
        the JAX package's compiled scans do), and the keys of
        ``HEAVY_ROWS`` rows or more, longest first, for the kernel's
        block regime (``heavy_keys``). Global slots come from the
        KeySlotMap; touched rows and dense local ids from a bincount when
        the table is batch-sized, else from ``np.unique`` (a bincount
        would pay O(table) per batch); the grouping from a radix
        argsort."""
        n = batch.size
        cap = batch.capacity
        keys, keys_arr = op_batch_keys_np(self.op, batch)
        if self.tier is not None and n:
            plan = self.tier.plan_batch(
                self._keymap, distinct_batch_keys(keys, keys_arr, n))
            if plan is not None:
                self._submit_tier_plan(plan)
            self.tier.publish_gauges(len(self.slot_of_key))
        gslots = self._keymap.slots_of(keys, keys_arr, n)
        self._ensure_table(len(self.slot_of_key))
        if self.table_capacity <= 4 * max(1, n):
            # touched rows + dense local ids, O(n + table) via bincount
            cnt = np.bincount(gslots, minlength=self.table_capacity)
            touched_list = np.nonzero(cnt)[0]
            lmap = np.zeros(self.table_capacity, dtype=np.int64)
            lmap[touched_list] = np.arange(len(touched_list))
            lslots = lmap[gslots]
        else:  # high cardinality: O(n log n) beats O(table_capacity)
            touched_list, lslots = np.unique(gslots, return_inverse=True)
        n_touched = len(touched_list)
        KB = 1
        while KB < max(1, n_touched):
            KB <<= 1
        counts = np.bincount(lslots, minlength=KB)
        most = int(counts.max()) if n else 1
        M = 1
        while M < most:
            M <<= 1
        touched = np.zeros(KB, dtype=np.int32)
        touched[:n_touched] = touched_list
        order = np.empty(cap, dtype=np.int32)
        order[:n] = stable_group_argsort(lslots, n_touched)
        order[n:] = np.arange(n, cap)
        starts = np.zeros(KB + 1, dtype=np.int32)
        np.cumsum(counts, out=starts[1:])
        heavy = (heavy_keys(counts[:n_touched], HEAVY_ROWS)
                 if most >= HEAVY_ROWS else None)
        return KeyRows(order, starts, touched, n_touched, M, n, heavy,
                       0 if heavy is None else len(heavy), HEAVY_ROWS)

    def prep(self, batch: BatchGPU, fields=None) -> KeyRows:
        """Host prep of one batch: its ``KeyRows`` on the device
        (``non_blocking`` H2D). ``fields``: the columns the step will see
        (a standalone replica's batch; a fused chain loads its steps
        itself, ``_load_steps``): on a card the step is traced and its
        library loaded here, before the first commit."""
        rows = self.grid_meta(batch)
        dev = self.device
        if fields is not None and dev.type == "cuda":
            self.load_step(fields)
        heavy = rows.heavy
        if heavy is None:
            starts = to_device(rows.starts, dev)
        else:  # the heavy list rides in the starts' copy
            ns = rows.starts.shape[0]
            both = to_device(np.concatenate([rows.starts, heavy]), dev)
            starts, heavy = both[:ns], both[ns:]
        return rows._replace(order=to_device(rows.order, dev), starts=starts,
                             touched=to_device(rows.touched, dev),
                             heavy=heavy)

    # -- tiered data movement ----------------------------------------------
    def _submit_tier_plan(self, plan) -> None:
        """Queue one batch's tier maintenance on the replica's dispatch
        queue: the batch's own commit is submitted after prep returns, so
        this lands behind every commit in flight and ahead of the batch
        that needs the promoted rows. ONE slot-row gather per leaf for the
        demotes (read back through pinned buffers and one event), ONE
        scatter per leaf for the promotes; never per-key transfers."""
        tier = self.tier

        def tier_commit() -> None:
            self._ensure_table(0)  # first batch: allocate the hot tier
            t0 = time.perf_counter()
            leaves = tree_leaves(self.table)
            dev = self.device
            if len(plan.demote_keys):
                dslots = to_device(plan.demote_slots, dev)
                host, event = host_copies(
                    {str(i): lf[dslots] for i, lf in enumerate(leaves)})
                if event is not None:
                    event.synchronize()
                tier.cold.put_rows(plan.demote_keys,
                                   [host[str(i)].numpy()
                                    for i in range(len(leaves))])
                tier.note_demote(len(plan.demote_keys))
            if len(plan.promote_keys):
                cols, _hits = tier.cold.take_rows(
                    plan.promote_keys, [v.numpy() for v in self._init],
                    [numpy_dtype(lf.dtype) for lf in leaves])
                pslots = to_device(plan.promote_slots, dev)
                for lf, col in zip(leaves, cols):
                    lf[pslots] = to_device(col, dev)
                # promoted rows differ from any saved hot tier
                self.dirty[pslots] = True
                tier.note_promote(len(plan.promote_keys),
                                  (time.perf_counter() - t0) * 1e6)

        self.replica.dispatch.submit(tier_commit, 0.0)

    # -- saved state ---------------------------------------------------------
    # The scan's state is (key -> slot dict, capacity, one table pytree):
    # host numpy in a snapshot (the JAX package's layout, table rows
    # without the scratch row), device tensors again on restore.
    def _host_table(self):
        cap = self.table_capacity
        return (None if self.table is None else
                tree_map(lambda t: t[:cap].cpu().numpy().copy(), self.table))

    def snapshot_state(self) -> dict:
        """The engine's state: FULL, or, under a checkpoint's capture with
        deltas on (``checkpoint/delta.py``), a DELTA of the rows dirtied
        since the engine's last FULL snapshot when ``delta_eligible``
        allows one (the JAX package's rule). A base needs a table of the
        current capacity: growth and restores start a new lineage."""
        ctx = ckpt_delta.snapshot_ctx()
        has_base = (self.table is not None and self.dirty is not None
                    and self._delta_base is not None
                    and self._base_capacity == self.table_capacity)
        if has_base and ckpt_delta.delta_eligible(
                self._delta_base, self._snaps_since_full, ctx):
            return self._snapshot_delta()
        table = self._host_table()
        d = {"slot_of_key": dict(self.slot_of_key),
             "table_capacity": self.table_capacity,
             "table": table}
        if self.tier is not None:
            d["tier"] = self.tier.snapshot(hot_digest=hot_table_digest(table))
        if ckpt_delta.starts_lineage(ctx):
            # this capture is the new delta base: the bitmap and the cold
            # WAL restart here (the capture runs after the drain, so no
            # commit in flight can race the reset). A base without a table
            # cannot be patched: the next capture is FULL again
            self._delta_base = ctx.ckpt_id
            self._base_capacity = (None if self.table is None
                                   else self.table_capacity)
            self._base_nkeys = len(self.slot_of_key)
            self._snaps_since_full = 0
            if self.dirty is not None:
                self.dirty.zero_()
            if self.tier is not None:
                self.tier.wal_reset()
        return d

    def _snapshot_delta(self) -> dict:
        """The dirty rows since the base, as a delta node (the JAX
        package's DELTA branch): the key directory rides as a zero-byte
        carry when no key registered since the base (dense slots are
        append-only, so an unchanged count is an unchanged mapping; tier
        swaps remap at constant size, so a tiered engine never carries)."""
        self._snaps_since_full += 1
        repl, carry = {}, []
        if self.tier is None and len(self.slot_of_key) == self._base_nkeys:
            carry += ["slot_of_key", "table_capacity"]
        else:
            repl["slot_of_key"] = dict(self.slot_of_key)
            repl["table_capacity"] = self.table_capacity
        if self.tier is not None:
            repl["tier"] = self.tier.snapshot_delta(self._delta_base)
        return ckpt_delta.make_delta(
            self._delta_base, rows={"table": self._dirty_rows()},
            replace=repl or None, carry=carry or None)

    def _dirty_rows(self) -> dict:
        """Host copies of just the dirty slot rows, one gathered column per
        table leaf (tree order): what a delta snapshot ships."""
        cap = self.table_capacity
        slots = np.nonzero(self.dirty[:cap].cpu().numpy())[0].astype(
            np.int64)
        idx = torch.from_numpy(slots).to(self.device)
        return {"slots": slots,
                "leaves": [lf[idx].cpu().numpy()
                           for lf in tree_leaves(self.table)]}

    def _install(self, table, cap: int):
        """A saved table pytree (numpy or tensors, ``cap`` rows) as device
        leaves with the scratch row."""
        out = []
        for v, a in zip(self._init, tree_leaves(table)):
            a = canonical(torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a))
            if a.shape[0] != cap:
                raise WindFlowError(f"{self.op.name}: saved table has "
                                    f"{a.shape[0]} rows, capacity {cap}")
            t = torch.empty(cap + 1, dtype=a.dtype, device=self.device)
            t[:cap] = a
            t[cap] = v
            out.append(t)
        return tree_unflatten(self._spec, out)

    def restore_state(self, state: dict) -> None:
        # a restored table starts a fresh bitmap and a fresh delta lineage:
        # the next checkpoint's capture is FULL
        self.dirty = None
        self._delta_base = None
        self._snaps_since_full = 0
        self._base_capacity = None
        self._base_nkeys = None
        tier_blob = state.get("tier")
        if tier_blob is not None and self.tier is None:
            raise WindFlowError(
                f"{self.op.name}: checkpoint holds a TIERED key store "
                "(hot + cold) but this graph was built without "
                "with_tiering(); cold-tier keys cannot be restored into "
                "a dense table — rebuild the graph with tiering enabled")
        self.slot_of_key.clear()  # shared alias with the KeySlotMap
        self.slot_of_key.update(state.get("slot_of_key", {}))
        self._keymap._lut = None
        table = state.get("table")
        if self.tier is not None:
            if tier_blob is None:
                # a dense blob into a tiered engine: every saved key
                # becomes hot (dense slot ids are contiguous from 0)
                self._adopt_dense_blob(table)
                return
            self.tier.restore(tier_blob, hot_digest=hot_table_digest(table))
            self.table_capacity = self.tier.hot_capacity
        else:
            self.table_capacity = state.get("table_capacity",
                                            self.table_capacity)
        self.table = (None if table is None
                      else self._install(table, self.table_capacity))
        self._sync_dirty()

    def _adopt_dense_blob(self, table) -> None:
        self.tier.adopt_dense(self.slot_of_key)
        cap = self.table_capacity = self.tier.hot_capacity
        if table is None:
            self.table = None
            return
        # occupied rows carry over (every slot < key count <= cap), the
        # rest start from the initial state
        fresh = self._fresh(cap)
        for i, a in enumerate(tree_leaves(table)):
            a = torch.as_tensor(np.asarray(a)[:cap] if not isinstance(
                a, torch.Tensor) else a[:cap])
            fresh[i] = fresh[i].to(a.dtype)
            fresh[i][:a.shape[0]] = a
        self.table = tree_unflatten(self._spec, fresh)
        self._sync_dirty()


class _StatefulGPUReplica(GPUReplicaBase):
    """A replica whose device state is one ``_KeyedStateScan``."""

    def __init__(self, op, idx: int, func: Callable,
                 filter_mode: bool) -> None:
        super().__init__(op, idx)
        self.engine = _KeyedStateScan(self, func, op.state_init, filter_mode)

    def prewarm(self, caps) -> Optional[int]:
        """``PipeGraph.with_prewarm`` on a card: trace the step and build
        or load its K8 library before batch 0 (1, one library). The grid
        follows the stream's keys, so no bucket runs; on the CPU, or
        without a declared schema (the step's dtypes), None."""
        if self.device.type != "cuda":
            return None
        sch = self._prewarm_schema()
        if sch is None:
            self.prewarm_skip = ("K8's step is traced over the batch's "
                                 "dtypes: declare the schema (with_schema) "
                                 "to build it before batch 0")
            return None
        self.engine.load_step(zero_fields(sch, 1, self.device))
        return 1

    def snapshot_state(self) -> dict:
        st = super().snapshot_state()
        st["scan"] = self.engine.snapshot_state()
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        if "scan" in state:
            self.engine.restore_state(state["scan"])


class StatefulMapGPUReplica(_StatefulGPUReplica):
    """Per-key device state via the grid scan (see ``_KeyedStateScan``)."""

    def __init__(self, op, idx: int) -> None:
        super().__init__(op, idx, op.func, False)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        # host prep: slot mapping and grid assembly (grid_meta drains the
        # pipeline itself iff the table must grow); the commit reads the
        # table AT COMMIT TIME: earlier queued commits update it
        rows = self.engine.prep(batch, batch.fields)

        def commit() -> None:
            valid = row_mask(batch.capacity, batch.size, self.device)
            out = self.engine.run(batch.fields, valid, rows)
            self.stats.device_programs_run += 1
            self._emit_batch(batch.with_fields(out))

        return commit


class StatefulFilterGPUReplica(_StatefulGPUReplica):
    """Keyed-state predicate and compaction in one commit (the reference's
    stateful Filter_GPU, ``filter_gpu.hpp:331-335``)."""

    def __init__(self, op, idx: int) -> None:
        super().__init__(op, idx, op.pred, True)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        rows = self.engine.prep(batch, batch.fields)

        def commit() -> None:
            valid = row_mask(batch.capacity, batch.size, self.device)
            keep = self.engine.run(batch.fields, valid, rows)
            order, count = compact_order(keep)
            out = {k: v[order] for k, v in batch.fields.items()}
            self.stats.device_programs_run += 1
            # the state must be read in commit order, so the program runs
            # here and its (order, count) readback waits right after it,
            # as in the JAX package's commit
            host, event = host_copies({"order": order, "count": count})
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
    """Whole-batch fold to one tuple via ``tree_reduce`` (K6); its ts is
    the batch's largest."""

    def _warm_program(self, fields, cap: int) -> None:
        reduce_fold.prepare(self.op.combine, fields, cap)
        reduce_fold.tree_reduce(self.op.combine, fields, size=cap)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        # on a card: the combine traced and its library loaded here, so a
        # combine the kernel cannot take raises at the first prep
        reduce_fold.prepare(self.op.combine, batch.fields)
        return super().prep_device_batch(batch)

    def process_device_batch(self, batch: BatchGPU) -> None:
        if batch.size == 0:
            return
        # the first size rows: no mask tensor, no launch to make one
        out, _ = reduce_fold.tree_reduce(self.op.combine, batch.fields,
                                         size=batch.size)
        self.stats.device_programs_run += 1
        ts = np.array([int(batch.ts_host[:batch.size].max())],
                      dtype=np.int64)
        nb = BatchGPU(out, ts, 1, batch.schema, batch.wm)
        nb.stream_tag = batch.stream_tag
        nb.copy_trace_from(batch)
        self._emit_batch(nb)


class ReduceGPUReplica(GPUReplicaBase):
    def _warm_program(self, fields, cap: int) -> None:
        # the order and slot VALUES are stream data; their shapes are the
        # bucket's (every row on slot 0)
        reduce_fold.prepare(self.op.combine, fields, cap)
        idx = torch.arange(cap, dtype=torch.int32, device=self.device)
        reduce_fold.keyed_fold(self.op.combine, fields, idx,
                               torch.zeros_like(idx), 1)

    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        # host prep: ONE key sort, the sorted slots and their starts (on a
        # card the combine traced and loaded first), shipped in one copy;
        # the fold and the output batch are the deferred commit stage
        reduce_fold.prepare(self.op.combine, batch.fields)
        order_np, ssorted, slot_of_key = reduce_order_and_slots(self.op,
                                                                batch)
        n_out = len(slot_of_key)
        if n_out == 0:
            return None
        out_cap = bucket_capacity(n_out)
        starts_np, max_run = slot_starts(ssorted, n_out)
        order, slots, starts = fold_rows_to_device(order_np, ssorted,
                                                   starts_np, self.device)
        out_keys = list(slot_of_key)  # insertion order == slot order
        ts = np.full(out_cap, int(batch.ts_host[:batch.size].max()),
                     dtype=np.int64)

        def commit() -> None:
            out, _ = reduce_fold.keyed_fold(self.op.combine, batch.fields,
                                            order, slots, n_out, None,
                                            out_cap, starts, max_run)
            self.stats.device_programs_run += 1
            nb = BatchGPU(out, ts, n_out, batch.schema, batch.wm, out_keys)
            nb.stream_tag = batch.stream_tag
            nb.copy_trace_from(batch)
            self._emit_batch(nb)

        return commit
