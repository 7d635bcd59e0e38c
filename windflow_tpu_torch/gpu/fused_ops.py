"""FusedGPUReplica: one replica, one commit and one exit readback per batch
across a chained device stage.

The port of ``windflow_tpu/tpu/fused_ops.py`` (reference: operator
chaining into one thread, ``wf/multipipe.hpp:537-590``). A ``Map_GPU ->
Filter_GPU -> Reduce_GPU`` chain built with ``MultiPipe.chain`` runs as ONE
replica whose per-batch work is one pass of ``_chain_body`` over the
sub-operators' composable kernels (``gpu/ops_gpu.py``), eagerly on the
operator's device:

- a filter's keep mask flows to the next sub-op as a device-side
  ``valid`` mask: no mid-chain compaction and no mid-chain readback; the
  one compaction and readback happen at the chain exit (never, for
  map-only chains);
- a global ``Reduce_GPU`` terminator folds the masked survivors to one
  tuple (K6, ``kernels/reduce_fold.py`` ``tree_reduce``); a KEYED
  terminator folds each key's VALID rows, in the host's key order, into
  the key's slot with validity as an Option (K7, ``keyed_fold``: one
  launch on a card), then compacts the surviving slots on the device. Its
  KEYBY shuffle is the identity where fusion is legal
  (``topology/stage.py``);
- the whole chain submits ONE host-prep/device-commit pair to the
  replica's ``DeviceDispatchQueue``: three chained operators cost one
  replica, one commit and one readback per batch instead of three of each
  plus two channel hops.

Readbacks (kept counts, compaction orders, surviving key slots) go through
fresh pinned buffers and one CUDA event (``batch.host_copies``); the
commit waits on that event only.

Stateful sub-ops (kinds ``smap`` / ``sfilter``) each own one
``_KeyedStateScan`` (``gpu/ops_gpu.py``): host prep runs each engine's
``grid_meta`` in chain order, and the chain body runs its keyed scan (K8:
the hand kernel on a card) where the sub-op sits, on the table as it is at
launch time (an ``sfilter`` narrows ``valid``; rows an earlier filter
dropped leave their key's state as it is). A key-compatible keyed entry
makes their KEYBY shuffle the identity (``topology/stage.py``).

MEGABATCH: with ``PipeGraph(megabatch=K)``, the dispatch queue hands up
to K queued same-signature commits to ``_run_megabatch``, the counterpart
of the JAX package's ``lax.scan``: a Python loop of ``_chain_body`` over
the K batches in submission order, their readbacks all started before the
first wait, then the K emits. Each body reads and updates the state
tables and their dirty bitmaps in place, so both thread from batch to
batch as the scan's carry does (a delta snapshot after the group ships
the rows of all K batches), and the batches are those of K single
commits.

``snapshot_state`` records the chain's signature and one entry per
sub-op (the engine's state, FULL or under a delta capture a delta node,
or None), and ``restore_state`` refuses a
blob from a differently fused topology. ``FusedFfatReplica`` (bottom of
this module) is the window-terminated variant: the STATELESS map/filter
prefix composes INTO the ``Ffat_Windows_GPU`` step through the
``_lift_fn`` / ``_prefix_mask`` seams of ``FfatGPUReplica``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..basic import WindFlowError
from ..kernels import reduce_fold
from ..kernels.grid_scan import output_like
from .batch import BatchGPU, bucket_capacity, host_copies, zero_fields
from .ffat_gpu import Ffat_Windows_GPU, FfatGPUReplica
from .ops_gpu import (Filter_GPU, GPUReplicaBase, Map_GPU, Reduce_GPU,
                      _KeyedStateScan, compact_order, fold_rows_to_device,
                      reduce_order_and_slots, row_mask, slot_starts)


def _adopt_chain(replica, ops) -> None:
    """The fused stage is ONE observable operator named m∘f∘r: its stats
    report under that name, with the number of fused sub-ops."""
    replica.ops = ops
    replica.fused_name = "∘".join(o.name for o in ops)
    replica.stats.op_name = replica.fused_name
    replica.stats.fused_ops = len(ops)


def _check_fused_blob(replica, state: dict) -> None:
    """Refuse a blob taken from a differently fused topology: standalone
    state, or another chain's signature."""
    sig = state.get("__fused__")
    if sig is None:
        raise WindFlowError(
            f"restore: this graph fuses {replica.fused_name!r} into one "
            f"device chain, but the checkpoint blob for "
            f"{replica.op.name!r} holds standalone state — the "
            "checkpointed topology was fused differently (match "
            "PipeGraph(fusion=...) / the chain() calls of the original "
            "graph)")
    if list(sig) != replica.fused_signature:
        raise WindFlowError(
            "restore: fused-chain mismatch — the checkpoint holds "
            f"{'∘'.join(sig)!r}, this graph builds "
            f"{replica.fused_name!r}")


class _SubSpec:
    """One sub-operator's contribution to the fused chain: a stateless
    kernel, a stateful grid-scan engine, or a terminal reduce."""

    __slots__ = ("kind", "kernel", "engine")

    def __init__(self, kind: str, kernel: Optional[Callable] = None,
                 engine: Optional[_KeyedStateScan] = None) -> None:
        self.kind = kind  # map | filter | smap | sfilter | reduce | kreduce
        self.kernel = kernel  # stateless composable kernel
        self.engine = engine  # the stateful sub-op's own engine


def _build_specs(replica, ops) -> List[_SubSpec]:
    specs: List[_SubSpec] = []
    for op in ops:
        if isinstance(op, Reduce_GPU):
            specs.append(_SubSpec(
                "reduce" if op.key_extractor is None else "kreduce"))
        elif isinstance(op, (Map_GPU, Filter_GPU)):
            is_map = isinstance(op, Map_GPU)
            if op.state_init is not None:
                specs.append(_SubSpec(
                    "smap" if is_map else "sfilter",
                    engine=_KeyedStateScan(
                        replica, op.func if is_map else op.pred,
                        op.state_init, not is_map, op=op)))
            else:
                specs.append(_SubSpec("map" if is_map else "filter",
                                      op.device_kernel()))
        else:
            raise WindFlowError(
                f"{op.name}: operator kind {type(op).__name__} has no "
                "composable device kernel (fusion legality should have "
                "refused this chain)")
    return specs


class FusedGPUReplica(GPUReplicaBase):
    """One replica running a whole chained device stage: the same
    dispatch-queue ordering contract and punctuation/EOS handling as any
    ``GPUReplicaBase``, with a bigger per-batch commit."""

    def __init__(self, ops, idx: int) -> None:
        ops = list(ops)
        super().__init__(ops[0], idx)
        _adopt_chain(self, ops)
        self.specs = _build_specs(self, ops)
        if any(s.kind in ("reduce", "kreduce") for s in self.specs[:-1]):
            raise WindFlowError(
                f"{self.fused_name}: Reduce_GPU must terminate the fused "
                "chain")
        last = self.specs[-1]
        # the chain exit: a reduce terminator, else one compaction when a
        # filter narrowed the mask, else the columns as they are
        self._exit = (last.kind if last.kind in ("reduce", "kreduce")
                      else "filter" if any(s.kind in ("filter", "sfilter")
                                           for s in self.specs)
                      else "map")
        self._combine = getattr(ops[-1], "combine", None)
        self._stateful = any(s.engine is not None for s in self.specs)
        self._steps_loaded: set = set()  # batch dtypes _load_steps took

    @property
    def fused_signature(self) -> List[str]:
        return [op.name for op in self.ops]

    # -- prewarm (PipeGraph.with_prewarm) -------------------------------------
    def _prewarm_schema(self):
        # batches arrive with the CHAIN ENTRY's schema
        return self.ops[0].schema

    def prewarm(self, caps) -> Optional[int]:
        """The whole chain body once per bucket. A chain with a stateful
        sub-op runs no bucket (its rows follow the stream's keys): on a
        card its steps are traced and their K8 libraries built or loaded
        before batch 0 instead (the number of steps), with its reduce
        exit's library and scratch; on the CPU, or without a declared
        schema, None."""
        if not self._stateful:
            return super().prewarm(caps)
        if self.device.type != "cuda":
            return None
        sch = self._prewarm_schema()
        if sch is None:
            self.prewarm_skip = ("K8's steps are traced over the batch's "
                                 "dtypes: declare the schema (with_schema) "
                                 "to build them before batch 0")
            return None
        return self._load_steps(zero_fields(sch, 1, self.device),
                                max(caps, default=0))

    def _load_steps(self, fields: Dict[str, torch.Tensor],
                    rows: int = 0) -> int:
        """For a card: trace every stateful sub-op's step, and a reduce
        exit's combine, over the columns it will see and build or load
        its library (raising ``WindFlowError`` for a step or combine the
        kernels cannot take); with ``rows``, also reserve the exit's
        scratch for batches of that many rows. Those columns come from
        one row of zeros like ``fields`` through the sub-ops before it: a
        stateless kernel's output, a stateful map's output columns
        (``output_like``). Once per batch dtypes (and ``rows``); returns
        the steps it loaded."""
        sig = tuple((f, t.dtype, tuple(t.shape[1:]))
                    for f, t in fields.items())
        if rows <= 0 and sig in self._steps_loaded:
            return 0
        cols = {f: torch.zeros((1,) + t.shape[1:], dtype=t.dtype,
                               device=t.device) for f, t in fields.items()}
        valid = torch.ones(1, dtype=torch.bool, device=self.device)
        n = 0
        for spec in self.specs:
            if spec.kernel is not None:
                cols, valid, _ = spec.kernel(cols, valid, None)
            elif spec.engine is not None:
                cols = output_like(spec.engine.load_step(cols), cols)
                n += 1
        if self._exit in ("reduce", "kreduce"):
            reduce_fold.prepare(self._combine, cols, rows)
        self._steps_loaded.add(sig)
        return n

    def _warm_program(self, fields, cap: int) -> None:
        hargs: List[Any] = [None] * len(self.specs)
        if self._exit == "kreduce":
            hargs[-1] = (torch.arange(cap, dtype=torch.int32,
                                      device=self.device),
                         torch.zeros(cap, dtype=torch.int32,
                                     device=self.device), 1, None, None)
        if self.device.type == "cuda":
            self._load_steps(fields, cap)
        self._chain_body(fields, cap, hargs)

    # -- the chain body ------------------------------------------------------
    def _chain_body(self, fields: Dict[str, torch.Tensor], size: int,
                    hargs) -> tuple:
        """One batch through the chain: ``(out, readback)``, the device
        columns to emit and the device tensors the host reads back (none
        for a map-only chain). ``hargs[i]`` is sub-op i's prep output: a
        stateful one's ``KeyRows``, the keyed terminator's ``(order,
        sorted slots, slot count, starts, longest run)``. Shared by the
        single and the megabatch commit, so both launch the same kernels.
        Where the JAX package reads back a reduce exit's
        ``compact_order(valid)`` and count only to take the kept rows'
        largest ts, the port reads back the mask itself: one byte a row
        and no compaction launches."""
        first = next(iter(fields.values()))
        valid = row_mask(first.shape[0], size, first.device)
        for spec, h in zip(self.specs, hargs):
            if spec.kernel is not None:
                fields, valid, _ = spec.kernel(fields, valid, None)
            elif spec.engine is not None:
                # the keyed scan on the sub-op's table as it is now (commit
                # order); rows ``valid`` excludes leave the state as it is
                out = spec.engine.run(fields, valid, h)
                if spec.kind == "sfilter":
                    valid = out
                else:
                    fields = out
        if self._exit == "reduce":
            return (reduce_fold.tree_reduce(self._combine, fields, valid)[0],
                    {"keep": valid})
        if self._exit == "kreduce":
            # the host sorted ALL rows by key (the sort does not depend on
            # the mask); the fold takes each key's VALID rows into its
            # slot, and a slot left invalid had no surviving row: it is
            # dropped, as the unfused filter stage would have dropped its
            # rows. The surviving slots compact in slot order, in a buffer
            # of the slots' capacity bucket (the unfused replica's)
            order, ssorted, n_slots, starts, max_run = hargs[-1]
            folded, fvalid = reduce_fold.keyed_fold(
                self._combine, fields, order, ssorted, n_slots, valid,
                bucket_capacity(n_slots), starts, max_run)
            torder, tcount = compact_order(fvalid)
            return ({c: a[torder] for c, a in folded.items()},
                    {"slots": torder, "tcount": tcount, "keep": valid})
        if self._exit == "filter":
            order, count = compact_order(valid)
            return ({k: v[order] for k, v in fields.items()},
                    {"order": order, "count": count})
        return fields, {}

    def _launch(self, batch: BatchGPU, hargs) -> tuple:
        """Run the chain body on ``batch`` and start its readback: ``(out,
        host tensors, event)``."""
        out, readback = self._chain_body(batch.fields, batch.size, hargs)
        return (out,) + host_copies(readback)

    # -- batch path ----------------------------------------------------------
    def prep_device_batch(self, batch: BatchGPU) -> Optional[Callable]:
        kextra = None
        kred = None
        if self._exit == "kreduce":
            # key order over ALL rows, independent of the mask; order,
            # slots and their starts ship in one copy
            order_np, ssorted_np, slot_of_key = reduce_order_and_slots(
                self.ops[-1], batch)
            if not slot_of_key:
                return None
            starts_np, max_run = slot_starts(ssorted_np, len(slot_of_key))
            order, ssorted, starts = fold_rows_to_device(
                order_np, ssorted_np, starts_np, self.device)
            kred = (order, ssorted, len(slot_of_key), starts, max_run)
            kextra = list(slot_of_key)  # slot order == insertion order
        if self.device.type == "cuda" and (
                self._stateful or self._exit in ("reduce", "kreduce")):
            # every stateful sub-op's step and a reduce exit's combine
            # traced and loaded before the first commit
            self._load_steps(batch.fields)
        # per stateful sub-op, in chain order: slot mapping and the rows
        # grouped by key (grid_meta drains the pipeline itself iff a
        # table must grow, and queues the tier moves ahead of this batch)
        statics: List[Any] = []
        hargs: List[Any] = []
        for spec in self.specs:
            if spec.engine is not None:
                rows = spec.engine.prep(batch)
                statics.append((rows.M, rows.touched.shape[0]))
                hargs.append(rows)
            else:
                statics.append(None)
                hargs.append(kred if spec.kind == "kreduce" else None)

        def commit() -> None:
            launched = self._launch(batch, hargs)
            self.stats.device_programs_run += 1  # ONE program per batch
            self._commit_emit(batch, *launched, kextra)

        # megabatch: the queue groups consecutive commits with equal
        # scan_sig (same chain, same stateful grid shapes (M, KB), same
        # capacity bucket, as the JAX package keys its compiled scans) and
        # hands the group to scan_runner. Unfused replicas' commits carry
        # no scan_sig
        commit.scan_sig = (id(self), tuple(statics), batch.capacity)
        commit.scan_payload = (batch, hargs, kextra)
        commit.scan_runner = self._run_megabatch
        return commit

    def _run_megabatch(self, commits: List[Callable]) -> None:
        """Commit K queued same-signature batches as ONE device program:
        the chain body over each in submission order, every readback
        started before the first wait, then the K emits (ordering points
        never get here: ``drain`` runs singles)."""
        payloads = [c.scan_payload for c in commits]
        launched = [self._launch(batch, hargs)
                    for batch, hargs, _ in payloads]
        self.stats.device_programs_run += 1  # ONE program for K batches
        for (batch, _, kextra), parts in zip(payloads, launched):
            self._commit_emit(batch, *parts, kextra)
        self.stats.note_megabatch(len(commits))

    def _commit_emit(self, batch: BatchGPU, out, host: Dict[str, Any],
                     event, kextra=None) -> None:
        """Readback wait and emit of one batch's chain outputs: the ONE
        definition shared by the single and the megabatch commit. A batch
        the chain killed whole emits nothing."""
        if event is not None:
            event.synchronize()
        if self._exit == "map":
            self._emit_batch(batch.with_fields(out))
            return
        if self._exit == "filter":
            self.emit_compacted(batch, out, host["order"].numpy(),
                                int(host["count"]))
            return
        keep = host["keep"].numpy()[:batch.size]
        n_kept = int(keep.sum())
        self.stats.inputs_ignored += batch.size - n_kept
        out_keys = None
        if self._exit == "kreduce":
            n_out = int(host["tcount"])  # surviving keys
            out_keys = [kextra[s] for s in host["slots"].numpy()[:n_out]]
        else:
            n_out = min(1, n_kept)
        if n_out == 0:
            return
        ts = np.full(next(iter(out.values())).shape[0],
                     int(batch.ts_host[:batch.size][keep].max()),
                     dtype=np.int64)
        nb = BatchGPU(out, ts, n_out, batch.schema, batch.wm, out_keys)
        nb.stream_tag = batch.stream_tag
        nb.copy_trace_from(batch)
        self._emit_batch(nb)

    # -- checkpointing -------------------------------------------------------
    def snapshot_state(self) -> dict:
        """The chain's identity and one entry per sub-op (its engine's
        state, None when stateless), the JAX package's layout."""
        st = super().snapshot_state()  # drains the dispatch queue
        st["__fused__"] = self.fused_signature
        st["fused_sub_states"] = [
            (s.engine.snapshot_state() if s.engine is not None else None)
            for s in self.specs]
        return st

    def restore_state(self, state: dict) -> None:
        _check_fused_blob(self, state)
        super().restore_state(state)
        subs = state.get("fused_sub_states")
        if subs is None or len(subs) != len(self.specs):
            raise WindFlowError(
                f"restore: fused chain {self.fused_name!r} expects "
                f"{len(self.specs)} per-sub-op states, checkpoint holds "
                f"{0 if subs is None else len(subs)}")
        # positional restore: entry i belongs to sub-op i
        for spec, sub in zip(self.specs, subs):
            if spec.engine is not None:
                spec.engine.restore_state(sub or {})


class FusedFfatReplica(FfatGPUReplica):
    """A fused device chain TERMINATED by ``Ffat_Windows_GPU``: the chain's
    stateless map/filter prefix composes INTO the window replica's own
    per-batch step, so ``source -> map -> filter -> Ffat_Windows`` runs as
    one replica and one commit per batch, and the forest rebuild (K1)
    still runs once per firing batch.

    Two seams of ``FfatGPUReplica``:

    - ``_lift_fn``: the prefix maps run in front of the user lift inside
      every ingest (a filter leaves the columns as they are, so only the
      maps are composed there);
    - ``_prefix_mask``: with prefix filters, the keep mask is computed and
      read back at PREP time (one bool readback per batch). It must be:
      the host control plane's liveness quantities (max_leaf, next_fire,
      CB count) are exact, so a row the filter drops may never register a
      key, advance a leaf or count toward a CB window. Map-only prefixes
      never pay it.

    Legality (enforced again here after ``topology/stage.py``): the prefix
    is stateless map/filter only, and it must not rewrite the key field
    (``_keys_compatible`` checks names only). There is no megabatch for
    this replica: its commits carry no ``scan_sig``."""

    def __init__(self, ops, idx: int) -> None:
        ops = list(ops)
        super().__init__(ops[-1], idx)
        _adopt_chain(self, ops)
        prefix = ops[:-1]
        for o in prefix:
            # the prefix runs twice per batch (prep-time mask and in-step
            # compose): a stateful one would advance its state twice
            if not isinstance(o, (Map_GPU, Filter_GPU)) \
                    or o.state_init is not None:
                raise WindFlowError(
                    f"{self.fused_name}: only stateless map/filter sub-ops "
                    f"may precede a window terminator ({o.name} — fusion "
                    "legality should have refused this chain)")
        self._prefix_kernels = [o.device_kernel() for o in prefix]
        self._map_kernels = [o.device_kernel() for o in prefix
                             if isinstance(o, Map_GPU)]
        self._prefix_filters = any(isinstance(o, Filter_GPU)
                                   for o in prefix)
        self._tag = tuple(o.name for o in prefix)

    @property
    def fused_signature(self) -> List[str]:
        return [op.name for op in self.ops]

    def _prewarm_schema(self):
        # batches arrive with the CHAIN ENTRY's schema
        return self.ops[0].schema

    # -- composition seams ---------------------------------------------------
    def _chain_tag(self):
        return ("chain",) + self._tag

    def _lift_fn(self) -> Callable:
        kernels = self._map_kernels
        lift = self.op.lift
        if not kernels:
            return lift

        def lifted(fields):
            # rows the prefix filtered go through the lift too; their
            # segment lanes carry the sentinel (prep packed the surviving
            # rows only), so the scan drops them before any leaf
            for kern in kernels:
                fields, _, _ = kern(fields, None, None)
            return lift(fields)

        return lifted

    def _prefix_mask(self, batch: BatchGPU) -> Optional[np.ndarray]:
        if not self._prefix_filters:
            return None
        fields = batch.fields
        valid = row_mask(batch.capacity, batch.size, self.device)
        for kern in self._prefix_kernels:
            fields, valid, _ = kern(fields, valid, None)
        self.stats.device_programs_run += 1
        # prep-time readback: the price of exact host liveness under a
        # fused filter
        host, event = host_copies({"keep": valid})
        if event is not None:
            event.synchronize()
        return host["keep"].numpy()[:batch.size]

    # -- checkpointing -------------------------------------------------------
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()  # drains the dispatch queue
        st["__fused__"] = self.fused_signature
        return st

    def restore_state(self, state: dict) -> None:
        _check_fused_blob(self, state)
        st = dict(state)
        st.pop("__fused__", None)
        super().restore_state(st)


def make_fused_replica(ops, idx: int):
    """Replica factory for a chained device stage: a window-terminated
    chain composes into the window replica's own step
    (``FusedFfatReplica``); every other chain, reduce terminators
    included, runs ``FusedGPUReplica``."""
    if isinstance(ops[-1], Ffat_Windows_GPU):
        return FusedFfatReplica(ops, idx)
    return FusedGPUReplica(ops, idx)
