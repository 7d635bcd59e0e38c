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
  tuple (``masked_tree_reduce``); a KEYED terminator gathers the rows by
  the host's key order and scans each key's VALID rows with validity as
  an Option (``gpu/scan.py`` ``masked_segmented_scan``), then compacts the
  surviving segment tails on the device. Its KEYBY shuffle is the
  identity where fusion is legal (``topology/stage.py``);
- the whole chain submits ONE host-prep/device-commit pair to the
  replica's ``DeviceDispatchQueue``: three chained operators cost one
  replica, one commit and one readback per batch instead of three of each
  plus two channel hops.

Readbacks (kept counts, compaction orders, surviving key slots) go through
fresh pinned buffers and one CUDA event (``batch.host_copies``); the
commit waits on that event only.

Stateful sub-ops (kinds ``smap`` / ``sfilter``) each own one
``_KeyedStateScan`` (``gpu/ops_gpu.py``): host prep runs each engine's
``grid_meta`` in chain order, and the chain body runs its grid-scan step
where the sub-op sits, on the table as it is at launch time (an
``sfilter`` narrows ``valid``; rows an earlier filter dropped skip the
grid). A key-compatible keyed entry makes their KEYBY shuffle the
identity (``topology/stage.py``).

MEGABATCH: with ``PipeGraph(megabatch=K)``, the dispatch queue hands up
to K queued same-signature commits to ``_run_megabatch``, the counterpart
of the JAX package's ``lax.scan``: a Python loop of ``_chain_body`` over
the K batches in submission order, their readbacks all started before the
first wait, then the K emits. Each body reads and updates the state
tables in place, so the tables thread from batch to batch as the scan's
carry does, and the batches are those of K single commits.

``snapshot_state`` records the chain's signature and one entry per
sub-op (the engine's state, or None), and ``restore_state`` refuses a
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
from .batch import BatchGPU, host_copies, to_device
from .ffat_gpu import Ffat_Windows_GPU, FfatGPUReplica
from .ops_gpu import (Filter_GPU, GPUReplicaBase, Map_GPU, Reduce_GPU,
                      _KeyedStateScan, compact_order, masked_tree_reduce,
                      reduce_order_and_slots, row_mask)
from .scan import masked_segmented_scan


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

    @property
    def fused_signature(self) -> List[str]:
        return [op.name for op in self.ops]

    # -- the chain body ------------------------------------------------------
    def _chain_body(self, fields: Dict[str, torch.Tensor], size: int,
                    hargs) -> tuple:
        """One batch through the chain: ``(out, readback)``, the device
        columns to emit and the device tensors the host reads back (none
        for a map-only chain). ``hargs[i]`` is sub-op i's prep output: a
        stateful one's ``(program, grid arrays)``, the keyed terminator's
        ``(order, sorted slots)``. Shared by the single and the megabatch
        commit, so both launch the same kernels. Where the JAX package
        reads back a reduce exit's ``compact_order(valid)`` and count only
        to take the kept rows' largest ts, the port reads back the mask
        itself: one byte a row and no compaction launches."""
        first = next(iter(fields.values()))
        valid = row_mask(first.shape[0], size, first.device)
        for spec, h in zip(self.specs, hargs):
            if spec.kernel is not None:
                fields, valid, _ = spec.kernel(fields, valid, None)
            elif spec.engine is not None:
                # the grid scan on the sub-op's table as it is now (commit
                # order); rows ``valid`` excludes skip the grid
                out = spec.engine.run(h[0], fields, valid, h[1])
                if spec.kind == "sfilter":
                    valid = out
                else:
                    fields = out
        if self._exit == "reduce":
            return (masked_tree_reduce(self._combine, fields, valid),
                    {"keep": valid})
        if self._exit == "kreduce":
            # the host sorted ALL rows by key (the sort does not depend on
            # the mask); the scan folds each key's VALID rows, and a key
            # whose tail stays invalid had no surviving row: it is dropped,
            # as the unfused filter stage would have dropped its rows
            order, ssorted = hargs[-1]
            new_seg = ssorted[1:] != ssorted[:-1]
            one = torch.ones(1, dtype=torch.bool, device=ssorted.device)
            scanned, vscan = masked_segmented_scan(
                self._combine, {c: v[order] for c, v in fields.items()},
                torch.cat([~one, ~new_seg]), valid[order])
            torder, tcount = compact_order(torch.cat([new_seg, one])
                                           & vscan)
            return ({c: a[torder] for c, a in scanned.items()},
                    {"slots": ssorted[torder], "tcount": tcount,
                     "keep": valid})
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
            # key order over ALL rows, independent of the mask; order and
            # slots ship from fresh pinned buffers
            order_np, ssorted_np, slot_of_key = reduce_order_and_slots(
                self.ops[-1], batch)
            if not slot_of_key:
                return None
            kred = (to_device(order_np, self.device),
                    to_device(ssorted_np, self.device))
            kextra = list(slot_of_key)  # slot order == insertion order
        # per stateful sub-op, in chain order: slot mapping and grid
        # assembly (grid_meta drains the pipeline itself iff a table must
        # grow, and queues the tier moves ahead of this batch)
        statics: List[Any] = []
        hargs: List[Any] = []
        for spec in self.specs:
            if spec.engine is not None:
                prog, grid, gargs = spec.engine.prep(batch)
                statics.append(grid)
                hargs.append((prog, gargs))
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
