"""Mesh-sharded keyed operators: Map_Mesh / Filter_Mesh / Reduce_Mesh.

The port of ``windflow_tpu/mesh/ops_mesh.py``: the keyed-state plane of
the single-card device operators, sharded over a ``core.KeyMesh``.

- **stateful Map/Filter** (``Map_GPU_Builder(...).with_state(...)
  .with_key_by(...).with_mesh(...)``): the per-key grid-scan state table,
  one row per dense key slot, block-sharded along the slot axis over
  every shard of the ``('key', 'data')`` mesh in flattened order (a
  grid-scan transition is sequential per key, so each key lives on
  exactly one shard). One step per ``GB``-row slice: bucket-by-owner +
  ``all_to_all`` (the KEYBY shuffle as a collective; the topology edge
  into the operator stays single-destination), the ``K_pad x M`` grid
  scan, and the inverse ``all_to_all`` back to arrival order;
- **keyed Reduce** (``Reduce_GPU_Builder(...).with_key_by(...)
  .with_mesh(...)``): per-batch ``reduce_by_key`` (one output per
  distinct key per batch), shuffle and segmented combine on the device.

Shared mechanics, as in ``Ffat_Windows_Mesh``: ONE host replica drives
the mesh; arbitrary int64 keys densify to slots through a host
``KeySlotMap`` (``key_capacity`` is the declared bound, exceeded = loud
error); slices pad to the mesh's global batch with slot = -1 lanes and
are cut into the mesh groups' lane blocks, each copied into its group's
card. Each group holds the table rows of its own shards. The Reduce reads
its per-slot results back once per card; the Map's output columns and the
Filter's keep mask are gathered onto the graph's card (the first
group's), where the next operator reads them.
``snapshot_state`` ships the state table as PER-SHARD row blocks under
one manifest entry (or, under ``with_checkpointing(delta=True)``, a delta
of per-shard row patches); ``restore_state`` relayouts them onto another
mesh shape by slot rows. ``with_tiering`` puts the host cold tier behind
the sharded table. ``rescale()`` refuses mesh operators
(``scaling.repartition.repartition_refusal``). ``with_prewarm`` is not
ported, so neither is the mesh replicas' ``prewarm``.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..basic import KeyCapacityError, RoutingMode, WindFlowError
from ..checkpoint import delta as ckpt_delta
from ..gpu.batch import BatchGPU, bucket_capacity, host_copies, to_device
from ..gpu.keymap import KeySlotMap
from ..gpu.ops_gpu import GPUOperatorBase, GPUReplicaBase, op_batch_keys_np
from ..gpu.schema import TupleSchema, canonical, numpy_dtype, torch_dtype
from ..pytree import tree_leaves, tree_map
from . import core


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
class _MeshKeyedOperator(GPUOperatorBase):
    """Shared metadata of the mesh-sharded keyed operators."""

    # mesh execution plane: parallelism is the mesh shape, not the
    # replica count; snapshots ship per-shard blocks and can relayout
    # onto another mesh shape
    is_mesh = True
    mesh_snapshot_capable = True

    def __init__(self, name: str, key_extractor, schema,
                 key_capacity: int, n_devices: Optional[int],
                 mesh_shape: Optional[tuple],
                 local_batch: Optional[int]) -> None:
        if key_extractor is None:
            raise WindFlowError(f"{name}: mesh operators require a key "
                                "extractor (with_key_by)")
        # ONE host replica drives the whole mesh
        super().__init__(name, 1, RoutingMode.KEYBY, key_extractor, 0,
                         schema)
        self.key_capacity = max(1, int(key_capacity))
        self.n_devices = n_devices
        self.mesh_shape = mesh_shape
        self.local_batch = local_batch


class Map_Mesh(_MeshKeyedOperator):
    """Stateful keyed map over the mesh: ``func(row, state) -> (row,
    state)`` over 0-d tensors under ``torch.func.vmap``, scanned in
    arrival order, the state block-sharded over the shards."""

    def __init__(self, func: Callable, state_init: Any, key_extractor,
                 name: str = "map_mesh", key_capacity: int = 1024,
                 n_devices: Optional[int] = None,
                 mesh_shape: Optional[tuple] = None,
                 local_batch: Optional[int] = None,
                 schema: Optional[TupleSchema] = None,
                 tiering=None) -> None:
        if state_init is None:
            raise WindFlowError(
                f"{name}: with_mesh applies to the KEYED-STATE plane; a "
                "stateless Map_GPU is data-parallel already — add "
                "with_state(...) or drop with_mesh")
        super().__init__(name, key_extractor, schema, key_capacity,
                         n_devices, mesh_shape, local_batch)
        self.func = func
        self.state_init = state_init
        self.tiering = tiering

    def build_replicas(self) -> None:
        self.replicas = [MapMeshReplica(self, 0)]


class Filter_Mesh(_MeshKeyedOperator):
    """Stateful keyed filter over the mesh: ``pred(row, state) -> (keep,
    state)``; the batch compacts after the step."""

    def __init__(self, pred: Callable, state_init: Any, key_extractor,
                 name: str = "filter_mesh", key_capacity: int = 1024,
                 n_devices: Optional[int] = None,
                 mesh_shape: Optional[tuple] = None,
                 local_batch: Optional[int] = None,
                 schema: Optional[TupleSchema] = None,
                 tiering=None) -> None:
        if state_init is None:
            raise WindFlowError(
                f"{name}: with_mesh applies to the KEYED-STATE plane; a "
                "stateless Filter_GPU is data-parallel already — add "
                "with_state(...) or drop with_mesh")
        super().__init__(name, key_extractor, schema, key_capacity,
                         n_devices, mesh_shape, local_batch)
        self.pred = pred
        self.state_init = state_init
        self.tiering = tiering

    def build_replicas(self) -> None:
        self.replicas = [FilterMeshReplica(self, 0)]


class Reduce_Mesh(_MeshKeyedOperator):
    """Keyed per-batch reduce over the mesh (``Reduce_GPU`` semantics: one
    output per distinct key per batch; the combine is associative and
    commutative)."""

    def __init__(self, combine: Callable, key_extractor,
                 name: str = "reduce_mesh", key_capacity: int = 1024,
                 n_devices: Optional[int] = None,
                 mesh_shape: Optional[tuple] = None,
                 local_batch: Optional[int] = None,
                 schema: Optional[TupleSchema] = None) -> None:
        if key_extractor is None:
            raise WindFlowError(
                f"{name}: the GLOBAL (unkeyed) reduce folds one "
                "stream-wide value — there is no keyed plane to shard; "
                "with_mesh requires with_key_by")
        super().__init__(name, key_extractor, schema, key_capacity,
                         n_devices, mesh_shape, local_batch)
        self.combine = combine

    def build_replicas(self) -> None:
        self.replicas = [ReduceMeshReplica(self, 0)]


# ---------------------------------------------------------------------------
# host replicas
# ---------------------------------------------------------------------------
class _MeshReplicaBase(GPUReplicaBase):
    """Shared host control loop: lazy mesh construction, key -> slot
    densification, GB-slice padding, mesh stats, and the snapshot /
    restore scaffolding (per-shard blocks, relayout on restore)."""

    _STATE_KEY = "mesh_state"

    def __init__(self, op: _MeshKeyedOperator, idx: int) -> None:
        super().__init__(op, idx)
        self._key_by_slot = np.zeros(op.key_capacity, np.int64)
        self._keymap = KeySlotMap(on_new=self._on_new_key)
        self._mesh: Optional[core.KeyMesh] = None  # built at run time
        self._ns = 0
        self._k_local = 0
        self._K_pad = 0
        self._GB = 0
        self._local_batch = 0
        self._val_fields: List[str] = []
        self._val_dtypes: Dict[str, np.dtype] = {}
        self._gpos_dev = None
        self._step_bytes = 0
        self._pending_restore: Optional[dict] = None
        self._tier = None  # _MeshScanReplicaBase builds it when declared

    def _on_new_key(self, key, slot: int) -> None:
        if slot >= self.op.key_capacity:
            raise KeyCapacityError(
                self.op.name, self._K_pad or self.op.key_capacity,
                slot - self.op.key_capacity + 1,
                hint="raise with_mesh(key_capacity=) or enable "
                     "with_tiering to spill the cold key tail")
        self._key_by_slot[slot] = key

    # -- lazy mesh / program construction ----------------------------------
    def _mesh_ensure(self, val_dtypes: Dict[str, Any], cap: int) -> None:
        if self._mesh is not None:
            return
        op = self.op
        n_dev = op.n_devices or len(core.visible_devices(self.device))
        self._mesh = core.make_key_mesh(n_dev, shape=op.mesh_shape,
                                        device=self.device)
        ns = core.mesh_shard_count(self._mesh)
        self._ns = ns
        self._note_degraded(n_dev, ns)
        self._local_batch = op.local_batch or max(1, math.ceil(cap / ns))
        self._GB = ns * self._local_batch
        self._K_pad = math.ceil(op.key_capacity / ns) * ns
        self._k_local = self._K_pad // ns
        self._val_dtypes = {f: np.dtype(dt) for f, dt in val_dtypes.items()}
        self._val_fields = list(self._val_dtypes)
        B = self._local_batch
        self._gpos_dev = core._gout(self._mesh, [
            torch.arange(g.lo * B, g.hi * B, dtype=torch.int32,
                         device=g.device) for g in self._mesh.groups])
        self._step_bytes = self._GB * (8 + sum(
            dt.itemsize for dt in self._val_dtypes.values()))
        self.stats.mesh_devices = ns
        self._after_mesh_ensure()

    def _note_degraded(self, requested: int, ns: int) -> None:
        """Degraded capacity: the mesh came up on fewer devices than the
        operator would otherwise use because the supervision plane
        excluded lost devices (``Mesh_degraded_devices``; the supervisor
        reports ``Recovery_degraded_devices``)."""
        if not core.excluded_device_ids():
            self.stats.mesh_degraded = 0
            return
        want = min(int(requested), len(core.visible_devices(self.device)))
        degraded = max(0, want - int(ns))
        self.stats.mesh_degraded = degraded
        if degraded:
            from ..monitoring.flightrec import thread_recorder
            rec = thread_recorder()
            if rec is not None:
                rec.event("mesh:degrade", 0.0, {
                    "op": self.op.name, "devices": ns,
                    "excluded": sorted(core.excluded_device_ids()),
                    "requested": want})

    def _after_mesh_ensure(self) -> None:
        raise NotImplementedError

    def _ensure(self, batch: BatchGPU) -> None:
        if self._mesh is None:
            self._mesh_ensure({f: batch.schema.fields[f]
                               for f in batch.fields}, batch.capacity)

    # -- per-batch key plane -------------------------------------------------
    def _batch_slots(self, batch: BatchGPU):
        n = batch.size
        _, keys = op_batch_keys_np(self.op, batch)
        keys = np.asarray(keys)[:n]
        if keys.dtype.kind not in "iu":
            raise WindFlowError(
                f"{self.op.name}: mesh operators require integer keys "
                f"(sparse/negative int64 ok); got dtype {keys.dtype}")
        if self._tier is not None and n:
            # tier pre-pass, inline before the slot resolution (the
            # commit runs in order on the replica's thread)
            plan = self._tier.plan_batch(
                self._keymap, [int(k) for k in np.unique(keys)])
            if plan is not None:
                self._apply_tier_plan(plan)
            self._tier.publish_gauges(len(self._keymap))
        slots = np.asarray(self._keymap.slots_of(keys, keys, n),
                           dtype=np.int64)
        occ, skew = core.mesh_occupancy(len(self._keymap), self._k_local,
                                        self._ns)
        self.stats.mesh_shard_occupancy = occ
        self.stats.mesh_shard_skew = skew
        return slots, keys

    def _pad_slice(self, slots, cols, lo: int, hi: int):
        """One GB-row padded slice as the groups' lane blocks: slot = -1
        lanes mark padding (the routing drops them), value columns
        zero-fill."""
        mesh = self._mesh
        m = hi - lo
        s_sl = np.full(self._GB, -1, np.int32)
        s_sl[:m] = slots[lo:hi]
        v_sl = core.stage_lanes(mesh, self._local_batch,
                                {f: cols[f] for f in self._val_fields}, lo,
                                m)
        return mesh.split(s_sl, mesh.lane_sizes(self._local_batch)), v_sl

    # -- snapshot / restore scaffolding ---------------------------------------
    def _snapshot_extra(self) -> dict:
        return {}

    def _device_state_shards(self) -> Optional[list]:
        return None

    def snapshot_state(self) -> dict:
        st = super().snapshot_state()  # drains the dispatch queue
        if self._mesh is None:
            if self._pending_restore is not None:
                # restored but never touched since: pass the blob through
                st[self._STATE_KEY] = self._pending_restore
            return st
        d = {
            "slot_of_key": dict(self._keymap.slot_of_key),
            "key_by_slot": self._key_by_slot.copy(),
            "key_capacity": self.op.key_capacity,
            "K_pad": self._K_pad, "n_shards": self._ns,
            "local_batch": self._local_batch,
            "val_dtypes": {f: dt.str for f, dt in self._val_dtypes.items()},
            # per-shard blocks gathered under this one manifest entry
            "table_shards": self._device_state_shards(),
        }
        d.update(self._snapshot_extra())
        st[self._STATE_KEY] = d
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        d = state.get(self._STATE_KEY)
        if d is not None:
            # applied once the mesh exists: the target mesh shape may
            # differ from the checkpointed one
            self._pending_restore = d

    def _restore_keymap(self, d: dict) -> None:
        op = self.op
        if len(d["slot_of_key"]) > op.key_capacity:
            raise KeyCapacityError(
                op.name, self._K_pad or op.key_capacity,
                len(d["slot_of_key"]) - op.key_capacity,
                hint="restore holds more distinct keys than this graph's "
                     "key_capacity; raise with_mesh(key_capacity=) to at "
                     "least the checkpointed count")
        self._keymap.slot_of_key.clear()
        self._keymap.slot_of_key.update(d["slot_of_key"])
        self._keymap._lut = None
        kbs = np.asarray(d["key_by_slot"])
        self._key_by_slot[:] = 0
        n_copy = min(len(kbs), op.key_capacity)
        self._key_by_slot[:n_copy] = kbs[:n_copy]


class _MeshScanReplicaBase(_MeshReplicaBase):
    """Stateful Map/Filter over the mesh: the grid-scan table
    block-sharded along the slot axis (``core.make_mesh_table``: the
    shards' row blocks stacked, one scratch row); one sharded step per
    GB slice."""

    filter_mode = False
    _STATE_KEY = "mesh_scan"

    def __init__(self, op, idx) -> None:
        super().__init__(op, idx)
        self._table = None
        self._out_schema: Optional[TupleSchema] = None
        self._prog: Optional[Callable] = None
        # incremental checkpoints: the slot rows each batch and each tier
        # promotion rewrites since the delta base (a FULL snapshot taken
        # with deltas on), so a delta ships per-shard row patches
        self._ckpt_dirty: set = set()
        self._delta_base: Optional[int] = None
        self._snaps_since_full = 0
        self._base_nkeys: Optional[int] = None
        self._base_geom = None  # (K_pad, n_shards) at the base
        cfg = getattr(op, "tiering", None)
        if cfg is not None:
            if cfg.hot_capacity > op.key_capacity:
                raise WindFlowError(
                    f"{op.name}: with_tiering(hot_capacity="
                    f"{cfg.hot_capacity}) exceeds with_mesh(key_capacity="
                    f"{op.key_capacity}) — the mesh table IS the hot "
                    "tier; raise key_capacity or lower hot_capacity")
            from ..state.tiered import TieredKeyStore
            self._tier = TieredKeyStore(f"{op.name}_mesh_tier", cfg,
                                        stats=self.stats)

    @property
    def functor(self) -> Callable:
        raise NotImplementedError

    def _apply_tier_plan(self, plan) -> None:
        """Batched tier movement against the sharded table: one slot-row
        gather per leaf feeds the cold writes, one scatter per leaf lands
        the promotions."""
        tier = self._tier
        t0 = time.perf_counter()
        mesh = self._mesh
        leaves = tree_leaves(core._glist(mesh, self._table)[0])
        if len(plan.demote_keys):
            tier.cold.put_rows(plan.demote_keys, core.gather_rows(
                mesh, self._table, self._k_local,
                np.asarray(plan.demote_slots, np.int64)))
            tier.note_demote(len(plan.demote_keys))
        if len(plan.promote_keys):
            init = [np.asarray(v) for v in tree_leaves(self.op.state_init)]
            cols, _hits = tier.cold.take_rows(
                plan.promote_keys, init,
                [numpy_dtype(lf.dtype) for lf in leaves])
            core.scatter_rows(mesh, self._table, self._k_local,
                              np.asarray(plan.promote_slots, np.int64),
                              cols)
            for k, s in zip(plan.promote_keys, plan.promote_slots):
                self._key_by_slot[int(s)] = k
            if self._delta_base is not None:
                self._ckpt_dirty.update(int(s) for s in plan.promote_slots)
            tier.note_promote(len(plan.promote_keys),
                              (time.perf_counter() - t0) * 1e6)

    def _after_mesh_ensure(self) -> None:
        op = self.op
        self._table = core.make_mesh_table(self._mesh, op.state_init,
                                           self._K_pad)
        if not self.filter_mode:
            # the output schema: the functor on one row of zeros
            table0 = core._glist(self._mesh, self._table)[0]
            dev = self._mesh.device
            row = {f: torch.zeros((), dtype=torch_dtype(dt), device=dev)
                   for f, dt in self._val_dtypes.items()}
            state = tree_map(lambda t: t[0], table0)
            out, _ = self.functor(row, state)
            if not isinstance(out, dict):
                raise WindFlowError(f"{op.name}: stateful map function "
                                    "must return (dict of columns, state)")
            self._out_schema = TupleSchema(
                {f: numpy_dtype(canonical(torch.as_tensor(v)).dtype)
                 for f, v in out.items()})
        if self._pending_restore is not None:
            self._apply_pending_restore()

    def _program(self) -> Callable:
        """The operator's one sharded step (its traced K8 step with it):
        the plain version on a CPU group takes its grid depth from each
        slice's rows."""
        if self._prog is None:
            self._prog = core.sharded_grid_scan(
                self._mesh, self.functor, self.filter_mode,
                self.op.key_capacity, None, self._local_batch)[0]
        return self._prog

    # -- streaming ---------------------------------------------------------
    def process_device_batch(self, batch: BatchGPU) -> None:
        self._ensure(batch)
        n = batch.size
        if n == 0:
            return
        slots, keys_raw = self._batch_slots(batch)
        if self._delta_base is not None:
            # every slot row this batch scans through is dirty vs the base
            self._ckpt_dirty.update(np.unique(slots).tolist())
        cols = {f: batch.fields[f][:n] for f in self._val_fields}
        ts = np.asarray(batch.ts_host[:n])
        GB = self._GB
        prog = self._program()
        for lo in range(0, n, GB):
            hi = min(lo + GB, n)
            s_dev, v_sl = self._pad_slice(slots, cols, lo, hi)
            t0 = time.perf_counter()
            self._table, out, _n_ok = prog(self._table, s_dev,
                                           self._gpos_dev, v_sl)
            self.stats.device_programs_run += 1
            self.stats.note_mesh_step((time.perf_counter() - t0) * 1e6,
                                      self._step_bytes)
            self._emit_slice(batch, out, ts, keys_raw, lo, hi)

    def _emit_slice(self, batch, out, ts, keys_raw, lo, hi) -> None:
        raise NotImplementedError

    # -- sharded fault tolerance -------------------------------------------
    def snapshot_state(self) -> dict:
        ctx = ckpt_delta.snapshot_ctx()
        if (self._mesh is not None and self._table is not None
                and self._base_geom == (self._K_pad, self._ns)
                and ckpt_delta.delta_eligible(
                    self._delta_base, self._snaps_since_full, ctx)):
            # DELTA: the replica base part captures fully; only the
            # mesh_scan entry shrinks to per-shard patches of dirty rows
            st = GPUReplicaBase.snapshot_state(self)
            self._snaps_since_full += 1
            st[self._STATE_KEY] = self._snapshot_mesh_delta()
            return st
        st = super().snapshot_state()
        if (ckpt_delta.starts_lineage(ctx) and self._mesh is not None
                and self._table is not None):
            # this FULL capture is the new delta base
            self._delta_base = ctx.ckpt_id
            self._base_geom = (self._K_pad, self._ns)
            self._base_nkeys = len(self._keymap.slot_of_key)
            self._snaps_since_full = 0
            self._ckpt_dirty = set()
            if self._tier is not None:
                self._tier.wal_reset()
        return st

    def _snapshot_mesh_delta(self) -> dict:
        """Delta against the last FULL snapshot: ONE gather of the dirty
        slot rows, split into per-shard local-row patches (shard s owns
        rows [s*k_local, (s+1)*k_local))."""
        sl = np.asarray(sorted(self._ckpt_dirty), dtype=np.int64)
        kl = self._k_local
        rows = core.gather_rows(self._mesh, self._table, kl, sl) \
            if len(sl) else [np.zeros(0, numpy_dtype(lf.dtype))
                             for lf in tree_leaves(
                                 core._glist(self._mesh, self._table)[0])]
        shard_of = sl // kl if len(sl) else sl
        patches: List[Optional[dict]] = []
        for s in range(self._ns):
            m = shard_of == s
            if not len(sl) or not m.any():
                patches.append(None)
                continue
            patches.append({"slots": sl[m] - s * kl,
                            "leaves": [r[m] for r in rows]})
        repl = {"key_capacity": self.op.key_capacity,
                "K_pad": self._K_pad, "n_shards": self._ns,
                "local_batch": self._local_batch,
                "val_dtypes": {f: dt.str
                               for f, dt in self._val_dtypes.items()}}
        row_patches = {}
        carry = []
        if (self._tier is None
                and len(self._keymap.slot_of_key) == self._base_nkeys):
            # no key registered since the base: slots are append-only
            # without tiering, so the directory is a zero-byte carry
            carry += ["slot_of_key", "key_by_slot"]
        else:
            repl["slot_of_key"] = dict(self._keymap.slot_of_key)
            row_patches["key_by_slot"] = {
                "slots": sl, "leaves": [self._key_by_slot[sl].copy()]}
        node = ckpt_delta.make_delta(
            self._delta_base, rows=row_patches or None,
            shards={"table_shards": patches},
            replace=repl, carry=carry or None)
        if self._tier is not None:
            node["replace"]["tier"] = self._tier.snapshot_delta(
                self._delta_base)
        return node

    def restore_state(self, state: dict) -> None:
        # restored state starts a fresh delta lineage
        self._ckpt_dirty = set()
        self._delta_base = None
        self._snaps_since_full = 0
        self._base_geom = None
        self._base_nkeys = None
        super().restore_state(state)

    def _snapshot_extra(self) -> dict:
        if self._tier is None:
            return {}
        from ..state.tiered import hot_table_digest
        host = (None if self._table is None
                else core.host_tree(self._mesh, self._table))
        return {"tier": self._tier.snapshot(
            hot_digest=hot_table_digest(host))}

    def _device_state_shards(self) -> Optional[list]:
        if self._table is None:
            return None
        host = core.host_tree(self._mesh, self._table)
        kl = self._k_local
        return [tree_map(lambda a, _s=s: a[_s * kl:(_s + 1) * kl].copy(),
                         host) for s in range(self._ns)]

    def _apply_pending_restore(self) -> None:
        d, self._pending_restore = self._pending_restore, None
        tier_blob = d.get("tier")
        if tier_blob is not None and self._tier is None:
            raise WindFlowError(
                f"{self.op.name}: checkpoint holds a TIERED key store "
                "but this graph was built without with_tiering(); "
                "cold-tier keys cannot restore into a dense mesh table")
        self._restore_keymap(d)
        shards = d.get("table_shards")
        full = None
        if shards is not None:
            full = tree_map(lambda *parts: np.concatenate(
                [np.asarray(p) for p in parts], axis=0), *shards)
        if self._tier is not None:
            if tier_blob is not None:
                from ..state.tiered import hot_table_digest
                self._tier.restore(tier_blob,
                                   hot_digest=hot_table_digest(full))
            else:
                # a dense mesh checkpoint into a tiered graph: every
                # checkpointed key becomes hot (refused when they don't fit)
                self._tier.adopt_dense(self._keymap.slot_of_key)
        if full is None:
            return
        # rows past the checkpointed ones keep the initial state
        core.write_rows(self._mesh, self._table, self._k_local,
                        tree_leaves(full))


class MapMeshReplica(_MeshScanReplicaBase):
    filter_mode = False

    @property
    def functor(self) -> Callable:
        return self.op.func

    def _emit_slice(self, batch, out, ts, keys_raw, lo, hi) -> None:
        m = hi - lo
        ts2 = np.zeros(self._GB, np.int64)
        ts2[:m] = ts[lo:hi]
        out = self._mesh.join(out, self.device)
        nb = BatchGPU(dict(out), ts2, m, self._out_schema, batch.wm,
                      keys_raw[lo:hi].copy())
        nb.stream_tag = batch.stream_tag
        nb.copy_trace_from(batch)
        self._emit_batch(nb)


class FilterMeshReplica(_MeshScanReplicaBase):
    filter_mode = True

    @property
    def functor(self) -> Callable:
        return self.op.pred

    def _emit_slice(self, batch, out, ts, keys_raw, lo, hi) -> None:
        m = hi - lo
        out = self._mesh.join(out, self.device)
        host, event = host_copies({"keep": out[:m]})
        if event is not None:
            event.synchronize()
        kept = np.nonzero(host["keep"].numpy())[0]
        self.stats.inputs_ignored += m - len(kept)
        if not len(kept):
            return
        cap = bucket_capacity(len(kept))
        sel = np.zeros(cap, np.int64)
        sel[:len(kept)] = lo + kept  # rows of the ORIGINAL device batch
        sel_dev = to_device(sel, self.device)
        out_fields = {f: batch.fields[f][sel_dev] for f in batch.fields}
        ts2 = np.zeros(cap, np.int64)
        ts2[:len(kept)] = ts[lo:hi][kept]
        nb = BatchGPU(out_fields, ts2, len(kept), batch.schema, batch.wm,
                      keys_raw[lo:hi][kept].copy())
        nb.stream_tag = batch.stream_tag
        nb.copy_trace_from(batch)
        self._emit_batch(nb)


class ReduceMeshReplica(_MeshReplicaBase):
    """Keyed per-batch reduce: shuffle + segmented combine on the device,
    per-slot results harvested to one output row per distinct key."""

    _STATE_KEY = "mesh_reduce"

    def __init__(self, op, idx) -> None:
        super().__init__(op, idx)
        self._step = None

    def _after_mesh_ensure(self) -> None:
        self._step = core.sharded_keyed_reduce(
            self._mesh, self.op.combine, self.op.key_capacity,
            self._local_batch)[0]
        if self._pending_restore is not None:
            self._restore_keymap(self._pending_restore)
            self._pending_restore = None

    def _host_combine(self, a: dict, b: dict) -> dict:
        """Cross-slice merge (only when one batch spans several GB
        slices): the user combine over one-element tensors; fields it
        does not return pass through unchanged."""
        ta = {f: torch.as_tensor(np.asarray([v])) for f, v in a.items()}
        tb = {f: torch.as_tensor(np.asarray([v])) for f, v in b.items()}
        merged = self.op.combine(ta, tb)
        return {f: np.asarray(merged[f])[0].astype(self._val_dtypes[f])
                if f in merged else b[f] for f in b}

    def process_device_batch(self, batch: BatchGPU) -> None:
        self._ensure(batch)
        n = batch.size
        if n == 0:
            return
        slots, _keys_raw = self._batch_slots(batch)
        cols = {f: batch.fields[f][:n] for f in self._val_fields}
        acc: Dict[int, dict] = {}
        GB = self._GB
        for lo in range(0, n, GB):
            hi = min(lo + GB, n)
            s_dev, v_sl = self._pad_slice(slots, cols, lo, hi)
            t0 = time.perf_counter()
            res, touched, _n_ok = self._step(s_dev, v_sl)
            res_fields = list(core._glist(self._mesh, res)[0])
            host = core.read_host(self._mesh, {
                "touched": touched, **{f"r:{f}": core.pick(self._mesh, res, f)
                                       for f in res_fields}})
            self.stats.device_programs_run += 1
            self.stats.note_mesh_step((time.perf_counter() - t0) * 1e6,
                                      self._step_bytes)
            res_np = {f: host[f"r:{f}"] for f in res_fields}
            for s in np.nonzero(host["touched"])[0]:
                row = {f: res_np[f][s] for f in res_np}
                s = int(s)
                acc[s] = row if s not in acc \
                    else self._host_combine(acc[s], row)
        if not acc:
            return
        self._emit_rows(batch, acc,
                        ts_max=int(np.asarray(batch.ts_host[:n]).max()))

    def _emit_rows(self, batch, acc: Dict[int, dict], ts_max: int) -> None:
        out_slots = sorted(acc)
        n_out = len(out_slots)
        cap = bucket_capacity(n_out)
        dev = self.device
        out_fields = {}
        for f in self._val_fields:
            buf = np.zeros(cap, self._val_dtypes[f])
            buf[:n_out] = [acc[s][f] for s in out_slots]
            out_fields[f] = to_device(buf, dev)
        ts2 = np.full(cap, ts_max, np.int64)
        keys2 = self._key_by_slot[np.asarray(out_slots, np.int64)].copy()
        nb = BatchGPU(out_fields, ts2, n_out, batch.schema, batch.wm, keys2)
        nb.stream_tag = batch.stream_tag
        nb.copy_trace_from(batch)
        self._emit_batch(nb)


__all__ = ["Filter_Mesh", "FilterMeshReplica", "Map_Mesh", "MapMeshReplica",
           "Reduce_Mesh", "ReduceMeshReplica"]
