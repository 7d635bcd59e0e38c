"""Ffat_Windows_Mesh: the key-sharded FlatFAT forest as a framework
operator.

The port of ``windflow_tpu/mesh/ffat_mesh.py``: a topology-level operator
whose single host replica drives ``core.sharded_ffat_forest`` over a
``core.KeyMesh`` (CPU source -> keyed staging -> the sharded forest ->
sink). Build it with ``Ffat_Windows_GPU_Builder(...).with_mesh(...)``.

Semantics follow the JAX package's MESH operator, not the port's
single-card ``gpu/ffat_gpu.py``:

- windows are ORIGIN-ANCHORED: window ``w`` of a key covers panes
  ``[w*slide, w*slide + win)`` from the epoch (the first batch's
  slide-aligned pane rebase keeps epoch-us timestamps inside int32), and
  empty eligible windows fire with ``valid=False`` (PARITY.md §2.3);
- keys are ARBITRARY integers (sparse, negative): a host ``KeySlotMap``
  gives each a dense slot in ``[0, key_capacity)`` in first-seen order,
  fired windows carry the original key, and more distinct keys than
  ``key_capacity`` raise ``KeyCapacityError`` (the refused key is not
  registered);
- per-key control state (next_fire / max_leaf / fired) lives on the
  device, in the shard that owns the key; the lateness rule
  (``late_policy`` "keep_open", or the reference's "ref_fired") is a mask
  on it inside the step;
- idle keys fast-forward inside the step, tuples far ahead of the
  frontier trigger data-less catch-up steps and then host-driven ring
  GROWTH with leaf migration, refused past ``RING_CAP_PANES``;
- ``snapshot_state`` ships the forest as per-key-shard row blocks, and a
  restore relayouts them onto another mesh shape (rows to the new
  ``K_pad``, live leaves re-mapped ``pane % F_old -> pane % F_new``).

One step per ``GB``-row slice of a staged batch (padded with key = -1
lanes), cut into the mesh groups' lane blocks and copied into each
group's card; each step's fired windows come back in ONE read-back per
card (results, validity, window ids and the late count, which the host
sums over the groups) and leave as one columnar batch on the graph's
device. On a card the level rebuild is the hand-written kernel K1
(``kernels/forest_rebuild.cuh``), one launch per step on each group's
key rows: the fieldwise library, or the user's combine traced and
compiled into a variant of its own when the forest is first allocated (a
combine the tracer refuses fails the run there).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..basic import KeyCapacityError, OpType, RoutingMode, WinType, \
    WindFlowError
from ..gpu.batch import BatchGPU, to_device
from ..gpu.keymap import KeySlotMap
from ..gpu.ops_gpu import GPUOperatorBase, GPUReplicaBase, op_batch_keys_np
from ..gpu.schema import TupleSchema, torch_dtype
from ..kernels.forest_rebuild import variant as forest_variant
from . import core


class Ffat_Windows_Mesh(GPUOperatorBase):
    """Keyed sliding-window aggregation sharded over a mesh."""

    op_type = OpType.WIN_GPU
    # mesh execution plane: parallelism is the mesh shape, not the
    # replica count (rescale refuses via repartition_refusal); snapshots
    # ship per-shard blocks and restore onto another mesh shape
    is_mesh = True
    mesh_snapshot_capable = True

    def __init__(self, lift: Callable, combine: Callable, key_extractor,
                 win_len: int, slide_len: int,
                 win_type: WinType = WinType.TB, lateness: int = 0,
                 name: str = "ffat_windows_mesh",
                 key_capacity: int = 16,
                 n_devices: Optional[int] = None,
                 mesh_shape: Optional[tuple] = None,
                 local_batch: Optional[int] = None,
                 fire_rounds: int = 4,
                 ring_panes: int = 0,
                 late_policy: str = "keep_open",
                 schema: Optional[TupleSchema] = None) -> None:
        if key_extractor is None:
            raise WindFlowError(f"{name}: requires a key extractor")
        if win_type is not WinType.TB:
            raise WindFlowError(
                f"{name}: the mesh plane supports TB windows (CB arrival "
                "indexing needs per-key host counters; use the single-card "
                "Ffat_Windows_GPU)")
        if win_len <= 0 or slide_len <= 0:
            raise WindFlowError(f"{name}: win/slide must be > 0")
        # ONE host replica drives the whole mesh; parallelism is the mesh
        super().__init__(name, 1, RoutingMode.KEYBY, key_extractor, 0,
                         schema)
        self.lift = lift
        self.combine = combine
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.lateness = lateness
        self.key_capacity = max(1, key_capacity)
        self.n_devices = n_devices
        self.mesh_shape = mesh_shape
        self.local_batch = local_batch
        if late_policy not in ("keep_open", "ref_fired"):
            raise WindFlowError(
                f"{name}: late_policy must be 'keep_open' or 'ref_fired' "
                f"(got {late_policy!r})")
        self.fire_rounds = max(1, fire_rounds)
        self.ring_panes = ring_panes
        self.late_policy = late_policy
        self.pane_len = math.gcd(win_len, slide_len)

    def build_replicas(self) -> None:
        self.replicas = [FfatMeshReplica(self, 0)]


class FfatMeshReplica(GPUReplicaBase):
    """Host control loop: staged batch -> sharded step -> fired windows."""

    RING_CAP_PANES = 1 << 20  # growth refusal threshold (per-key panes)

    def __init__(self, op: Ffat_Windows_Mesh, idx: int) -> None:
        super().__init__(op, idx)
        self.win_units = op.win_len // op.pane_len
        self.slide_units = op.slide_len // op.pane_len
        self._mesh: Optional[core.KeyMesh] = None  # built at run time
        self._step = None
        self._state = None
        self._GB = 0
        self._K_pad = 0
        self._F = 0
        self._local_batch = 0
        self._val_fields: List[str] = []
        self._val_dtypes: Dict[str, Any] = {}
        self._out_fields: List[str] = []
        self._frontier = 0        # REBASED panes (see _pane_base)
        self._max_pane_seen = -1  # rebased
        # pane REBASE: the first batch anchors a base (rounded DOWN to a
        # slide multiple so window numbering stays origin-anchored);
        # device panes are pane - base, emitted wids add base // slide
        self._pane_base: Optional[int] = None
        # host upper bound on the per-key fired-window backlog (eviction
        # lags firing; see _check_ring_headroom)
        self._backlog_bound = 0
        # a restored snapshot awaiting relayout (applied in _ensure once
        # the mesh exists; snapshot_state passes it through untouched)
        self._pending_restore: Optional[dict] = None
        self._key_by_slot = np.zeros(op.key_capacity, np.int64)
        self._keymap = KeySlotMap(on_new=self._on_new_key)

    def _on_new_key(self, key, slot: int) -> None:
        if slot >= self.op.key_capacity:
            raise KeyCapacityError(
                self.op.name, self._K_pad or self.op.key_capacity,
                slot - self.op.key_capacity + 1,
                hint="raise with_key_capacity")
        self._key_by_slot[slot] = key

    # -- lazy mesh / step construction ------------------------------------
    def _ensure(self, batch: Optional[BatchGPU]) -> None:
        """Build the mesh and the sharded step. ``batch=None`` builds from
        a pending restored snapshot's metadata (a watermark-only advance
        or the EOS flush can need the restored forest before any batch);
        a restored snapshot is relayouted in either case."""
        if self._step is not None:
            return
        pend = self._pending_restore
        if batch is None and pend is None:
            return
        op = self.op
        n_dev = op.n_devices or len(core.visible_devices(self.device))
        self._mesh = core.make_key_mesh(n_dev, shape=op.mesh_shape,
                                        device=self.device)
        ka, da = self._mesh.shape["key"], self._mesh.shape["data"]
        if batch is not None:
            local_batch = op.local_batch or max(
                1, math.ceil(batch.capacity / (ka * da)))
            self._val_fields = list(batch.fields.keys())
            self._val_dtypes = {f: np.dtype(batch.schema.fields[f])
                                for f in self._val_fields}
        else:
            local_batch = op.local_batch or pend["local_batch"]
            self._val_dtypes = {f: np.dtype(dt)
                                for f, dt in pend["val_dtypes"].items()}
            self._val_fields = list(self._val_dtypes)
        self._F = op.ring_panes or core.default_ring_panes(
            self.win_units, self.slide_units, op.fire_rounds)
        if pend is not None:
            # ring geometry is state: a larger configured ring migrates
            # like growth (the relayout re-maps leaves pane-wise)
            self._F = max(self._F, int(pend["F"]))
        self._local_batch = local_batch
        init_fn, step, (K_pad, _k_local, GB) = self._build_forest(self._F)
        self._step = step
        self._GB, self._K_pad = GB, K_pad
        sample = {f: np.zeros(1, dt) for f, dt in self._val_dtypes.items()}
        self._state = init_fn(sample)
        self._out_fields = list(self._trees0())
        if self.device.type == "cuda":
            forest_variant(op.combine, self._k1_dtypes())
        self.stats.mesh_devices = ka * da
        if core.excluded_device_ids():
            want = min(n_dev, len(core.visible_devices(self.device)))
            self.stats.mesh_degraded = max(0, want - ka * da)
        else:
            self.stats.mesh_degraded = 0
        if pend is not None:
            self._apply_pending_restore()

    def _trees0(self) -> Dict[str, torch.Tensor]:
        """The first group's forest planes (every group's share dtypes)."""
        trees = self._state[0]
        return trees if self._mesh.n_groups == 1 else trees[0]

    def _k1_dtypes(self) -> Dict[str, torch.dtype]:
        return {f: t.dtype for f, t in self._trees0().items()}

    def _count_rebuild(self) -> None:
        if self.device.type == "cuda":
            from ..gpu.ffat_gpu import note_k1_use
            note_k1_use(self, self._k1_dtypes())
            self.stats.rebuild_kernel_launches += 1

    def _build_forest(self, ring_panes: int):
        """ONE construction path for the sharded step (initial build and
        ring growth must never drift apart in config or error handling)."""
        op = self.op
        try:
            return core.sharded_ffat_forest(
                self._mesh, op.lift, op.combine, n_keys=op.key_capacity,
                win_panes=self.win_units, slide_panes=self.slide_units,
                local_batch=self._local_batch,
                fire_rounds=op.fire_rounds, ring_panes=ring_panes,
                late_policy=op.late_policy, on_rebuild=self._count_rebuild)
        except ValueError as e:  # config validation -> framework error
            raise WindFlowError(f"{op.name}: {e}") from None

    def _install(self, trees, tvalid, nf, ml, fired) -> None:
        """Host numpy state (all ``K_pad`` rows) -> the device state tuple,
        each group's home key rows on its card."""
        mesh = self._mesh
        sizes = mesh.key_row_sizes(self._K_pad // mesh.shape["key"])
        t = lambda a: mesh.split(a, sizes)
        self._state = (t(trees), t(tvalid), t(nf.astype(np.int32)),
                       t(ml.astype(np.int32)), t(fired.astype(np.int32)))

    # -- sharded fault tolerance -------------------------------------------
    def snapshot_state(self) -> dict:
        """Aligned snapshot: host control state + the forest as PER-SHARD
        row blocks (one per key shard) under one manifest entry, so a
        restore can relayout onto another mesh shape by slot rows."""
        st = super().snapshot_state()  # drains the dispatch queue
        if self._step is None:
            if self._pending_restore is not None:
                # restored but never touched since: pass the blob through
                st["mesh_ffat"] = self._pending_restore
            return st
        ns = self._mesh.shape["key"]
        trees, tvalid, nf, ml, fired = self._host_state()
        blocks = lambda a: [b.copy() for b in np.split(a, ns, axis=0)]
        st["mesh_ffat"] = {
            "slot_of_key": dict(self._keymap.slot_of_key),
            "key_by_slot": self._key_by_slot.copy(),
            "key_capacity": self.op.key_capacity,
            "val_dtypes": {f: np.dtype(dt).str
                           for f, dt in self._val_dtypes.items()},
            "local_batch": self._local_batch,
            "F": self._F, "K_pad": self._K_pad, "key_shards": ns,
            "pane_base": self._pane_base,
            "frontier": self._frontier,
            "max_pane_seen": self._max_pane_seen,
            "backlog_bound": self._backlog_bound,
            "trees": {f: blocks(a) for f, a in trees.items()},
            "tvalid": blocks(tvalid),
            "next_fire": blocks(nf),
            "max_leaf": blocks(ml),
            "fired": blocks(fired),
        }
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        d = state.get("mesh_ffat")
        if d is not None:
            # applied lazily once the mesh exists (_ensure): the target
            # mesh shape may differ from the checkpointed one
            self._pending_restore = d

    @staticmethod
    def _migrate(trees_old, tvalid_old, nf, ml, F_old: int, F_new: int,
                 K_new: int, rows_k: int):
        """Live leaves ``pane % F_old -> pane % F_new`` per key row (the
        first ``rows_k`` rows), into fresh ``(K_new, 2 F_new)`` planes;
        internal levels stay invalid (the next step rebuilds them)."""
        spans = np.maximum(0, ml - nf + 1)
        spans[rows_k:] = 0
        rows = np.repeat(np.arange(K_new), spans)
        before = np.cumsum(spans) - spans
        seg = np.arange(int(spans.sum()), dtype=np.int64) \
            - np.repeat(before, spans)
        panes = np.repeat(nf, spans) + seg
        src = F_old + (panes % F_old)
        dst = F_new + (panes % F_new)
        new_trees = {f: np.zeros((K_new, 2 * F_new), t.dtype)
                     for f, t in trees_old.items()}
        new_tvalid = np.zeros((K_new, 2 * F_new), bool)
        for f, t in trees_old.items():
            new_trees[f][rows, dst] = t[rows, src]
        new_tvalid[rows, dst] = tvalid_old[rows, src]
        return new_trees, new_tvalid

    def _apply_pending_restore(self) -> None:
        """Relayout the restored forest onto THIS mesh: per-shard blocks
        concatenate to the slot axis, rows re-pad to the new K_pad, live
        leaves re-map ``pane % F_old -> pane % F_new``."""
        d, self._pending_restore = self._pending_restore, None
        op = self.op
        if len(d["slot_of_key"]) > op.key_capacity:
            raise WindFlowError(
                f"{op.name}: restore holds {len(d['slot_of_key'])} "
                f"distinct keys but this graph declares key_capacity="
                f"{op.key_capacity}; raise with_key_capacity to at least "
                "the checkpointed count")
        if set(d["trees"]) != set(self._out_fields):
            raise WindFlowError(
                f"{op.name}: restored forest fields "
                f"{sorted(d['trees'])} do not match this graph's lift "
                f"output {sorted(self._out_fields)}: the checkpointed "
                "operator ran a different aggregation")
        self._keymap.slot_of_key.clear()
        self._keymap.slot_of_key.update(d["slot_of_key"])
        self._keymap._lut = None
        kbs = np.asarray(d["key_by_slot"])
        self._key_by_slot[:] = 0
        n_copy = min(len(kbs), op.key_capacity)
        self._key_by_slot[:n_copy] = kbs[:n_copy]
        self._pane_base = d["pane_base"]
        self._frontier = int(d["frontier"])
        self._max_pane_seen = int(d["max_pane_seen"])
        self._backlog_bound = int(d["backlog_bound"])

        full = lambda bl: np.concatenate([np.asarray(b) for b in bl], axis=0)
        K_new = self._K_pad
        nf_old = full(d["next_fire"]).astype(np.int64)
        ml_old = full(d["max_leaf"]).astype(np.int64)
        tvalid_old = full(d["tvalid"])
        trees_old = {f: full(bl) for f, bl in d["trees"].items()}
        K_old = tvalid_old.shape[0]
        # live slots sit below key_capacity <= min(K_old, K_new): rows
        # beyond are untouched padding on either side
        rows_k = min(K_old, K_new)

        def fit_rows(a, fill):
            out = np.full((K_new,) + a.shape[1:], fill, dtype=a.dtype)
            out[:rows_k] = a[:rows_k]
            return out

        nf = fit_rows(nf_old, 0)
        ml = fit_rows(ml_old, -1)
        fired = fit_rows(full(d["fired"]), 0)
        new_trees, new_tvalid = self._migrate(
            trees_old, tvalid_old, nf, ml, int(d["F"]), self._F, K_new,
            rows_k)
        self._install(new_trees, new_tvalid, nf, ml, fired)

    # -- streaming ------------------------------------------------------------
    def _rebased_frontier(self, wm: Optional[int] = None) -> int:
        """Frontier from ``wm`` (default: the replica watermark). A batch
        commit passes its batch's own arrival watermark: commits are
        deferred, so ``cur_wm`` may already reflect LATER batches."""
        if wm is None:
            wm = self.cur_wm
        f_abs = max(0, wm - self.op.lateness) // self.op.pane_len
        return max(0, f_abs - (self._pane_base or 0))

    def _advance_frontier(self, new_frontier: int) -> bool:
        """Move the fire frontier and accrue the fired-window backlog it
        creates (up to ceil(delta / slide) new fireable windows per key),
        before any ring-headroom check reads the bound."""
        if new_frontier <= self._frontier:
            return False
        delta = new_frontier - self._frontier
        self._frontier = new_frontier
        self._backlog_bound += -(-delta // self.slide_units)
        return True

    def process_device_batch(self, batch: BatchGPU) -> None:
        self._ensure(batch)
        n = batch.size
        _, keys = op_batch_keys_np(self.op, batch)
        keys = np.asarray(keys)[:n]
        if keys.dtype.kind not in "iu":
            raise WindFlowError(
                f"{self.op.name}: mesh FFAT requires integer keys "
                f"(sparse/negative int64 ok); got dtype {keys.dtype}")
        # arbitrary int keys -> dense slots (the capacity guard fires
        # against the DECLARED capacity, whatever the mesh shape)
        keys = self._keymap.slots_of(keys, keys, n)
        occ, skew = core.mesh_occupancy(
            len(self._keymap), self._K_pad // self._mesh.shape["key"],
            self._mesh.shape["key"])
        self.stats.mesh_shard_occupancy = occ
        self.stats.mesh_shard_skew = skew
        ts_all = batch.ts_host[:n]
        panes = (ts_all // self.op.pane_len).astype(np.int64)
        if self._pane_base is None:
            base = int(panes.min()) if n else 0
            self._pane_base = (base // self.slide_units) * self.slide_units
        panes = panes - self._pane_base
        # the frontier from THIS batch's arrival watermark
        self._advance_frontier(self._rebased_frontier(batch.wm))
        # the per-key lateness rule lives on the device; the host only
        # drops panes below the rebase anchor (counted ignored)
        live = panes >= 0
        dropped = n - int(live.sum())
        st = self.stats
        ts_live = ts_all[live] if dropped else ts_all
        panes_live = panes[live] if dropped else panes
        # late accounting, arrival side: rows behind this batch's
        # watermark or the fire frontier count as late records here; the
        # device's drops ride the step's read-back (drop-only, no double
        # count)
        late_mask = (ts_live < batch.wm) | (panes_live < self._frontier)
        n_late_seen = int(late_mask.sum())
        if n_late_seen or dropped:
            st.note_late(n_late_seen + dropped, dropped,
                         batch.wm - ts_live[late_mask]
                         if st.hist_lateness is not None and n_late_seen
                         else None)
        if dropped:
            st.inputs_ignored += dropped
            keys, panes = keys[live], panes[live]
        if panes.size:
            self._check_ring_headroom(int(panes.max()))
            if int(panes.max()) >= np.iinfo(np.int32).max:
                raise WindFlowError(
                    f"{self.op.name}: rebased pane {int(panes.max())} "
                    "overflows the device's int32 pane domain; use a "
                    "larger pane (win/slide gcd)")
            self._max_pane_seen = max(self._max_pane_seen, int(panes.max()))
        if dropped:
            sel = to_device(np.nonzero(live)[0], batch.device)
            vals = {f: batch.fields[f][sel] for f in self._val_fields}
        else:
            vals = {f: batch.fields[f][:n] for f in self._val_fields}
        self._run_steps(keys.astype(np.int32), panes.astype(np.int32), vals)

    def on_punctuation(self, wm: int) -> None:
        # a watermark-only advance can make windows fireable with no new
        # data: a data-less step when the frontier moved (only once data
        # anchored the pane rebase)
        if self._step is None and self._pending_restore is not None:
            self._ensure(None)
        if self._step is not None and self._pane_base is not None:
            if self._advance_frontier(self._rebased_frontier()):
                self._run_steps(np.zeros(0, np.int32),
                                np.zeros(0, np.int32), self._empty_vals())
        super().on_punctuation(wm)

    # -- ring-aliasing safety ---------------------------------------------
    def _check_ring_headroom(self, max_pane: int) -> None:
        """A new pane ``p`` of key k aliases k's leaf ring iff ``p >=
        next_fire[k] + F``. next_fire trails the frontier by the per-key
        fired-window BACKLOG (tracked conservatively on the host); when
        the slack is gone, data-less catch-up steps fire and evict, then
        the ring grows."""
        while True:
            floor = (self._frontier - self.win_units + 1
                     - self._backlog_bound * self.slide_units)
            if max_pane < floor + self._F and max_pane < self._frontier \
                    + self._F - self.win_units:
                return
            if self._backlog_bound > 0:
                self._catch_up()
                continue
            if self._grow_ring_to(max_pane):
                continue  # re-check against the grown ring
            raise WindFlowError(
                f"{self.op.name}: pane {max_pane} is more than ring-win "
                f"({self._F}-{self.win_units}) panes ahead of the "
                f"watermark frontier {self._frontier}, and growing the "
                f"ring past {self.RING_CAP_PANES} panes is refused "
                "(a source outrunning its watermarks by that much is a "
                "watermark bug); advance watermarks faster or raise "
                "with_mesh(ring_panes=...)")

    def _host_state(self):
        """``(trees, tvalid, next_fire, max_leaf, fired)`` as host numpy
        (all ``K_pad`` rows), in one read-back per card."""
        mesh = self._mesh
        trees, tvalid, nf, ml, fired = self._state
        host = core.read_host(mesh, {
            **{f"t:{f}": core.pick(mesh, trees, f) for f in self._out_fields},
            "tvalid": tvalid, "nf": nf, "ml": ml, "fired": fired})
        return ({f: host[f"t:{f}"] for f in self._out_fields},
                host["tvalid"], host["nf"], host["ml"], host["fired"])

    def _host_control(self):
        """``(next_fire, max_leaf)`` as host int64 (all ``K_pad`` rows)."""
        host = core.read_host(self._mesh, {"nf": self._state[2],
                                           "ml": self._state[3]})
        return host["nf"].astype(np.int64), host["ml"].astype(np.int64)

    def _grow_ring_to(self, max_pane: int) -> bool:
        """Ring growth with state migration: fetch the forest, re-map
        LIVE LEAVES ``pane % F -> pane % F'`` per key, rebuild the step
        for the larger ring and install the migrated state. False when
        the needed ring exceeds RING_CAP_PANES (the caller raises)."""
        op = self.op
        new_F = self._F
        while (max_pane - self._frontier + self.win_units >= new_F
               or new_F < self.win_units
               + op.fire_rounds * self.slide_units):
            new_F *= 2
            if new_F > self.RING_CAP_PANES:
                return False
        trees, tvalid, nf, ml, fired = self._host_state()
        nf, ml = nf.astype(np.int64), ml.astype(np.int64)
        K_pad = tvalid.shape[0]
        new_trees, new_tvalid = self._migrate(trees, tvalid, nf, ml,
                                              self._F, new_F, K_pad, K_pad)
        _init, step, _meta = self._build_forest(new_F)
        self._step = step
        self._install(new_trees, new_tvalid, nf, ml, fired)
        self._F = new_F
        return True

    def _catch_up(self) -> None:
        """Fire the backlog with data-less steps. ONE control-state fetch
        sizes the whole drain: each key can fire ``min((frontier - win -
        nf) // slide, (ml - nf) // slide) + 1`` windows (the device's own
        eligibility rule), up to fire_rounds of them per step."""
        nf, ml = self._host_control()
        per_key = np.minimum(
            (self._frontier - self.win_units - nf) // self.slide_units,
            (ml - nf) // self.slide_units) + 1
        n_win = int(np.maximum(per_key, 0).max(initial=0))
        for _ in range(-(-n_win // self.op.fire_rounds)):
            self._run_steps(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            self._empty_vals())
        self._backlog_bound = 0

    def _empty_vals(self) -> Dict[str, torch.Tensor]:
        dev = self.device
        return {f: torch.zeros(0, dtype=torch_dtype(dt), device=dev)
                for f, dt in self._val_dtypes.items()}

    def _run_steps(self, keys: np.ndarray, panes: np.ndarray,
                   vals: Dict[str, torch.Tensor]) -> None:
        """Feed ``GB``-row slices (padded with key = -1 lanes, cut into the
        groups' lane blocks) through the sharded step; emit each step's
        fired windows."""
        GB = self._GB
        mesh = self._mesh
        sizes = mesh.lane_sizes(self._local_batch)
        total = keys.shape[0]
        off = 0
        # per-step shuffle traffic: every tuple column rides the
        # all_to_all once (keys + panes int32 + the value columns)
        step_bytes = GB * (8 + sum(np.dtype(dt).itemsize
                                   for dt in self._val_dtypes.values()))
        while True:
            t0 = time.perf_counter()
            lo, hi = off, min(off + GB, total)
            m = hi - lo
            k_sl = np.full(GB, -1, np.int32)
            p_sl = np.zeros(GB, np.int32)
            k_sl[:m] = keys[lo:hi]
            p_sl[:m] = panes[lo:hi]
            v_sl = core.stage_lanes(mesh, self._local_batch, vals, lo, m)
            out = self._step(
                *self._state, mesh.split(k_sl, sizes), v_sl,
                mesh.split(p_sl, sizes),
                min(self._frontier, np.iinfo(np.int32).max))
            self._state = out[:5]
            # ONE read-back per step and card: every fire result and the
            # late counts (summed here over the groups)
            res, res_valid, res_wid, n_late = out[5], out[6], out[7], out[9]
            host = core.read_host(mesh, {
                **{f"r:{f}": core.pick(mesh, res, f)
                   for f in self._out_fields},
                "valid": res_valid, "wid": res_wid,
                "late": [n.reshape(1) for n in n_late]
                if mesh.n_groups > 1 else n_late.reshape(1)})
            self.stats.device_programs_run += 1
            self.stats.note_mesh_step((time.perf_counter() - t0) * 1e6,
                                      step_bytes)
            self._backlog_bound = max(0, self._backlog_bound
                                      - self.op.fire_rounds)
            n_late = int(host["late"].sum())
            if n_late:
                self.stats.inputs_ignored += n_late
                # drop-only: these rows were counted late at arrival
                self.stats.note_late(0, n_late)
            self._emit_fired({f: host[f"r:{f}"] for f in self._out_fields},
                             host["valid"], host["wid"])
            off = hi
            if off >= total:
                break

    def _emit_fired(self, res, res_valid, res_wid) -> None:
        """The step's fired windows (K_pad x fire_rounds) as ONE columnar
        batch: rows in (slot, round) order with the original key, the
        epoch-anchored ``wid``, ``valid`` and the aggregates (meaningless
        where ``valid`` is False); each row's ts is its window's end."""
        fired = res_wid >= 0
        n_out = int(fired.sum())
        if not n_out:
            return
        key_field = self.op.key_field or "key"
        wid_base = (self._pane_base or 0) // self.slide_units
        krows, rounds = np.nonzero(fired)
        wids = res_wid[krows, rounds].astype(np.int64) + wid_base
        end_ts = (wids * self.slide_units + self.win_units) \
            * self.op.pane_len
        cols: Dict[str, np.ndarray] = {
            key_field: self._key_by_slot[krows],  # slots -> original keys
            "wid": wids,
            "valid": res_valid[krows, rounds],
        }
        for f in self._out_fields:
            cols[f] = res[f][krows, rounds]
        schema = TupleSchema({name: col.dtype for name, col in cols.items()})
        dev = self.device
        fields = {name: to_device(np.ascontiguousarray(col), dev)
                  for name, col in cols.items()}
        self._emit_batch(BatchGPU(fields, end_ts, n_out, schema, self.cur_wm,
                                  host_keys=cols[key_field]))

    def flush_on_termination(self) -> None:
        """EOS: fire every remaining window that holds data (partial
        windows fire with their partial content)."""
        if self._step is None and self._pending_restore is not None:
            self._ensure(None)
        if self._step is None or self._max_pane_seen < 0:
            return
        self._advance_frontier(self._max_pane_seen + self.win_units + 1)
        # ONE control-state fetch sizes the drain: with the frontier past
        # every pane, key k has (ml - nf) // slide + 1 windows left
        nf, ml = self._host_control()
        per_key = (ml - nf) // self.slide_units + 1
        n_win = int(np.maximum(per_key, 0).max(initial=0))
        for _ in range(-(-n_win // self.op.fire_rounds)):
            self._run_steps(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            self._empty_vals())


__all__ = ["Ffat_Windows_Mesh", "FfatMeshReplica"]
