"""Ffat_Windows_GPU: sliding-window lift+combine aggregation over a batched
FlatFAT forest in device memory.

The port of ``windflow_tpu/tpu/ffat_tpu.py`` (reference: WindFlow's
``Ffat_Windows_GPU``, ``wf/ffat_windows_gpu.hpp`` +
``wf/ffat_replica_gpu.hpp`` + ``wf/flatfat_gpu.hpp``).

- The HOST control plane is the JAX package's numpy code, unchanged: key
  -> slot map, per-slot pane bookkeeping, late accounting, the full fire
  plan (``prep_device_batch``, ``_fireable``, ``_pack_fire_arrays``),
  build-then-commit growth of key capacity and ring length, and the
  deferred-rebuild flag.
- The DEVICE plane is eager torch on the operator's device: lift ->
  segmented scan -> leaf scatter-combine -> forest level rebuild -> window
  range queries -> leaf eviction. The rebuild is the hand-written kernel
  ``kernels/forest_rebuild.cu`` on a CUDA card (every rebuild, no gate)
  and its plain version on the CPU; the other stages are torch ops
  (the Hillis-Steele scan of ``gpu/scan.py`` calling the user combine,
  ``index_put_`` scatters, a vectorized ``LOGQ``-step tree walk).
- The forest is updated IN PLACE (the JAX package donates it instead).
  Every plane is a view of a flat buffer with one trailing scratch
  element: masked scatter lanes write there, which is how the port does
  ``mode="drop"`` without a host round trip. The order the fire-only
  program's soundness relies on is kept: every fire path rebuilds before
  it queries, and evicts after.

Segmentation (sort order + run detection) runs on the host with numpy
when the forest lives on the CPU and on the device with
``torch.sort(stable=True)`` on a card; assigning ``_host_seg`` selects
either mode.

Window semantics match the JAX operator: pane = gcd(win, slide) (TB) or
one tuple (CB); TB windows fire when the watermark minus lateness passes
their end; empty windows fire with ``valid=False``; tuples behind the
eviction frontier are counted late and ignored; EOS flushes partial
windows. Output batches carry one row per fired window: the combined
value columns, ``wid``, ``valid`` and the key column.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..basic import OpType, RoutingMode, WinType, WindFlowError
from ..kernels.forest_rebuild import forest_rebuild
from .batch import BatchGPU, to_device
from .keymap import KeySlotMap, group_positions
from .ops_gpu import GPUOperatorBase, GPUReplicaBase, op_batch_keys_np
from .scan import segmented_scan
from .schema import TupleSchema, broadcast_scalar_fields, numpy_dtype


class Ffat_Windows_GPU(GPUOperatorBase):
    op_type = OpType.WIN_GPU

    def __init__(self, lift: Callable, combine: Callable, key_extractor,
                 win_len: int, slide_len: int,
                 win_type: WinType = WinType.TB, lateness: int = 0,
                 num_win_per_batch: Optional[int] = None,
                 name: str = "ffat_windows_gpu", parallelism: int = 1,
                 output_batch_size: int = 0,
                 schema: Optional[TupleSchema] = None,
                 key_capacity: int = 16) -> None:
        if key_extractor is None:
            raise WindFlowError(f"{name}: requires a key extractor")
        if win_len <= 0 or slide_len <= 0:
            raise WindFlowError(f"{name}: win/slide must be > 0")
        super().__init__(name, parallelism, RoutingMode.KEYBY, key_extractor,
                         output_batch_size, schema)
        self.lift = lift
        self.combine = combine
        self.win_len = win_len
        self.slide_len = slide_len
        self.win_type = win_type
        self.lateness = lateness
        self.key_capacity = max(1, key_capacity)
        if num_win_per_batch is None:
            # fired windows per step scale with key count: default the
            # fire-batch budget to the key capacity
            num_win_per_batch = max(16, min(8192, self.key_capacity))
        self.num_win_per_batch = max(1, num_win_per_batch)
        self.pane_len = math.gcd(win_len, slide_len)

    def configure(self, execution_mode, time_policy, device) -> None:
        if device.type == "cuda" and not hasattr(self.combine, "op_code"):
            raise WindFlowError(
                f"{self.name}: on CUDA the forest-rebuild kernel folds "
                "fieldwise(...) combines only (sum/min/max per field); an "
                "arbitrary torch combine runs on device='cpu' — arbitrary "
                "combines in the kernel are not yet ported")
        super().configure(execution_mode, time_policy, device)

    @property
    def fusion_role(self) -> Optional[str]:
        """``"window_terminator"``: the window op may END a fused device
        chain (its step absorbs a stateless map/filter prefix,
        ``fused_ops.FusedFfatReplica``) but never sits mid-chain: it
        changes the row domain (tuples -> fired windows)."""
        return "window_terminator"

    def build_replicas(self) -> None:
        self.replicas = [FfatGPUReplica(self, i)
                         for i in range(self.parallelism)]


class FfatGPUReplica(GPUReplicaBase):
    def __init__(self, op: Ffat_Windows_GPU, idx: int) -> None:
        super().__init__(op, idx)
        if op.win_type is WinType.CB:
            self.win_units = op.win_len
            self.slide_units = op.slide_len
        else:
            self.win_units = op.win_len // op.pane_len
            self.slide_units = op.slide_len // op.pane_len
        # ring length: window + slack for panes ahead of the watermark
        self.F = 1 << max(3, math.ceil(math.log2(
            self.win_units + max(2 * self.slide_units, 16))))
        self.K_cap = 1 << max(2, math.ceil(math.log2(op.key_capacity)))
        # two fire-budget tiers (see _first_budget)
        self.W_cap = op.num_win_per_batch
        self.W_step = min(self.W_cap, 64)
        self._fire_ewma = 0.0
        self._keymap = KeySlotMap(on_new=self._on_new_key)
        self.slot_of_key = self._keymap.slot_of_key  # shared dict
        self._out_keys_by_slot: List[Any] = []
        # per-slot host bookkeeping (numpy, grown with K_cap)
        self.next_fire = np.zeros(self.K_cap, dtype=np.int64)
        self.fired = np.zeros(self.K_cap, dtype=np.int64)  # == next gwid
        self.max_leaf = np.full(self.K_cap, -1, dtype=np.int64)
        self.count = np.zeros(self.K_cap, dtype=np.int64)  # CB arrivals
        self._keys_np = np.zeros(self.K_cap, dtype=np.int64)
        self._keys_all_int = True
        self._key_dtype = np.dtype(np.int32)
        self._saw_new_key = False
        self._leaf_frontier = 0  # max leaf ever accepted (fast-path guard)
        # deferred-rebuild flag: True while internal tree levels are stale
        # w.r.t. leaves (ingest-only batches ran since the last rebuild)
        self._rebuild_dirty = False
        self._ktable_dev = None
        self._ktable_kd = None
        self._ktable_dirty = True
        self.ignored = 0
        # device forest (shaped once the lift output is known): per field
        # a flat buffer of K_cap*2F + 1 elements (the last one is the
        # scratch target of masked scatter lanes) and its (K_cap, 2F) view
        self._flat: Optional[Dict[str, torch.Tensor]] = None
        self._vflat: Optional[torch.Tensor] = None
        self.trees: Optional[Dict[str, torch.Tensor]] = None
        self.tvalid: Optional[torch.Tensor] = None
        self.__host_seg = None
        self._check_index_plane()

    def _comp_dtype(self):
        """(sentinel M, dtype) of the packed composite sort key."""
        M = self.K_cap * self.F
        return M, (np.int16 if M < 2**15 - 1 else np.int32)

    def _check_index_plane(self, k_cap: int = 0, f: int = 0) -> None:
        """Every forest index (host composite sort, device scatter/evict
        flat ids) lives in int32; enforced at init and BEFORE any growth
        commits — in BOTH segmentation modes. ``k_cap``/``f`` check a
        PROSPECTIVE capacity/ring before mutating toward it (growth must
        raise-before-mutate: a caught refusal mid-growth would leave a
        wrapped index plane that no later per-batch guard re-checks)."""
        k = k_cap or self.K_cap
        ff = f or self.F
        if k * 2 * ff >= 2**31 - 1:
            raise WindFlowError(
                f"{self.op.name}: K_cap*2F = {k * 2 * ff} "
                "overflows the int32 index plane; reduce key_capacity or "
                "the window/slide ratio")

    @property
    def _host_seg(self) -> bool:
        if self.__host_seg is None:
            self.__host_seg = self.device.type == "cpu"
        return self.__host_seg

    @_host_seg.setter
    def _host_seg(self, v) -> None:
        self.__host_seg = v

    def _on_accelerator(self) -> bool:
        """Policy test for the two-tier fire budget."""
        return self.device.type != "cpu"

    # ==================================================================
    # fused-chain seams (overridden by fused_ops.FusedFfatReplica)
    # ==================================================================
    def _lift_fn(self) -> Callable:
        """The lift every device step calls. The fused-chain replica puts
        the chain's stateless map prefix in front of the user lift."""
        return self.op.lift

    def _prefix_mask(self, batch: BatchGPU) -> Optional[np.ndarray]:
        """Host keep mask of a fused prefix filter over ``batch`` (None
        when there is none, as in the base replica). It is taken at PREP
        time: the host control plane's liveness quantities (max_leaf,
        next_fire, the CB count) are exact, so a row the prefix drops may
        never register a key, advance a leaf or count toward a CB
        window."""
        return None

    def _chain_tag(self):
        """What tells a fused prefix's steps apart from the bare window's
        (None here, the prefix's names in the fused replica): the JAX
        package keys its compiled steps by it. Nothing in the port caches
        steps yet; a captured CUDA graph of the step would be keyed by
        it."""
        return None

    # ==================================================================
    # the device plane
    # ==================================================================
    def _alloc_forest(self, k_cap: int, f: int, dtypes: Dict[str, Any]):
        """Zeroed ``(flat, trees, vflat, tvalid)`` planes of one geometry."""
        m = k_cap * 2 * f
        flat = {nm: torch.zeros(m + 1, dtype=dt, device=self.device)
                for nm, dt in dtypes.items()}
        vflat = torch.zeros(m + 1, dtype=torch.bool, device=self.device)
        trees = {nm: b[:m].view(k_cap, 2 * f) for nm, b in flat.items()}
        return flat, trees, vflat, vflat[:m].view(k_cap, 2 * f)

    def _install_forest(self, planes) -> None:
        self._flat, self.trees, self._vflat, self.tvalid = planes

    def _comb_valid(self, va, a, vb, b):
        """Ordered combine with validity: an invalid side passes the other
        through (None-as-identity, like the CPU FlatFAT)."""
        both = va & vb
        merged = self.op.combine(a, b)
        out = {k: torch.where(both, merged[k], torch.where(va, a[k], b[k]))
               for k in a}
        return va | vb, out

    def _range_query(self, base, lo, length):
        """Ordered combine of physical leaf range [lo, lo+length) of the
        tree rows at ``base`` (flat row offsets): iterative segment-tree
        walk, left/right accumulators keep combine order."""
        F = self.F
        nn = 2 * F
        W = base.shape[0]
        zero = {k: torch.zeros(W, dtype=b.dtype, device=self.device)
                for k, b in self._flat.items()}
        off = torch.zeros(W, dtype=torch.bool, device=self.device)
        lv, la, rv, ra = off, zero, off, zero
        l, r = lo + F, lo + length + F
        for _ in range(nn.bit_length()):
            take_l = ((l & 1) == 1) & (l < r)
            il = base + l.clamp(0, nn - 1)
            lv, la = self._comb_valid(
                lv, la, self._vflat[il] & take_l,
                {k: b[il] for k, b in self._flat.items()})
            l = torch.where(take_l, l + 1, l)
            take_r = ((r & 1) == 1) & (l < r)
            ir = base + (r - 1).clamp(0, nn - 1)
            rv, ra = self._comb_valid(
                self._vflat[ir] & take_r,
                {k: b[ir] for k, b in self._flat.items()}, rv, ra)
            r = torch.where(take_r, r - 1, r)
            l, r = l >> 1, r >> 1
        return self._comb_valid(lv, la, rv, ra)

    def _fire_and_evict(self, f_pack: torch.Tensor, e_pack: torch.Tensor):
        """Vectorized window queries for every fire lane, then leaf
        eviction (in place) and the wid/key output columns."""
        F = self.F
        nn = 2 * F
        m = self.K_cap * nn
        fire_slots, starts, lens, wids, mask_i = f_pack
        fire_mask = mask_i != 0
        base = fire_slots * nn
        len1 = torch.minimum(lens, F - starts)
        v1, r1 = self._range_query(base, starts, len1)
        v2, r2 = self._range_query(base, torch.zeros_like(starts),
                                   lens - len1)
        qv, qr = self._comb_valid(v1, r1, v2, r2)
        qv = qv & fire_mask
        e_slots, e_leaves, e_mask_i = e_pack
        eflat = torch.where(e_mask_i != 0, e_slots * nn + (F + e_leaves), m)
        self._vflat.index_put_((eflat,), torch.zeros(
            (), dtype=torch.bool, device=self.device))
        if self._use_ktable():
            ktable = self._ktable_arg()
            key_out = torch.where(fire_mask, ktable[fire_slots],
                                  torch.zeros((), dtype=ktable.dtype,
                                              device=self.device))
        else:
            key_out = None
        return qr, qv, wids, key_out

    def _rebuild(self) -> None:
        forest_rebuild(self.trees, self.tvalid, self.op.combine)
        if self.device.type == "cuda":
            self.stats.rebuild_kernel_launches += 1

    def _ingest(self, fields, seg) -> None:
        """Lift + sort + segmented scan + leaf scatter-combine (in place)."""
        F = self.F
        nn = 2 * F
        m = self.K_cap * nn
        n_rows = next(iter(fields.values())).shape[0]
        vals = broadcast_scalar_fields(self._lift_fn()(fields), n_rows,
                                       self.device)
        comp, order, same_prev, is_end, flat_idx = seg
        if comp is not None:
            # device segmentation: stable sort of the packed composite
            # (slot*F + leaf, sentinel K_cap*F for late and padding lanes)
            big = self.K_cap * F
            order = torch.sort(comp, stable=True).indices.to(torch.int32)
            sc = comp[order].to(torch.int32)
            same_prev = torch.cat([torch.zeros(1, dtype=torch.bool,
                                               device=self.device),
                                   sc[1:] == sc[:-1]])
            is_end = torch.cat([sc[1:] != sc[:-1],
                                torch.ones(1, dtype=torch.bool,
                                           device=self.device)]) & (sc < big)
            flat_idx = (sc // F) * nn + (F + sc % F)
        svals = {k: v[order] for k, v in vals.items()}
        scanned = segmented_scan(self.op.combine, svals, same_prev)
        # scatter-combine segment tails into forest leaves; other lanes
        # land on the scratch element m
        safe = torch.where(is_end, flat_idx, m)
        leaf_valid = self._vflat[safe] & is_end
        cur = {k: b[safe] for k, b in self._flat.items()}
        merged = self.op.combine(cur, scanned)
        for k, b in self._flat.items():
            b.index_put_((safe,), torch.where(leaf_valid, merged[k],
                                              scanned[k]))
        self._vflat.index_put_((safe,), torch.ones(
            (), dtype=torch.bool, device=self.device))

    def _ensure_rebuilt(self) -> None:
        """Run the standalone rebuild iff ingest-only batches deferred it
        (idempotent). In-flight commits land first: both the dirty flag
        and the forest belong to the commit stage."""
        self.dispatch.drain(forced=True)
        if not self._rebuild_dirty or self.trees is None:
            return
        self._rebuild()
        self.stats.device_programs_run += 1
        self._rebuild_dirty = False

    # ==================================================================
    # host control plane
    # ==================================================================
    def _on_new_key(self, key, s: int) -> None:
        """KeySlotMap callback: per-slot bookkeeping for a fresh key
        (raise-before-mutate: growth is validated first)."""
        if s >= self.K_cap:
            self._check_index_plane(self.K_cap * 2)
            self._grow_keys()
        self._saw_new_key = True
        self._out_keys_by_slot.append(key)
        if self._keys_all_int and isinstance(key, int):
            self._keys_np[s] = key
        else:
            self._keys_all_int = False
        self._ktable_dirty = True

    def _grow_keys(self) -> None:
        """BUILD-THEN-COMMIT: every fallible step (including the device
        reallocation of the doubled forest) runs into locals first."""
        self.dispatch.drain(forced=True)
        old = self.K_cap
        new_cap = old * 2
        grown = {}
        for name, fill in (("next_fire", 0), ("fired", 0),
                           ("max_leaf", -1), ("count", 0),
                           ("_keys_np", 0)):
            arr = getattr(self, name)
            g = np.full(new_cap, fill, dtype=arr.dtype)
            g[:old] = arr
            grown[name] = g
        planes = None
        if self.trees is not None:
            planes = self._alloc_forest(
                new_cap, self.F, {k: t.dtype for k, t in self.trees.items()})
            for k, t in planes[1].items():
                t[:old] = self.trees[k]
            planes[3][:old] = self.tvalid
        self.K_cap = new_cap
        for name, g in grown.items():
            setattr(self, name, g)
        if planes is not None:
            self._install_forest(planes)
        self._ktable_dirty = True

    def _grow_ring(self, needed_span: int) -> None:
        """BUILD-THEN-COMMIT, like ``_grow_keys`` (F and the migrated
        forest commit together, after the fallible allocations)."""
        self.dispatch.drain(forced=True)
        old_F = self.F
        new_F = old_F
        while needed_span >= new_F:
            new_F *= 2
        self._check_index_plane(f=new_F)
        if self.trees is None:
            self.F = new_F
            return
        planes = self._alloc_forest(
            self.K_cap, new_F, {k: t.dtype for k, t in self.trees.items()})
        src_rows, src_cols, dst_cols = [], [], []
        for _, s in self.slot_of_key.items():
            for p in range(int(self.next_fire[s]), int(self.max_leaf[s]) + 1):
                src_rows.append(s)
                src_cols.append(old_F + (p % old_F))
                dst_cols.append(new_F + (p % new_F))
        if src_rows:
            sr, sc, dc = (torch.as_tensor(np.asarray(a), device=self.device)
                          for a in (src_rows, src_cols, dst_cols))
            for k, t in planes[1].items():
                t[sr, dc] = self.trees[k][sr, sc]
            planes[3][sr, dc] = self.tvalid[sr, sc]
        self.F = new_F
        self._install_forest(planes)
        # only leaves were carried over: internal levels need a rebuild
        # before any fire-only program may query them
        self._rebuild_dirty = True

    def _ensure_forest(self, sample_fields) -> None:
        """Shape the forest from the lift's output dtypes on a one-row
        slice of the first batch."""
        if self.trees is not None:
            return
        one = {k: v[:1] for k, v in sample_fields.items()}
        out = self._lift_fn()(one)
        if not isinstance(out, dict):
            raise WindFlowError(f"{self.op.name}: lift must return a dict "
                                "of columns")
        vals = broadcast_scalar_fields(out, 1, self.device)
        ops = getattr(self.op.combine, "ops", None)
        if ops is not None and set(ops) != set(vals):
            raise WindFlowError(
                f"{self.op.name}: fieldwise combine names {sorted(ops)} but "
                f"the lift returns {sorted(vals)}")
        self._install_forest(self._alloc_forest(
            self.K_cap, self.F, {k: v.dtype for k, v in vals.items()}))

    # ------------------------------------------------------------------
    def prep_device_batch(self, batch: BatchGPU):
        """HOST-PREP stage of the dispatch pipeline: slot resolution, leaf
        bookkeeping, window fire decisions, fire-pack assembly — host
        metadata only, never a wait on a device result. Paths that touch
        the forest (growth) drain the pipeline first."""
        op = self.op
        n = batch.size
        if n == 0:
            return None
        self._ensure_forest(batch.fields)
        if op.key_field is not None and op.key_field in batch.fields:
            self._key_dtype = numpy_dtype(batch.fields[op.key_field].dtype)
        # fused prefix filter (FusedFfatReplica): the rows it drops must
        # not exist for the control plane at all, exactly like the rows an
        # unfused filter stage compacts away before the window sees them
        keep = self._prefix_mask(batch)
        rowsel = None
        if keep is not None:
            n_kept = int(keep.sum())
            if n_kept < n:
                self.stats.inputs_ignored += n - n_kept
                if n_kept == 0:
                    return None
                rowsel = np.nonzero(keep)[0]
        keys, keys_arr = op_batch_keys_np(op, batch)
        if rowsel is not None:
            sub_arr = np.asarray(keys_arr)[rowsel]
            keys = (sub_arr if isinstance(keys, np.ndarray)
                    else [keys[i] for i in rowsel])
            keys_arr = sub_arr
            n_rows = len(rowsel)
            ts_rows = batch.ts_host[:n][rowsel]
        else:
            n_rows = n
            ts_rows = batch.ts_host[:n]
        slots = self._keymap.slots_of(keys, keys_arr, n_rows)
        if op.win_type is WinType.TB:
            leaves = ts_rows // op.pane_len
        else:
            # CB: leaf = per-key arrival index (stable within the batch)
            _, within = group_positions(slots, self.K_cap)
            leaves = self.count[slots] + within
            np.add.at(self.count, slots, 1)
        # align brand-new keys to the first window containing their first
        # leaf (see the JAX operator for the gating argument)
        if op.win_type is WinType.TB and (
                self._saw_new_key or self.slide_units > self.win_units):
            self._saw_new_key = False
            fresh = self.max_leaf[slots] < 0
            if fresh.any():
                fslots = slots[fresh]
                fleaves = leaves[fresh]
                first_leaf = np.full(self.K_cap, np.iinfo(np.int64).max,
                                     dtype=np.int64)
                np.minimum.at(first_leaf, fslots, fleaves)
                sel = np.unique(fslots)
                new_mask = self.max_leaf[sel] < 0
                sel = sel[new_mask]
                w0 = np.maximum(
                    0, (first_leaf[sel] - self.win_units)
                    // self.slide_units + 1)
                self.next_fire[sel] = w0 * self.slide_units
                self.fired[sel] = w0
        nf = self.next_fire[slots]
        live = leaves >= nf
        n_live = int(live.sum())
        n_late = n_rows - n_live
        # unified late accounting (the same classification the packed
        # composite encodes for the device)
        st = self.stats
        if op.win_type is WinType.TB:
            late_mask = ts_rows < batch.wm
            if n_late:
                late_mask = late_mask | ~live
            n_late_seen = int(late_mask.sum())
            if n_late_seen:
                st.note_late(n_late_seen, n_late)
        elif n_late:
            st.note_late(n_late, n_late)
        if n_late:
            self.ignored += n_late
            self.stats.inputs_ignored += n_late
        if n_live:
            if (n_late == 0 and n_rows
                    and int(leaves[0]) >= self._leaf_frontier
                    and bool((leaves[1:] >= leaves[:-1]).all())):
                span = int((leaves - nf).max())
                if span >= self.F:
                    self._grow_ring(span)
                self.max_leaf[slots] = leaves
                self._leaf_frontier = int(leaves[-1])
            else:
                masked_leaves = np.where(live, leaves, -1)
                span = int(np.where(live, leaves - nf, -1).max())
                if span >= self.F:
                    self._grow_ring(span)
                np.maximum.at(self.max_leaf, slots, masked_leaves)
                self._leaf_frontier = max(self._leaf_frontier,
                                          int(masked_leaves.max()))

        cap = batch.capacity
        M, cdt = self._comp_dtype()
        comp_p = np.full(cap, M, dtype=cdt)
        packed = slots * self.F + (leaves & (self.F - 1))  # F is pow-2
        if n_late:
            packed = np.where(live, packed, M)
        if rowsel is None:
            comp_p[:n] = packed
        else:
            # prefix-dropped rows keep the sentinel: the device step treats
            # them like late and padding lanes
            comp_p[rowsel] = packed
        if self._host_seg:
            big = cdt(M)
            order_p = np.argsort(comp_p, kind="stable").astype(np.int32)
            sc = comp_p[order_p].astype(np.int32)
            same_p = np.r_[False, sc[1:] == sc[:-1]]
            end_p = np.r_[sc[1:] != sc[:-1], True] & (sc < big)
            flat_p = (sc // self.F) * (2 * self.F) + self.F + sc % self.F
            seg = (None,) + tuple(to_device(np.ascontiguousarray(a),
                                             self.device)
                                  for a in (order_p, same_p, end_p, flat_p))
        else:
            seg = (to_device(comp_p, self.device), None, None, None, None)

        frontier = (max(0, batch.wm - op.lateness) // op.pane_len
                    if op.win_type is WinType.TB else None)
        return self._prep_step(batch.fields, batch.wm, seg, frontier)

    # ------------------------------------------------------------------
    def _fireable(self, frontier, partial: bool, budget: int):
        """Fire-eligible windows as per-slot chunk ARRAYS
        (slots, start0, k, wid0, max_leaf), each chunk covering the slot's
        consecutive eligible windows, truncated to ``budget``. Advances
        next_fire/fired for the windows taken."""
        ns = len(self.slot_of_key)
        empty = (np.zeros(0, np.int64),) * 5
        if ns == 0:
            return empty
        nf = self.next_fire[:ns]
        ml = self.max_leaf[:ns]
        has_data = ml >= nf
        if partial:
            k = (ml - nf) // self.slide_units + 1
        elif self.op.win_type is WinType.TB:
            if frontier is None:
                return empty
            k_front = ((int(frontier) - self.win_units - nf)
                       // self.slide_units + 1)
            k = np.minimum((ml - nf) // self.slide_units + 1, k_front)
        else:  # CB fires purely by count
            k_cnt = ((self.count[:ns] - self.win_units - nf)
                     // self.slide_units + 1)
            k = np.minimum((ml - nf) // self.slide_units + 1, k_cnt)
        k = np.where(has_data, k, 0)
        slots = np.nonzero(k > 0)[0]
        if slots.size == 0:
            return empty
        k = k[slots]
        before = np.cumsum(k) - k
        k = np.minimum(k, budget - before)
        keep = k > 0
        slots, k = slots[keep], k[keep]
        start0 = self.next_fire[slots].copy()
        wid0 = self.fired[slots].copy()
        self.next_fire[slots] += k * self.slide_units
        self.fired[slots] += k
        return slots, start0, k, wid0, self.max_leaf[slots].copy()

    @staticmethod
    def _segmented_arange(k: np.ndarray) -> np.ndarray:
        """[0..k0), [0..k1), ... concatenated (standard cumsum trick)."""
        tot = int(k.sum())
        before = np.cumsum(k) - k
        return np.arange(tot, dtype=np.int64) - np.repeat(before, k)

    def _pack_fire_arrays(self, chunks, n_out, W: int):
        """Chunk arrays -> padded fire/evict arrays: one (5, W) int32 pack
        (rows: slot, start, len, wid, mask) and one (3, E) pack (rows:
        slot, leaf, mask). Every query is clipped to the slot's data
        extent (max_leaf) — what makes the rebuild-free fire-only program
        sound (see the JAX operator's ``_make_fire_step``)."""
        c_slots, c_start0, c_k, c_wid0, c_ml = chunks
        E = max(1, W * self.slide_units)
        f_pack = np.zeros((5, W), dtype=np.int32)
        e_pack = np.zeros((3, E), dtype=np.int32)
        ar = self._segmented_arange(c_k)
        starts = np.repeat(c_start0, c_k) + ar * self.slide_units
        f_pack[0, :n_out] = np.repeat(c_slots, c_k)
        f_pack[1, :n_out] = starts % self.F
        f_pack[2, :n_out] = np.minimum(self.win_units,
                                       np.repeat(c_ml, c_k) + 1 - starts)
        f_pack[4, :n_out] = 1
        f_pack[3, :n_out] = np.repeat(c_wid0, c_k) + ar
        ne = np.maximum(
            0, np.minimum(c_start0 + c_k * self.slide_units, c_ml + 1)
            - c_start0)
        tot_e = int(ne.sum())
        if tot_e:
            ep = np.repeat(c_start0, ne) + self._segmented_arange(ne)
            e_pack[0, :tot_e] = np.repeat(c_slots, ne)
            e_pack[1, :tot_e] = ep % self.F
            e_pack[2, :tot_e] = 1
        return f_pack, e_pack

    def _use_ktable(self) -> bool:
        """Whether the key column is gathered from a device-resident
        per-slot key table (int keys with a named key field)."""
        return self._keys_all_int and self.op.key_field is not None

    def _ktable_arg(self) -> torch.Tensor:
        """Device key table, re-staged only when a new key registered or
        the capacity/dtype changed."""
        kd = self._key_dtype
        if (self._ktable_dev is None or self._ktable_dirty
                or self._ktable_kd != kd):
            self._ktable_dev = to_device(self._keys_np.astype(kd),
                                          self.device)
            self._ktable_kd = kd
            self._ktable_dirty = False
        return self._ktable_dev

    def _first_budget(self) -> int:
        """Fire budget of the first (full) step of a batch: the small
        W_step block, or W_cap when the recent fire rate overflows it
        (accelerator policy only)."""
        if not self._on_accelerator() \
                or self._fire_ewma * 1.25 <= self.W_step:
            return self.W_step
        return self.W_cap

    def _prep_step(self, fields, wm, seg, frontier):
        """Host half of the per-batch step: the ENTIRE fire plan — every
        drain iteration's chunk arrays and packed fire/evict args, staged
        to the device now — and the fire-rate EWMA. Returns the
        device-commit thunk for the dispatch pipeline."""
        plan: List[Any] = []
        first = True
        total_fired = 0
        first_budget = self._first_budget()
        while True:
            budget = first_budget if first else self.W_cap
            chunks = self._fireable(frontier, False, budget)
            n_out = int(chunks[2].sum())
            if not first and not n_out:
                break
            if first and not n_out:
                # nothing fireable: ingest-only step, rebuild DEFERRED
                plan.append(None)
                break
            f_pack, e_pack = self._pack_fire_arrays(chunks, n_out, budget)
            plan.append((first, chunks, n_out,
                         to_device(f_pack, self.device),
                         to_device(e_pack, self.device), budget))
            total_fired += n_out
            first = False
            if n_out < budget:
                break
        if total_fired > self._fire_ewma:
            self._fire_ewma = float(total_fired)
        else:
            self._fire_ewma += 0.25 * (total_fired - self._fire_ewma)
        return lambda: self._commit_step(fields, wm, seg, plan)

    def _commit_step(self, fields, wm, seg, plan) -> None:
        """Device half: runs the planned steps in order and emits each
        iteration's windows. Owns the ``_rebuild_dirty`` updates: they
        must land in device order."""
        for entry in plan:
            if entry is None:
                # ingest-only: leaves current, internal nodes stale until
                # the next firing step or standalone rebuild
                self._ingest(fields, seg)
                self._rebuild_dirty = True
                self.stats.device_programs_run += 1
                continue
            is_first, chunks, n_out, f_pack, e_pack, budget = entry
            if is_first:
                # full step: ingest + rebuild + fire; the full-forest
                # rebuild covers every deferred ingest-only batch
                self._ingest(fields, seg)
                self._rebuild()
                self._rebuild_dirty = False
            out = self._fire_and_evict(f_pack, e_pack)
            self.stats.device_programs_run += 1
            self._emit_windows(wm, chunks, n_out, *out, budget)

    def _emit_windows(self, wm, chunks, n_out, qr, qv, wid_dev, key_dev,
                      W: int) -> None:
        op = self.op
        fields = dict(qr)
        fields["valid"] = qv
        fields["wid"] = wid_dev
        c_slots, _st, c_k, _w0, _ml = chunks
        slot_per_win = np.repeat(c_slots, c_k)
        if self._keys_all_int:
            out_keys: Any = self._keys_np[slot_per_win]
        else:
            out_keys = [self._out_keys_by_slot[s] for s in slot_per_win]
        if op.key_field is not None:
            if key_dev is not None:
                fields[op.key_field] = key_dev
            else:
                key_col = np.zeros(W, dtype=self._key_dtype)
                key_col[:n_out] = out_keys
                fields[op.key_field] = to_device(key_col, self.device)
        out_schema = TupleSchema(
            {name: numpy_dtype(v.dtype) for name, v in fields.items()})
        ts = np.full(W, wm, dtype=np.int64)
        self._emit_batch(BatchGPU(fields, ts, n_out, out_schema, wm,
                                  out_keys))

    # ------------------------------------------------------------------
    def _fire_dataless(self, frontier, partial: bool) -> None:
        """Watermark/EOS made windows fireable without new data: fire-only
        steps, after settling any rebuild deferred by ingest-only
        batches."""
        if self.trees is None:
            return
        self.dispatch.drain(forced=True)
        while True:
            chunks = self._fireable(frontier, partial, self.W_cap)
            n_out = int(chunks[2].sum())
            if not n_out:
                return
            self._ensure_rebuilt()
            f_pack, e_pack = self._pack_fire_arrays(chunks, n_out,
                                                    self.W_cap)
            out = self._fire_and_evict(to_device(f_pack, self.device),
                                       to_device(e_pack, self.device))
            self.stats.device_programs_run += 1
            self._emit_windows(self.cur_wm, chunks, n_out, *out, self.W_cap)
            if n_out < self.W_cap:
                return

    def on_punctuation(self, wm: int) -> None:
        if self.op.win_type is WinType.TB:
            frontier = (max(0, self.cur_wm - self.op.lateness)
                        // self.op.pane_len)
            self._fire_dataless(frontier, partial=False)
        super().on_punctuation(wm)

    def flush_on_termination(self) -> None:
        self._fire_dataless(None, partial=True)

    # ------------------------------------------------------------------
    # state: the key map, the per-slot host bookkeeping and the forest.
    # ``snapshot_state`` has the JAX replica's layout, ``{"cur_wm", ...,
    # "ffat": {...}}`` with the forest as host numpy; ``restore_state``
    # installs it. ``load_state`` installs the inner ``"ffat"`` dict
    # (``convert.ffat_state_from_jax`` prepares one from the JAX package).
    # The rebuild flag (``rebuild_dirty``) travels in the blob, so a
    # restored forest is rebuilt before its first query.
    def snapshot_state(self) -> dict:
        st = super().snapshot_state()  # drains the dispatch queue
        st["ffat"] = self._ffat_state()
        return st

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        d = state.get("ffat")
        if d is not None:
            self.load_state(d)

    def _ffat_state(self) -> dict:
        return {
            "slot_of_key": dict(self.slot_of_key),
            "out_keys_by_slot": list(self._out_keys_by_slot),
            "K_cap": self.K_cap, "F": self.F,
            "next_fire": self.next_fire.copy(),
            "fired": self.fired.copy(),
            "max_leaf": self.max_leaf.copy(),
            "count": self.count.copy(),
            "keys_np": self._keys_np.copy(),
            "keys_all_int": self._keys_all_int,
            "key_dtype": self._key_dtype,
            "saw_new_key": self._saw_new_key,
            "leaf_frontier": self._leaf_frontier,
            "fire_ewma": self._fire_ewma,
            "rebuild_dirty": self._rebuild_dirty,
            "ignored": self.ignored,
            "trees": (None if self.trees is None else
                      {k: t.cpu().numpy().copy()
                       for k, t in self.trees.items()}),
            "tvalid": (None if self.tvalid is None
                       else self.tvalid.cpu().numpy().copy()),
        }

    def load_state(self, d: dict) -> None:
        self.dispatch.drain(forced=True)
        self.K_cap = d["K_cap"]
        self.F = d["F"]
        self._check_index_plane()
        self.slot_of_key.clear()  # shared alias with the KeySlotMap
        self.slot_of_key.update(d["slot_of_key"])
        self._keymap._lut = None
        self._out_keys_by_slot = list(d["out_keys_by_slot"])
        self.next_fire = np.array(d["next_fire"], dtype=np.int64)
        self.fired = np.array(d["fired"], dtype=np.int64)
        self.max_leaf = np.array(d["max_leaf"], dtype=np.int64)
        self.count = np.array(d["count"], dtype=np.int64)
        self._keys_np = np.array(d["keys_np"], dtype=np.int64)
        self._keys_all_int = d["keys_all_int"]
        self._key_dtype = np.dtype(d["key_dtype"])
        self._saw_new_key = d["saw_new_key"]
        self._leaf_frontier = d["leaf_frontier"]
        self._fire_ewma = d["fire_ewma"]
        self._rebuild_dirty = d["rebuild_dirty"]
        self.ignored = d["ignored"]
        if d["trees"] is None:
            self._flat = self._vflat = self.trees = self.tvalid = None
        else:
            src = {k: torch.as_tensor(v) for k, v in d["trees"].items()}
            planes = self._alloc_forest(
                self.K_cap, self.F, {k: s.dtype for k, s in src.items()})
            for k, t in planes[1].items():
                t.copy_(src[k])
            planes[3].copy_(torch.as_tensor(d["tvalid"]))
            self._install_forest(planes)
        self._ktable_dev = None
        self._ktable_kd = None
        self._ktable_dirty = True
