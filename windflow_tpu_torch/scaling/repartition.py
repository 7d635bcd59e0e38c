"""Split and merge checkpointed keyed state N -> M.

The port of ``windflow_tpu/scaling/repartition.py``. A committed
checkpoint already holds every replica's keyed state in one blob per
replica. Rescaling an operator from N to M replicas re-buckets every
key's state by the SAME routing function its KEYBY emitters use, so that
after the restore each new replica owns exactly the keys the emitters
send it. Host dicts (the host ``Reduce``'s ``key_state``) re-bucket per
key; the device plane's array states (the grid-scan tables of a stateful
``Map_GPU``/``Filter_GPU``, the FFAT forests of ``Ffat_Windows_GPU``)
re-bucket by a slot-row gather along the key axis, in numpy on the host
(blobs hold host arrays only).

Routing is the correctness contract: a host KEYBY routes ``hash(key) %
M``; the device plane routes through ``gpu/routing.py:_dest_of_key``
(identity for non-negative ints, FNV for str/bytes/composite keys, the
same answers as the vectorized column paths ``key_dests``). Both agree
for int keys. ``hash`` of str/bytes is randomized per process, so a
host-plane repartition of such keys is valid within one process only,
which a live rescale always is.

State that cannot be repartitioned fails LOUDLY (``WindFlowError``),
never silently dropped: global (unkeyed) reduce accumulators, BROADCAST-
or FORWARD-routed windows, sources, and any state key this module does
not know.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..basic import OpType, RoutingMode, WindFlowError
from ..gpu.routing import _dest_of_key, _int_keys_hashable_as_identity
from ..pytree import tree_flatten, tree_unflatten

# blob keys that need no repartitioning (merged, not split)
_BENIGN_KEYS = {"cur_wm", "shipped", "__emitter__", "__collector__"}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
class _Dest:
    """The destination function of the KEYBY emitters that feed an
    operator at parallelism ``n``: per key (``__call__``), and over many
    keys at once (``many``: one numpy modulo when every key is a
    non-negative int, where both planes route by identity)."""

    def __init__(self, n: int, device_plane: bool) -> None:
        self.n = n
        self.device_plane = device_plane

    def __call__(self, key) -> int:
        if self.device_plane:
            return _dest_of_key(key, self.n)
        return hash(key) % self.n

    def many(self, keys: List[Any]) -> np.ndarray:
        if keys and all(type(k) is int or isinstance(k, np.integer)
                        for k in keys):
            arr = np.asarray(keys)
            if arr.dtype.kind in "iu" \
                    and _int_keys_hashable_as_identity(arr, len(arr)):
                return arr.astype(np.int64) % self.n
        return np.fromiter((self(k) for k in keys), dtype=np.int64,
                           count=len(keys))


def dest_fn_for(op, new_n: int) -> _Dest:
    """The destination function of the KEYBY emitters that feed ``op`` at
    parallelism ``new_n``: repartitioned state MUST land where the
    emitters will route its keys."""
    return _Dest(new_n, getattr(op, "is_gpu", False))


# ---------------------------------------------------------------------------
# legality
# ---------------------------------------------------------------------------
def repartition_refusal(op) -> Optional[str]:
    """Why ``op``'s state cannot be repartitioned across a different
    replica count; None when rescaling is legal. The reason is what the
    loud error carries (the JAX package's strings)."""
    if op.op_type == OpType.SOURCE:
        return ("source replicas are independent generators; their replay "
                "cursors are positions, not keyed state")
    if getattr(op, "is_mesh", False):
        return ("mesh-sharded operators parallelize over the device mesh, "
                "not the replica count — one host replica drives every "
                "chip; to change capacity, checkpoint and restore with a "
                "different with_mesh(mesh_shape=...) (sharded restore "
                "relayouts the key axis across the new factorization)")
    if getattr(op, "exactly_once", False):
        return ("exactly-once sinks own per-replica transaction logs "
                "(staged epoch segments / transactional producer ids); "
                "changing the replica count would orphan staged epochs "
                "and break the commit fencing")
    if op.input_routing is RoutingMode.BROADCAST:
        return ("BROADCAST-distributed operators assign work by replica "
                "arithmetic (global window ids mod parallelism); their "
                "state is bound to the replica count, not to keys")
    # keyed state without KEYBY routing = a global accumulator (the global
    # Reduce_GPU): one stream-wide value has no keyed partition
    if getattr(op, "fusion_role", None) == "terminator" \
            and op.key_extractor is None:
        return ("global (unkeyed) reduce folds one stream-wide "
                "accumulator; there is no keyed partition to split")
    if op.op_type is OpType.WIN_GPU \
            and op.input_routing is not RoutingMode.KEYBY:
        return (f"{op.input_routing.name}-routed window operators "
                "distribute windows, not keys, across replicas")
    return None


# ---------------------------------------------------------------------------
# splitters
# ---------------------------------------------------------------------------
def _split_keyed_dict(olds: List[Dict[Any, Any]], new_n: int,
                      dest: _Dest) -> List[Dict[Any, Any]]:
    outs: List[Dict[Any, Any]] = [{} for _ in range(new_n)]
    for d in olds:
        keys = list(d)
        for k, j in zip(keys, dest.many(keys)):
            outs[j][k] = d[k]
    return outs


def _merged_wm(states: List[dict]) -> int:
    return max((st.get("cur_wm", 0) for st in states), default=0)


def _per_dest(maps: List[Optional[Dict[Any, int]]], new_n: int,
              dest: _Dest) -> List[List[Tuple[Any, int, int]]]:
    """``(key, source index, source slot)`` per destination, in the JAX
    package's deterministic order: sources in order, keys in slot-map
    insertion order."""
    per_dest: List[List[Tuple[Any, int, int]]] = [[] for _ in range(new_n)]
    for si, m in enumerate(maps):
        if not m:
            continue
        keys = list(m)
        for key, j in zip(keys, dest.many(keys)):
            per_dest[j].append((key, si, m[key]))
    return per_dest


def _gather_rows(src_leaves: List[Optional[list]], li: int, proto,
                 sel: List[Tuple[Any, int, int]], n_rows: int,
                 fill=0, missing: str = "") -> np.ndarray:
    """Leaf ``li`` of a new replica: row ``i`` is source ``sel[i][1]``'s
    slot ``sel[i][2]`` (one numpy fancy-index gather per source), the
    rest ``fill``."""
    proto = np.asarray(proto)
    out = np.full((n_rows,) + proto.shape[1:], fill, dtype=proto.dtype)
    if not sel:
        return out
    sis = np.fromiter((e[1] for e in sel), dtype=np.int64, count=len(sel))
    slots = np.fromiter((e[2] for e in sel), dtype=np.int64,
                        count=len(sel))
    for si in np.unique(sis):
        if src_leaves[si] is None:
            raise WindFlowError(missing.format(si=int(si)))
        rows = np.nonzero(sis == si)[0]
        out[rows] = np.asarray(src_leaves[si][li])[slots[rows]]
    return out


def _split_scan(scans: List[Optional[dict]], new_n: int, dest: _Dest,
                op_name: str) -> List[dict]:
    """Grid-scan keyed state tables (``{"slot_of_key", "table_capacity",
    "table"}``, the table a pytree of host arrays whose axis 0 is the
    slot, without the port's scratch row). Re-bucket the keys, then gather
    each new replica's rows.

    Tiered blobs (a ``"tier"`` sub-dict per source) split across BOTH
    tiers: cold rows re-bucket by the same destination function, and a
    destination whose re-bucketed hot set overflows its (unchanged)
    ``hot_capacity`` spills its coldest keys, ranked by the checkpointed
    eviction order, into its own cold tier."""
    from ..state.tiered import (build_tier_blob, cold_items_from_image,
                                hot_table_digest)

    tiers = [st.get("tier") if st else None for st in scans]
    tiered = any(t is not None for t in tiers)
    proto_tier = next((t for t in tiers if t is not None), None)
    rank: Dict[Tuple[int, Any], int] = {}
    cold_per_dest: List[list] = [[] for _ in range(new_n)]
    if tiered:
        for si, t in enumerate(tiers):
            if not t:
                continue
            for pos, k in enumerate(t.get("order", [])):
                rank[(si, k)] = pos  # higher = hotter (evicted later)
            for key, row in cold_items_from_image(t["cold_image"]):
                cold_per_dest[dest(key)].append((key, row))

    per_dest = _per_dest([st["slot_of_key"] if st else None
                          for st in scans], new_n, dest)
    src = next((st for st in scans if st and st.get("table") is not None),
               None)
    treedef, src_leaves = None, []
    if src is not None:
        proto_leaves, treedef = tree_flatten(src["table"])
        src_leaves = [None if not st or st.get("table") is None
                      else tree_flatten(st["table"])[0] for st in scans]
    missing = (f"repartition: {op_name!r} replica {{si}} registered keys "
               "but checkpointed no state table")
    outs = []
    for j in range(new_n):
        sel = per_dest[j]
        spill: List[Tuple[Any, int, int]] = []
        if tiered:
            cap = int(proto_tier["hot_capacity"])
            # coldest first; the kept tail is the destination's hot set
            sel = sorted(sel, key=lambda e: rank.get((e[1], e[0]), -1))
            n_spill = max(0, len(sel) - cap)
            spill, sel = sel[:n_spill], sel[n_spill:]
        else:
            cap = 64
            while cap < len(sel):
                cap *= 2
        slot_of_key = {key: i for i, (key, _, _) in enumerate(sel)}
        table = None
        if src is not None:
            table = tree_unflatten(treedef, [
                _gather_rows(src_leaves, li, proto, sel, cap,
                             missing=missing)
                for li, proto in enumerate(proto_leaves)])
            if spill:  # overflowing hot rows go to this dest's cold tier
                cols = [_gather_rows(src_leaves, li, proto, spill,
                                     len(spill), missing=missing)
                        for li, proto in enumerate(proto_leaves)]
                for i, (key, _, _) in enumerate(spill):
                    cold_per_dest[j].append(
                        (key, tuple(c[i] for c in cols)))
        elif spill:
            raise WindFlowError(
                f"repartition: {op_name!r} holds tiered keys but "
                "checkpointed no state table to spill rows from")
        blob = {"slot_of_key": slot_of_key, "table_capacity": cap,
                "table": table}
        if tiered:
            blob["tier"] = build_tier_blob(
                proto_tier["policy"], cap,
                free_slots=range(cap - 1, len(sel) - 1, -1),
                order=[key for key, _, _ in sel],  # coldest-first kept
                cold_items=cold_per_dest[j],
                hot_digest=hot_table_digest(table))
        outs.append(blob)
    return outs


_FFAT_HOST_ARRAYS = ("next_fire", "fired", "max_leaf", "count", "keys_np")


def _split_ffat_gpu(ffats: List[dict], new_n: int, dest: _Dest,
                    op_name: str) -> List[dict]:
    """FFAT forests (the JAX package's ``_split_ffat_tpu``): the per-slot
    host arrays ``(K_cap,)`` and the forest planes ``(K_cap, 2F)``
    re-bucket by slot-row gather. Every contributing source must share
    the ring depth F: the node layout depends on F, and relayouting a
    segment-tree ring across depths is refused loudly."""
    fs = {d["F"] for d in ffats if d["slot_of_key"]}
    if len(fs) > 1:
        raise WindFlowError(
            f"repartition: {op_name!r} replicas checkpointed FFAT forests "
            f"with different ring depths F={sorted(fs)}; merging rings of "
            "different depth is not supported — checkpoint at a quieter "
            "moment (F converges) or rescale before backlog builds up")
    per_dest = _per_dest([d["slot_of_key"] for d in ffats], new_n, dest)
    proto = ffats[0]
    F = next(iter(fs), proto["F"])
    host = [[d[f] for f in _FFAT_HOST_ARRAYS] for d in ffats]
    src_tree = next((d for d in ffats
                     if d.get("trees") is not None and d["slot_of_key"]),
                    None)
    if src_tree is not None:
        proto_planes, treedef = tree_flatten(src_tree["trees"])
        tleaves = [None if d.get("trees") is None
                   else tree_flatten(d["trees"])[0] for d in ffats]
        tvalids = [None if d.get("tvalid") is None else [d["tvalid"]]
                   for d in ffats]
    missing = (f"repartition: {op_name!r} replica {{si}} registered keys "
               "but checkpointed no forest")
    outs = []
    for j in range(new_n):
        sel = per_dest[j]
        k_cap = 4
        while k_cap < max(1, len(sel)):
            k_cap *= 2
        out = {
            "slot_of_key": {key: i for i, (key, _, _) in enumerate(sel)},
            "out_keys_by_slot": [key for key, _, _ in sel],
            "K_cap": k_cap, "F": F,
            "keys_all_int": all(d["keys_all_int"] for d in ffats),
            "key_dtype": proto["key_dtype"],
            "saw_new_key": True,  # force a key-table refresh on 1st batch
            "leaf_frontier": max(d["leaf_frontier"] for d in ffats),
            "fire_ewma": max(d["fire_ewma"] for d in ffats),
            "rebuild_dirty": True,  # level caches are stale by definition
            "ignored": sum(d["ignored"] for d in ffats) if j == 0 else 0,
        }
        for fi, field in enumerate(_FFAT_HOST_ARRAYS):
            out[field] = _gather_rows(host, fi, proto[field], sel, k_cap,
                                      fill=-1 if field == "max_leaf" else 0)
        if src_tree is None or not sel:
            out["trees"] = None
            out["tvalid"] = None
        else:
            out["trees"] = tree_unflatten(treedef, [
                _gather_rows(tleaves, li, pl, sel, k_cap, missing=missing)
                for li, pl in enumerate(proto_planes)])
            # a source without a validity plane leaves its rows invalid
            tv = np.zeros((k_cap, 2 * F), dtype=bool)
            have = [e for e in sel if tvalids[e[1]] is not None]
            if have:
                rows = [i for i, e in enumerate(sel)
                        if tvalids[e[1]] is not None]
                tv[rows] = _gather_rows(tvalids, 0, tv, have, len(have))
            out["tvalid"] = tv
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# collector state
# ---------------------------------------------------------------------------
def split_collector_states(colls: List[Optional[dict]], new_n: int,
                           op_name: str) -> List[Optional[dict]]:
    """Split the RESCALED operator's own collector states. The port's
    collector is the ``WatermarkCollector``: its per-channel watermarks
    (``ch_wm``) keep their channel identity (the upstream producers are
    unchanged), each channel at the lowest of the old replicas' marks —
    late, never wrong. The JAX package's ordering, id-sequencer, K-slack
    and DP-join buffers are not ported; a blob holding one is refused."""
    olds = [c for c in colls if c]
    if not olds:
        return [None] * new_n
    unknown = {k for c in olds for k in c} - {"ch_wm"}
    if unknown:
        raise WindFlowError(
            f"rescale: {op_name!r} checkpointed collector state this "
            f"version cannot repartition: {sorted(unknown)}")
    n_ch = max(len(c["ch_wm"]) for c in olds)
    wm = [min((c["ch_wm"][ch] for c in olds if ch < len(c["ch_wm"])),
              default=0) for ch in range(n_ch)]
    return [{"ch_wm": list(wm)} for _ in range(new_n)]


def remap_neighbor_collector(st: dict, old_inputs: List[Tuple[int, int]],
                             new_inputs: List[Tuple[int, int]],
                             changed_edges: set) -> dict:
    """Re-index a collector's per-channel watermarks when the rescaled
    stage changed the channel layout (its parallelism is part of the
    channel numbering). Matched ``(edge, producer)`` channels keep their
    mark; fresh channels seed with their edge's lowest old mark."""
    out = dict(st)
    if "ch_wm" in st:
        per_edge_min: Dict[int, int] = {}
        for (e, _), v in zip(old_inputs, st["ch_wm"]):
            per_edge_min[e] = min(per_edge_min.get(e, v), v)
        wm = []
        for e, pi in new_inputs:
            try:
                oi = old_inputs.index((e, pi))
                keep = e not in changed_edges
            except ValueError:
                oi, keep = -1, False
            wm.append(st["ch_wm"][oi] if keep and oi < len(st["ch_wm"])
                      else per_edge_min.get(e, 0))
        out["ch_wm"] = wm
    return out


# ---------------------------------------------------------------------------
# emitter state
# ---------------------------------------------------------------------------
def stretch_emitter_state(st: Optional[dict], new_len: int) -> dict:
    """A routing-counter state for an emitter whose destination count
    changed: every per-destination id starts at the GLOBAL max of the old
    counters, so ids stay monotone per channel."""
    st = st or {}
    if "inner" in st:  # splitting emitter: stretch every branch
        return {"inner": [stretch_emitter_state(s, new_len)
                          for s in st["inner"]]}
    mx = max(st.get("next_ids", []) or [0])
    return {"next_ids": [mx] * new_len,
            "emit_count": st.get("emit_count", 0)}


def merge_emitter_states(sts: List[Optional[dict]], new_len: int) -> dict:
    """Per-destination counters for the RESCALED op's new emitters: the
    max over every old replica and destination."""
    mx = 0
    for st in sts:
        if not st:
            continue
        for s in st.get("inner") or []:
            mx = max(mx, max(s.get("next_ids", []) or [0]))
        mx = max(mx, max(st.get("next_ids", []) or [0]))
    return {"next_ids": [mx] * new_len, "emit_count": 0}


# ---------------------------------------------------------------------------
# per-operator state split
# ---------------------------------------------------------------------------
def split_operator_states(op, olds: List[dict], new_n: int) -> List[dict]:
    """Split one operator's N replica state blobs into M. ``olds`` must
    not hold ``__emitter__`` / ``__collector__`` (the caller, which knows
    the wiring, handles them)."""
    refusal = repartition_refusal(op)
    if refusal is not None:
        raise WindFlowError(
            f"rescale: operator {op.name!r} is not repartitionable — "
            f"{refusal}")
    dest = dest_fn_for(op, new_n)
    wm = _merged_wm(olds)
    news: List[dict] = [{"cur_wm": wm} for _ in range(new_n)]
    handled = set(_BENIGN_KEYS)

    if any("key_state" in st for st in olds):  # host Reduce
        for j, d in enumerate(_split_keyed_dict(
                [st.get("key_state", {}) for st in olds], new_n, dest)):
            news[j]["key_state"] = d
        handled.add("key_state")
    if any("scan" in st for st in olds):  # stateful Map/Filter_GPU
        for j, d in enumerate(_split_scan([st.get("scan") for st in olds],
                                          new_n, dest, op.name)):
            news[j]["scan"] = d
        handled.add("scan")
    if any("ffat" in st for st in olds):  # Ffat_Windows_GPU forest
        for j, d in enumerate(_split_ffat_gpu(
                [st.get("ffat", {}) for st in olds], new_n, dest, op.name)):
            news[j]["ffat"] = d
        handled.add("ffat")
    if any("__fused__" in st for st in olds):  # fused device chain
        sig = next(st["__fused__"] for st in olds if "__fused__" in st)
        subs = [st.get("fused_sub_states", []) for st in olds]
        n_sub = max((len(s) for s in subs), default=0)
        split_subs: List[List[Optional[dict]]] = [[] for _ in range(new_n)]
        for si in range(n_sub):
            col = [s[si] if si < len(s) else None for s in subs]
            if all(c is None for c in col):
                for j in range(new_n):
                    split_subs[j].append(None)
            else:
                for j, d in enumerate(_split_scan(col, new_n, dest,
                                                  op.name)):
                    split_subs[j].append(d)
        for j in range(new_n):
            news[j]["__fused__"] = sig
            news[j]["fused_sub_states"] = split_subs[j]
        handled.update(("__fused__", "fused_sub_states"))

    unknown = {k for st in olds for k in st} - handled
    if unknown:
        raise WindFlowError(
            f"rescale: operator {op.name!r} checkpointed state this "
            f"version cannot repartition: {sorted(unknown)} — refusing "
            "loudly rather than dropping it")
    return news
