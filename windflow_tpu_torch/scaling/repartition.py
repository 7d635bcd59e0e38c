"""Split and merge checkpointed keyed state N -> M.

The port of ``windflow_tpu/scaling/repartition.py``. A committed
checkpoint already holds every replica's keyed state in one blob per
replica. Rescaling an operator from N to M replicas re-buckets every
key's state by the SAME routing function its KEYBY emitters use, so that
after the restore each new replica owns exactly the keys the emitters
send it. Host dicts (the host ``Reduce``'s ``key_state``, the window
engine's ``key_map``, the host FFAT's per-key trees and the KP join's
archives) re-bucket per key, and so do the messages an ordering, K-slack
or id-sequencing collector holds; the device plane's array states (the grid-scan tables of a stateful
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
or FORWARD-routed windows, DP-mode joins and their collectors, sources
(Kafka ones too), and any state key this module does not know.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..basic import JoinMode, OpType, RoutingMode, WindFlowError
from ..gpu.routing import _dest_of_key, _int_keys_hashable_as_identity
from ..message import Batch
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
    if ".kafka" in type(op).__module__:
        return ("Kafka connectors own partition assignments managed by "
                "the group protocol, not by WindFlow routing")
    if op.input_routing is RoutingMode.BROADCAST:
        return ("BROADCAST-distributed operators assign work by replica "
                "arithmetic (global window ids mod parallelism); their "
                "state is bound to the replica count, not to keys")
    if getattr(op, "join_mode", None) is JoinMode.DP:
        return ("DP-mode interval join stores a round-robin share of "
                "a replica-count-dependent shared sequence")
    # keyed state without KEYBY routing = a global accumulator (the global
    # Reduce_GPU): one stream-wide value has no keyed partition
    if getattr(op, "fusion_role", None) == "terminator" \
            and op.key_extractor is None:
        return ("global (unkeyed) reduce folds one stream-wide "
                "accumulator; there is no keyed partition to split")
    if op.op_type in (OpType.WIN, OpType.WIN_GPU) \
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
def _msg_sort_key(msg) -> Tuple[int, int]:
    if isinstance(msg, Batch):
        ts = msg.rows[0][1] if msg.rows else 0
    else:
        ts = msg.ts
    return (ts, msg.id)


def _filter_msg(msg, keep: Callable[[Any], bool]):
    """The sub-message of ``msg`` whose payloads satisfy ``keep`` (None
    when nothing survives). Batches split by row; id, watermark and tag
    stay, so the (ts, id) merge order is kept."""
    if isinstance(msg, Batch):
        rows = [(p, ts) for p, ts in msg.rows if keep(p)]
        if not rows:
            return None
        if len(rows) == len(msg.rows):
            return msg
        nb = Batch(rows, msg.wm, msg.is_punct, msg.stream_tag)
        nb.id = msg.id
        return nb
    return msg if keep(msg.payload) else None


def split_collector_states(colls: List[Optional[dict]], new_n: int,
                           key_fn: Callable[[Any], Any],
                           dest: Callable[[Any], int],
                           op_name: str) -> List[Optional[dict]]:
    """Split the RESCALED operator's own collector states. The ordering
    and K-slack buffers and the id sequencer hold PRE-BARRIER input the
    replica has not consumed yet (dropping it would lose data): their
    messages re-bucket by key (``key_fn`` of the payload, ``dest`` of the
    key), and per-channel buffers and watermarks keep their channel
    identity (the upstream producers are unchanged; each channel's
    watermark is the lowest of the old replicas', late, never wrong). A
    DP-join collector is refused: DP joins do not repartition."""
    olds = [c for c in colls if c]
    if not olds:
        return [None] * new_n
    if any("heap" in c and "ch_wm" in c and "K" not in c for c in olds):
        raise WindFlowError(
            f"rescale: {op_name!r} sits behind a DP-join collector; "
            "DP interval joins are not repartitionable")
    known = {"ch_wm", "bufs", "next", "pending", "heap", "K", "max_ts",
             "frontier", "seq"}
    unknown = {k for c in olds for k in c} - known
    if unknown:
        raise WindFlowError(
            f"rescale: {op_name!r} checkpointed collector state this "
            f"version cannot repartition: {sorted(unknown)}")
    outs: List[Optional[dict]] = []
    n_ch = max(len(c.get("bufs", c.get("ch_wm", []))) for c in olds)
    for j in range(new_n):
        def keep(p, _j=j):
            return dest(key_fn(p)) == _j
        st: dict = {}
        if any("ch_wm" in c for c in olds):
            st["ch_wm"] = [
                min((c["ch_wm"][ch] for c in olds if "ch_wm" in c
                     and ch < len(c["ch_wm"])), default=0)
                for ch in range(n_ch)]
        if any("bufs" in c for c in olds):  # OrderingCollector
            bufs: List[list] = [[] for _ in range(n_ch)]
            for c in olds:
                for ch, buf in enumerate(c.get("bufs", [])):
                    for m in buf:
                        sub = _filter_msg(m, keep)
                        if sub is not None:
                            bufs[ch].append(sub)
            st["bufs"] = [sorted(b, key=_msg_sort_key) for b in bufs]
        if any("next" in c for c in olds):  # IDSequencerCollector
            st["next"] = {}
            st["pending"] = {}
            for c in olds:
                for k, v in c.get("next", {}).items():
                    if dest(k) == j:
                        st["next"][k] = max(v, st["next"].get(k, 0))
                for k, pend in c.get("pending", {}).items():
                    if dest(k) == j:
                        st["pending"].setdefault(k, {}).update(pend)
        if any("heap" in c and "K" in c for c in olds):  # KSlackCollector
            heap = []
            for c in olds:
                for ts, seq, m in c.get("heap", []):
                    sub = _filter_msg(m, keep)
                    if sub is not None:
                        heap.append((ts, seq, sub))
            st["heap"] = sorted(heap, key=lambda e: e[:2])
            st["K"] = max(c.get("K", 0) for c in olds)
            st["max_ts"] = max(c.get("max_ts", 0) for c in olds)
            st["frontier"] = min(c.get("frontier", -1) for c in olds)
            st["seq"] = max(c.get("seq", 0) for c in olds)
        outs.append(st or None)
    return outs


def remap_neighbor_collector(st: dict, old_inputs: List[Tuple[int, int]],
                             new_inputs: List[Tuple[int, int]],
                             changed_edges: set) -> dict:
    """Re-index a collector's per-channel state when the rescaled stage
    changed the channel layout (its parallelism is part of the channel
    numbering). Matched ``(edge, producer)`` channels keep their data;
    buffered messages of the rescaled edge's vanished channels merge
    (sorted) into that edge's first new channel; fresh channels seed with
    their edge's lowest old watermark."""
    pos_new = {key: i for i, key in enumerate(new_inputs)}
    first_of_edge: Dict[int, int] = {}
    for i, (e, _) in enumerate(new_inputs):
        first_of_edge.setdefault(e, i)
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
    if "bufs" in st:
        bufs: List[list] = [[] for _ in range(len(new_inputs))]
        spill: Dict[int, list] = {}
        for (e, pi), buf in zip(old_inputs, st["bufs"]):
            tgt = pos_new.get((e, pi)) if e not in changed_edges else None
            if tgt is not None:
                bufs[tgt].extend(buf)
            else:
                spill.setdefault(e, []).extend(buf)
        for e, msgs in spill.items():
            tgt = first_of_edge.get(e)
            if tgt is None:
                if msgs:
                    raise WindFlowError(
                        "rescale: buffered collector messages from a "
                        "removed edge have no destination channel")
                continue
            bufs[tgt] = sorted(bufs[tgt] + msgs, key=_msg_sort_key)
        out["bufs"] = bufs
    if "heap" in st and "ch_wm" in st and "K" not in st:  # DP-join heap
        heap = []
        for ts, ch, mid, m in st["heap"]:
            e, pi = old_inputs[ch] if ch < len(old_inputs) else (0, 0)
            tgt = pos_new.get((e, pi))
            if tgt is None or e in changed_edges:
                tgt = first_of_edge.get(e, 0)
            heap.append((ts, tgt, mid, m))
        out["heap"] = sorted(heap, key=lambda e: e[:3])
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
    if any("engine" in st for st in olds):  # WindowEngine (SEQ role)
        engines = [st.get("engine", {}) for st in olds]
        kms = _split_keyed_dict([e.get("key_map", {}) for e in engines],
                                new_n, dest)
        for j in range(new_n):
            news[j]["engine"] = {
                "key_map": kms[j],
                "ignored_tuples": (sum(e.get("ignored_tuples", 0)
                                       for e in engines) if j == 0 else 0),
                "cur_wm": max((e.get("cur_wm", 0) for e in engines),
                              default=0)}
        handled.add("engine")
    if any("keys" in st for st in olds):  # host FFAT / KP interval join
        for j, d in enumerate(_split_keyed_dict(
                [st.get("keys", {}) for st in olds], new_n, dest)):
            news[j]["keys"] = d
        if any("ignored" in st for st in olds):
            news[0]["ignored"] = sum(st.get("ignored", 0) for st in olds)
            for j in range(1, new_n):
                news[j]["ignored"] = 0
            handled.add("ignored")
        handled.add("keys")
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
