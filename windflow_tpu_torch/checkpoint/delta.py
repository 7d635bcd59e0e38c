"""Incremental-checkpoint plane: delta nodes, the snapshot context, apply.

The port of ``windflow_tpu/checkpoint/delta.py``. Three pieces make a
checkpoint's cost follow the change rate instead of the state size; all
three are off unless ``PipeGraph.with_checkpointing(delta=True)``:

1. **Content-addressed blob refs** (``store.py``): a blob whose payload
   digest equals the previous committed epoch's is *referenced* in the
   manifest (``refs``), never rewritten.
2. **State deltas** (this module): an engine that tracks its touched slot
   rows emits a *delta node* instead of its full state: the dirty rows,
   small replaced fields and fields carried from the base, plus the epoch
   id of the FULL snapshot they patch (``base``). The store records the
   dependency (``deps``) and ``load_states`` materializes the full state,
   so ``restore_from=`` never sees a delta.
3. **Snapshot context**: ``Worker.checkpoint_now`` wraps the capture in
   ``capturing(ckpt_id, store, delta, full_every)``; engines consult
   ``snapshot_ctx()`` / ``delta_eligible`` to choose FULL or delta. No
   context (a retiring worker's final snapshot, a direct
   ``snapshot_state()`` call) always means FULL.

An engine's delta base is always its LAST FULL snapshot, never a delta,
so a chain is one hop deep and ``full_every`` (default 8) bounds how long
a base must be kept. A base epoch that never committed fails
``delta_eligible`` at the next capture and the engine snapshots FULL
again.

The JAX package reads its switches from ``WF_CKPT_DELTA``,
``WF_CKPT_ASYNC`` and ``WF_CKPT_FULL_EVERY``; the port reads no
environment variable: the graph's arguments ride in the context.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set

import numpy as np

from ..pytree import tree_flatten, tree_unflatten

DELTA_KEY = "__state_delta__"
DEFAULT_FULL_EVERY = 8


# -- snapshot context --------------------------------------------------------
class SnapshotContext:
    """What the engines need to know about the capture in progress: the
    epoch being snapshotted, whether deltas are on and the FULL cadence,
    and whether a candidate base epoch is committed on disk (one directory
    listing per capture, cached)."""

    __slots__ = ("ckpt_id", "store", "delta", "full_every", "_committed")

    def __init__(self, ckpt_id: int, store, delta: bool = False,
                 full_every: int = DEFAULT_FULL_EVERY) -> None:
        self.ckpt_id = int(ckpt_id)
        self.store = store
        self.delta = bool(delta)
        self.full_every = max(1, int(full_every))
        self._committed: Optional[Set[int]] = None

    def is_committed(self, cid: int) -> bool:
        if self._committed is None:
            self._committed = set(self.store.completed_ids())
        return cid in self._committed


_tls = threading.local()


@contextmanager
def capturing(ckpt_id: Optional[int], store, delta: bool = False,
              full_every: int = DEFAULT_FULL_EVERY) -> Any:
    """Install the snapshot context for one worker's capture (nests, and
    installs none without an epoch or a store)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (SnapshotContext(ckpt_id, store, delta, full_every)
                if ckpt_id is not None and store is not None else None)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def snapshot_ctx() -> Optional[SnapshotContext]:
    return getattr(_tls, "ctx", None)


def delta_eligible(base_ckpt: Optional[int], snaps_since_full: int,
                   ctx: Optional[SnapshotContext] = None) -> bool:
    """May the current capture emit a delta against ``base_ckpt``? It
    needs a capture context with deltas on, a known base, the FULL cadence
    not yet due, and the base COMMITTED on disk (an uncommitted base never
    became restorable: snapshot FULL again)."""
    if ctx is None:
        ctx = snapshot_ctx()
    if ctx is None or base_ckpt is None or not ctx.delta:
        return False
    if snaps_since_full + 1 >= ctx.full_every:
        return False
    return ctx.is_committed(int(base_ckpt))


def starts_lineage(ctx: Optional[SnapshotContext]) -> bool:
    """Whether a FULL capture under ``ctx`` becomes its engine's new delta
    base (deltas on, under a checkpoint's capture)."""
    return ctx is not None and ctx.delta


# -- delta nodes -------------------------------------------------------------
def make_delta(base_ckpt: int, rows: Optional[Dict[str, Any]] = None,
               shards: Optional[Dict[str, Any]] = None,
               replace: Optional[Dict[str, Any]] = None,
               carry: Optional[List[str]] = None) -> dict:
    """A delta node patching the same-path subtree of the base epoch's
    blob:

    - ``rows``: ``{state_key: {"slots": int_array, "leaves": [rows]}}``,
      slot-row patches along each leaf's leading axis, the leaves in the
      flatten order of the base value (``pytree.py``: dict keys sorted);
    - ``shards``: ``{state_key: [per-shard rows patch or None]}``, for a
      base value that is a LIST of shard pytrees;
    - ``replace``: small fields stored whole (may hold nested delta nodes,
      e.g. a tier WAL delta);
    - ``carry``: field names copied verbatim from the base subtree, zero
      bytes in the delta (the key directory when no key registered since
      the base)."""
    node: Dict[str, Any] = {DELTA_KEY: 1, "base": int(base_ckpt)}
    if rows:
        node["rows"] = rows
    if shards:
        node["shards"] = shards
    if replace:
        node["replace"] = replace
    if carry:
        node["carry"] = list(carry)
    return node


def make_tier_delta(base_ckpt: int, wal_puts: List, wal_dels: List,
                    replace: Dict[str, Any]) -> dict:
    """A tiered store's sub-blob delta: the cold tier as a WAL (puts and
    deletes since the base's full cold image) plus the replaced
    bookkeeping fields (``state.tiered.apply_tier_delta``)."""
    return {DELTA_KEY: 1, "base": int(base_ckpt), "kind": "tier",
            "wal_puts": list(wal_puts), "wal_dels": list(wal_dels),
            "replace": dict(replace)}


def is_delta(node: Any) -> bool:
    return isinstance(node, dict) and DELTA_KEY in node


def delta_bases(state: Any, _out: Optional[Set[int]] = None) -> Set[int]:
    """Every base epoch id a delta node of ``state`` names (a structure
    walk: array leaves are not entered)."""
    out: Set[int] = set() if _out is None else _out
    if isinstance(state, dict):
        if DELTA_KEY in state:
            out.add(int(state["base"]))
        for v in state.values():
            delta_bases(v, out)
    elif isinstance(state, (list, tuple)):
        for v in state:
            delta_bases(v, out)
    return out


# -- application -------------------------------------------------------------
def _apply_rows(base_val: Any, patch: Dict[str, Any]) -> Any:
    """Patch the dirty slot rows into a copy of ``base_val`` (any pytree of
    arrays sharing a leading slot axis)."""
    slots = np.asarray(patch["slots"])
    leaves, spec = tree_flatten(base_val)
    rows = patch["leaves"]
    if len(rows) != len(leaves):
        raise ValueError(
            f"state-delta row patch holds {len(rows)} leaves, base value "
            f"has {len(leaves)} — base/delta structure mismatch")
    out = []
    for b, r in zip(leaves, rows):
        arr = np.array(np.asarray(b), copy=True)
        if len(slots):
            arr[slots] = r
        out.append(arr)
    return tree_unflatten(spec, out)


def _descend(bases: Dict[int, Any], key: Any) -> Dict[int, Any]:
    out = {}
    for cid, bs in bases.items():
        if isinstance(bs, dict):
            out[cid] = bs.get(key)
        elif isinstance(bs, (list, tuple)) and isinstance(key, int) \
                and 0 <= key < len(bs):
            out[cid] = bs[key]
        else:
            out[cid] = None
    return out


def _apply_node(node: dict, bases: Dict[int, Any]) -> Any:
    base = bases.get(int(node["base"]))
    if node.get("kind") == "tier":
        from ..state.tiered import apply_tier_delta
        if base is None:
            raise ValueError(
                "tier WAL delta has no base tier sub-blob to patch")
        return apply_tier_delta(base, node)
    if base is None:
        raise ValueError(
            "state delta has no corresponding base subtree to patch "
            f"(base epoch {node['base']})")
    out: Dict[str, Any] = {}
    for k in node.get("carry") or ():
        out[k] = base[k]
    for k, v in (node.get("replace") or {}).items():
        out[k] = resolve(v, _descend({int(node["base"]): base}, k))
    for k, patch in (node.get("rows") or {}).items():
        out[k] = _apply_rows(base[k], patch)
    for k, shard_patches in (node.get("shards") or {}).items():
        base_shards = base[k]
        out[k] = [base_shards[i] if p is None
                  else _apply_rows(base_shards[i], p)
                  for i, p in enumerate(shard_patches)]
    return out


def resolve(state: Any, bases: Dict[int, Any]) -> Any:
    """Materialize a (possibly delta-bearing) state tree against the base
    states: delta nodes apply against the same-path subtree of their base
    epoch's blob, containers recurse, array leaves pass through."""
    if isinstance(state, dict):
        if DELTA_KEY in state:
            return _apply_node(state, bases)
        return {k: resolve(v, _descend(bases, k))
                for k, v in state.items()}
    if isinstance(state, list):
        return [resolve(v, _descend(bases, i))
                for i, v in enumerate(state)]
    return state


def materialize(state: Any, base_states: Dict[int, Any]) -> Any:
    """The store's entry point: the FULL state of one blob from its
    delta-bearing form and the (already materialized) states of every base
    epoch it names, keyed by epoch id."""
    if not delta_bases(state):
        return state
    return resolve(state, dict(base_states))
