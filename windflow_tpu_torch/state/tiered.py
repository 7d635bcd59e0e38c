"""TieredKeyStore: hot keys device-resident, cold tail host-spilled.

The port of ``windflow_tpu/state/tiered.py``. A keyed device table is
dense, so its key cardinality is capped by device memory, while keyed
traffic is a small hot set and a long cold tail (Zipf streams). This
module splits the key space in two tiers:

- **hot tier**: the stateful operator's device table, capped at
  ``hot_capacity`` slots. Slots are recycled: the ``KeySlotMap`` maps
  only the keys that are hot now, and a demoted key's slot goes back to a
  free list;
- **cold tier**: a host sqlite store (``ColdStore`` over
  ``persistent.db_handle.DBHandle``) holding one row of state leaves per
  demoted key.

Which keys stay hot is decided by a ``persistent.cache`` tracker
(``policy="lru"|"lfu"``) used for its ``eviction_order()`` only, never
for its own eviction, so it cannot disagree with the slot map.

Movement between tiers is planned per BATCH (``plan_batch`` returns a
``TierPlan``) and applied by the engine as one slot-row gather and one
scatter per table leaf, on the replica's dispatch queue
(``gpu/ops_gpu.py:_KeyedStateScan._submit_tier_plan``), never as per-key
transfers.

The JAX package reads its default policy, cold-store directory and the
shrink floor from ``WF_TIER_*``; the port reads no environment variable:
they are ``TierConfig`` arguments with the same defaults ("lru", a
directory under the system's temp directory, 64).

Incremental checkpoints (``with_checkpointing(delta=True)``): the cold
store keeps a write-ahead log of its puts and deletes since the tier's
last FULL snapshot, so a delta ships that churn (``snapshot_delta``)
instead of the whole sqlite image, and ``apply_tier_delta`` replays it on
the base image at restore. The log starts at the first FULL snapshot
taken under deltas (``wal_reset``), which is where the JAX package's
log, on from the start under ``WF_CKPT_DELTA``, is reset too.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import sqlite3
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..basic import CorruptCheckpointError, KeyCapacityError, WindFlowError
from ..checkpoint.delta import make_tier_delta
from ..persistent.cache import _CACHE_POLICIES, make_cache
from ..persistent.db_handle import DBHandle
from ..pytree import tree_leaves

DEFAULT_TIER_POLICY = "lru"
DEFAULT_MIN_HOT = 64


def _digest(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def _host_leaf(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        leaf = leaf.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(leaf))


def hot_table_digest(table) -> Optional[str]:
    """Canonical digest of a state table pytree: dtype + shape + raw bytes
    per leaf, in tree order (dict keys sorted). Equal to the JAX package's
    digest for the same table values, whether the leaves are numpy arrays
    or torch tensors."""
    if table is None:
        return None
    h = hashlib.sha256()
    for leaf in tree_leaves(table):
        a = _host_leaf(leaf)
        h.update(a.dtype.str.encode())
        h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
        h.update(a.tobytes())
    return "sha256:" + h.hexdigest()


class TierConfig:
    """Builder-side tiering declaration (``with_tiering``), attached to the
    operator and consumed by its replicas' engines. ``min_hot`` is the
    floor a shrunk ``target_hot_capacity`` cannot cross."""

    __slots__ = ("policy", "hot_capacity", "db_dir", "min_hot")

    def __init__(self, policy: Optional[str] = None,
                 hot_capacity: int = 1024, db_dir: Optional[str] = None,
                 min_hot: int = DEFAULT_MIN_HOT) -> None:
        self.policy = (policy or DEFAULT_TIER_POLICY).strip().lower()
        if self.policy not in _CACHE_POLICIES:
            raise WindFlowError(
                f"with_tiering: unknown eviction policy {policy!r} "
                f"(expected one of {sorted(_CACHE_POLICIES)})")
        self.hot_capacity = int(hot_capacity)
        if self.hot_capacity < 1:
            raise WindFlowError("with_tiering: hot_capacity must be >= 1")
        self.db_dir = db_dir
        self.min_hot = max(1, int(min_hot))


class TierPlan:
    """One batch's tier maintenance: keys to promote (cold -> their
    assigned hot slots) and victims to demote (hot slots -> cold)."""

    __slots__ = ("promote_keys", "promote_slots", "demote_keys",
                 "demote_slots")

    def __init__(self, promote_keys: List[Any], promote_slots: np.ndarray,
                 demote_keys: List[Any], demote_slots: np.ndarray) -> None:
        self.promote_keys = promote_keys
        self.promote_slots = promote_slots
        self.demote_keys = demote_keys
        self.demote_slots = demote_slots


class ColdStore:
    """Host-side cold tier: one sqlite row per demoted key, the value a
    tuple of the key's state LEAVES (the flattened state row). Its
    checkpoint is the sqlite online-backup image."""

    def __init__(self, name: str, db_dir: Optional[str] = None,
                 fresh: bool = False) -> None:
        self.db = DBHandle(name, db_dir=db_dir)
        if fresh:
            # a NEW engine claiming this path starts empty: stale rows of
            # a crashed run come back only through restore_bytes
            self.db.clear()
        # cached row count (the gauges read len() every batch); exact
        # because a demoted key is never already cold. None = recount
        self._count: Optional[int] = 0 if fresh else None
        # write-ahead log of the puts and deletes since the last FULL
        # image, collapsed per key (a re-put cancels its delete and the
        # other way round); on once a delta lineage starts (wal_reset)
        self.wal_enabled = False
        self._wal_puts: Dict[Any, Any] = {}
        self._wal_dels: set = set()

    def put_rows(self, keys: List[Any], leaf_cols: List[np.ndarray]) -> None:
        """Batched demote write: ``leaf_cols[l][i]`` is leaf ``l`` of
        ``keys[i]``'s state row; committed per batch."""
        if not keys:
            return
        rows = [(k, tuple(col[i] for col in leaf_cols))
                for i, k in enumerate(keys)]
        self.db.put_many(iter(rows))
        self.db._conn.commit()
        if self.wal_enabled:
            for k, row in rows:
                self._wal_puts[k] = row
                self._wal_dels.discard(k)
        if self._count is not None:
            self._count += len(keys)

    def take_rows(self, keys: List[Any], default_leaves: List[Any],
                  leaf_dtypes: List[Any]) -> Tuple[List[np.ndarray], int]:
        """Batched promote read: per-leaf ``(len(keys),)`` columns, rows of
        keys the cold tier never saw filled from the initial state. Taken
        rows are deleted (the hot tier owns them now). Returns
        ``(leaf_cols, n_cold_hits)``."""
        n = len(keys)
        cols = [np.full((n,), default_leaves[li], dtype=leaf_dtypes[li])
                for li in range(len(default_leaves))]
        taken = []
        for i, k in enumerate(keys):
            row = self.db.get(k)
            if row is None:
                continue
            taken.append(k)
            for li, v in enumerate(row):
                cols[li][i] = v
        if taken:
            self.db.delete_many(taken)
            if self.wal_enabled:
                for k in taken:
                    self._wal_dels.add(k)
                    self._wal_puts.pop(k, None)
            if self._count is not None:
                self._count -= len(taken)
        return cols, len(taken)

    # -- the write-ahead log of incremental checkpoints ----------------------
    def wal_snapshot(self) -> Tuple[List[Tuple[Any, Any]], List[Any]]:
        """(puts, deletes) since the last ``wal_reset``: the cold tier's
        churn against its last FULL image."""
        return list(self._wal_puts.items()), list(self._wal_dels)

    def wal_reset(self) -> None:
        self._wal_puts.clear()
        self._wal_dels.clear()

    def __len__(self) -> int:
        if self._count is None:
            self._count = len(self.db)
        return self._count

    def clear(self) -> None:
        self.db.clear()
        self._count = 0
        self.wal_reset()

    def items(self):
        return self.db.items()

    def snapshot_bytes(self) -> bytes:
        return self.db.snapshot_bytes()

    def restore_bytes(self, data: bytes) -> None:
        self.db.restore_bytes(data)
        self._count = None
        self.wal_reset()  # the restored image is the new FULL baseline

    def close(self) -> None:
        self.db.close()


# -- checkpoint-image helpers -----------------------------------------------
def cold_items_from_image(data: bytes) -> List[Tuple[Any, Any]]:
    """Decode a ``ColdStore`` backup image into ``(key, leaf-tuple)``
    items without touching any live store."""
    fd, tmp = tempfile.mkstemp(suffix=".tierimg")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        conn = sqlite3.connect(tmp)
        try:
            return [(pickle.loads(k), pickle.loads(v))
                    for k, v in conn.execute("SELECT k, v FROM kv")]
        finally:
            conn.close()
    finally:
        os.unlink(tmp)


def cold_image_from_items(items) -> bytes:
    """Inverse of ``cold_items_from_image``: a fresh ColdStore image
    holding ``items``."""
    fd, tmp = tempfile.mkstemp(suffix=".tierimg")
    os.close(fd)
    try:
        conn = sqlite3.connect(tmp)
        try:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
            conn.executemany(
                "INSERT INTO kv (k, v) VALUES (?, ?)",
                [(pickle.dumps(k), pickle.dumps(v)) for k, v in items])
            conn.commit()
        finally:
            conn.close()
        with open(tmp, "rb") as f:
            return f.read()
    finally:
        os.unlink(tmp)


def build_tier_blob(policy: str, hot_capacity: int, free_slots, order,
                    cold_items, hot_digest: Optional[str] = None) -> dict:
    """A tier checkpoint sub-blob from parts, in the layout
    ``TieredKeyStore.restore`` accepts (per-tier digests included)."""
    image = cold_image_from_items(cold_items)
    d = {"policy": policy, "hot_capacity": int(hot_capacity),
         "free_slots": [int(s) for s in free_slots],
         "order": list(order),
         "cold_image": image,
         "digests": {"cold": _digest(image)}}
    if hot_digest is not None:
        d["digests"]["hot"] = hot_digest
    return d


def apply_tier_delta(base_blob: dict, node: dict) -> dict:
    """A FULL tier sub-blob from a base epoch's FULL blob and a WAL delta
    node (``checkpoint.delta.make_tier_delta``): decode the base cold
    image, replay the collapsed puts and deletes, rebuild the image and
    stamp its fresh cold digest (the manifest's whole-blob digest pins the
    delta itself)."""
    items = dict(cold_items_from_image(base_blob.get("cold_image")
                                       or cold_image_from_items([])))
    for k in node.get("wal_dels", []):
        items.pop(k, None)
    for k, row in node.get("wal_puts", []):
        items[k] = row
    image = cold_image_from_items(list(items.items()))
    out = dict(node.get("replace") or {})
    out["cold_image"] = image
    digests = dict(out.get("digests") or {})
    digests["cold"] = _digest(image)
    out["digests"] = digests
    return out


# distinguishes the cold-store files of same-named engines (graphs rebuilt
# in one process would otherwise share one sqlite file)
_store_seq = itertools.count()


class TieredKeyStore:
    """The tier control plane of ONE keyed engine: slot free list, the
    eviction-policy tracker, the cold store and the per-batch planner. The
    engine owns the device table and applies the plans; the store never
    touches device memory."""

    def __init__(self, name: str, config: TierConfig, stats=None) -> None:
        self.name = name
        self.policy = config.policy
        self.hot_capacity = int(config.hot_capacity)
        # shrink lever: plan_batch demotes down to a lowered target lazily
        self.target_hot_capacity = self.hot_capacity
        self.min_hot = config.min_hot
        # pure eviction-order tracker: capacity far above hot_capacity so
        # it NEVER auto-evicts — victims come only from plan_batch
        self.tracker = make_cache(self.policy, 1 << 62)
        self.cold = ColdStore(f"{name}_{next(_store_seq)}",
                              db_dir=config.db_dir, fresh=True)
        self.free_slots: List[int] = list(range(self.hot_capacity - 1,
                                                -1, -1))
        self.stats = stats
        # batching observability: promoted keys >> scatter calls
        self.promote_batches = 0
        self.demote_batches = 0
        self.promoted_keys = 0
        self.demoted_keys = 0
        self.lookups = 0
        self.misses = 0

    # -- per-batch planning ------------------------------------------------
    def plan_batch(self, keymap, batch_keys: List[Any]
                   ) -> Optional[TierPlan]:
        """Plan tier maintenance for one batch's DISTINCT keys: touch the
        policy for hot hits, pick victims for the misses (never a key of
        this batch) and assign recycled slots to the promotions. Mutates
        the keymap (evict/assign) so the vectorized ``slots_of`` that
        follows resolves every key. None in steady state (all keys hot,
        no shrink pending)."""
        sk = keymap.slot_of_key
        tr = self.tracker
        missing: List[Any] = []
        for k in batch_keys:
            if k in sk:
                tr.get(k)
            else:
                missing.append(k)
        self.lookups += len(batch_keys)
        self.misses += len(missing)
        eff_cap = min(self.hot_capacity,
                      max(self.min_hot, int(self.target_hot_capacity)))
        if len(batch_keys) > self.hot_capacity:
            raise KeyCapacityError(
                self.name, self.hot_capacity,
                len(batch_keys) - self.hot_capacity,
                hint="one batch touches more distinct keys than the hot "
                     "tier holds; raise with_tiering(hot_capacity=) above "
                     "the per-batch working set")
        # a shrunk target never blocks a batch the PHYSICAL tier holds
        eff_cap = max(eff_cap, len(batch_keys))
        n_evict = max(0, len(sk) + len(missing) - eff_cap)
        if not missing and not n_evict:
            return None
        demote_keys: List[Any] = []
        if n_evict:
            batch_set = set(batch_keys)
            for k in list(tr.eviction_order()):
                if k in batch_set:
                    continue
                demote_keys.append(k)
                if len(demote_keys) == n_evict:
                    break
            if len(demote_keys) < n_evict:  # pragma: no cover - guarded
                raise KeyCapacityError(self.name, eff_cap,
                                       n_evict - len(demote_keys))
        demote_slots = np.asarray([sk[k] for k in demote_keys],
                                  dtype=np.int64)
        for k in demote_keys:
            tr.pop(k)
            keymap.evict(k)
        self.free_slots.extend(int(s) for s in demote_slots)
        promote_slots = np.asarray(
            [self.free_slots.pop() for _ in missing], dtype=np.int64)
        for k, s in zip(missing, promote_slots):
            keymap.assign(k, int(s))
            tr.put(k, True)
        if not missing and not demote_keys:
            return None
        return TierPlan(missing, promote_slots, demote_keys, demote_slots)

    # -- accounting hooks (the engine calls these around the movement) -----
    def note_demote(self, n_keys: int) -> None:
        self.demote_batches += 1
        self.demoted_keys += n_keys
        if self.stats is not None:
            self.stats.note_tier_demote(n_keys)

    def note_promote(self, n_keys: int, usec: float) -> None:
        self.promote_batches += 1
        self.promoted_keys += n_keys
        if self.stats is not None:
            self.stats.note_tier_promote(n_keys, usec)

    def publish_gauges(self, n_hot: int) -> None:
        if self.stats is not None:
            self.stats.note_tier_gauges(n_hot, len(self.cold),
                                        self.lookups, self.misses)

    def adopt_dense(self, slot_of_key: Dict[Any, int]) -> None:
        """Rebuild the tier bookkeeping from a DENSE saved key map: every
        key becomes hot at its dense slot, the cold tier starts empty,
        recency order = slot order. Refuses when the keys exceed the hot
        tier."""
        n = len(slot_of_key)
        if n > self.hot_capacity:
            raise KeyCapacityError(
                self.name, self.hot_capacity, n - self.hot_capacity,
                hint="dense checkpoint holds more keys than the hot "
                     "tier; raise with_tiering(hot_capacity=) or restore "
                     "into a graph without tiering")
        used = set(int(s) for s in slot_of_key.values())
        self.free_slots = [s for s in range(self.hot_capacity - 1, -1, -1)
                           if s not in used]
        self.tracker = make_cache(self.policy, 1 << 62)
        for k, _s in sorted(slot_of_key.items(), key=lambda kv: kv[1]):
            self.tracker.put(k, True)
        self.cold.clear()
        self.target_hot_capacity = self.hot_capacity

    # -- checkpoint plane --------------------------------------------------
    def snapshot(self, hot_digest: Optional[str] = None) -> dict:
        """The tier's sub-blob: policy and capacity, the slot free list,
        the tracker's eviction order and the cold tier's backup image,
        with a digest per tier."""
        image = self.cold.snapshot_bytes()
        d = {
            "policy": self.policy,
            "hot_capacity": self.hot_capacity,
            "free_slots": list(self.free_slots),
            "order": list(self.tracker.eviction_order()),
            "cold_image": image,
            "digests": {"cold": _digest(image)},
        }
        if hot_digest is not None:
            d["digests"]["hot"] = hot_digest
        return d

    def snapshot_delta(self, base_ckpt: int) -> dict:
        """The tier's incremental sub-blob: the cold tier as its WAL since
        the last FULL image plus the small bookkeeping fields, patching the
        ``base_ckpt`` epoch's FULL sub-blob at restore
        (``apply_tier_delta``). No hot digest: a delta never holds the
        whole hot table, and the manifest's blob digest pins the delta."""
        puts, dels = self.cold.wal_snapshot()
        return make_tier_delta(base_ckpt, puts, dels, {
            "policy": self.policy,
            "hot_capacity": self.hot_capacity,
            "free_slots": list(self.free_slots),
            "order": list(self.tracker.eviction_order()),
        })

    def wal_reset(self) -> None:
        """A FULL snapshot was just taken under deltas: it is the new
        baseline, and the cold store logs its churn from here on."""
        self.cold.wal_enabled = True
        self.cold.wal_reset()

    def restore(self, d: dict, hot_digest: Optional[str] = None) -> None:
        if int(d.get("hot_capacity", self.hot_capacity)) \
                != self.hot_capacity:
            raise WindFlowError(
                f"{self.name}: tiered restore holds hot_capacity="
                f"{d.get('hot_capacity')} but this graph declares "
                f"hot_capacity={self.hot_capacity}; restore with the "
                "checkpointed capacity (slot ids are positions in the "
                "hot table)")
        digests = d.get("digests") or {}
        image = d.get("cold_image")
        if image is not None:
            want = digests.get("cold")
            if want and _digest(image) != want:
                raise CorruptCheckpointError(
                    f"{self.name}: cold-tier image digest mismatch "
                    f"(expected {want})")
            self.cold.restore_bytes(image)
        if hot_digest is not None and digests.get("hot") \
                and hot_digest != digests["hot"]:
            raise CorruptCheckpointError(
                f"{self.name}: hot-tier table digest mismatch "
                f"(expected {digests['hot']}, got {hot_digest})")
        self.free_slots = [int(s) for s in d.get("free_slots", [])]
        # the tracker in saved eviction order (LRU order survives
        # exactly; LFU frequencies reset to 1)
        self.tracker = make_cache(self.policy, 1 << 62)
        for k in d.get("order", []):
            self.tracker.put(k, True)
        self.target_hot_capacity = self.hot_capacity
