"""State carried across from the JAX package — the counterpart of weights
for this system.

- ``ffat_state_from_jax(snap, device)`` takes the ``"ffat"`` dict of a JAX
  ``FfatTPUReplica.snapshot_state()`` (numpy arrays plus Python values,
  the forest ``trees`` and ``tvalid`` included) and returns the dict
  ``FfatGPUReplica.load_state`` installs, with the forest as tensors on
  ``device``.
- ``scan_state_from_jax(snap, device)`` takes a JAX keyed-state engine's
  ``snapshot_state()`` (the ``"scan"`` entry of a stateful Map/Filter
  replica's: ``slot_of_key``, ``table_capacity``, the numpy table pytree
  and, when tiered, the tier blob) and returns the dict
  ``_KeyedStateScan.restore_state`` installs, the table as tensors on
  ``device``. ``fused_state_from_jax`` does it per sub-op for a fused
  chain's replica state.
- ``mesh_state_from_jax(entry)`` takes the ``"mesh_ffat"`` /
  ``"mesh_scan"`` / ``"mesh_reduce"`` entry of a JAX mesh replica's
  snapshot (per-shard numpy row blocks, the key directory and the layout
  metadata) and returns the port's: the two packages share the layout, so
  it copies the blocks into owned numpy arrays in the port's dtypes.
  The mesh replica relayouts the blocks onto its own mesh shape when the
  graph starts, so a checkpoint taken at one shape restores at another.
- ``engine_state_from_jax(engine)`` takes the ``"engine"`` entry of a
  JAX window replica's snapshot (``Keyed_Windows``, ``Parallel_Windows``
  and the stages of the composite windows). Its key map holds the JAX
  package's ``_KeyDesc`` / ``_OpenWindow`` objects, plain Python data
  that unpickles only where ``windflow_tpu`` is importable (the tests);
  they become the port's classes, field for field.
  ``collector_state_from_jax(state)`` does the same for a collector
  entry, whose buffers hold the JAX package's ``Single`` / ``Batch``
  messages (their ``WinResult`` payloads included). The host FFAT's and
  the interval join's per-key states and a Kafka source's offsets are
  dicts, lists and tuples already, and pass through.
- ``db_image_from_jax(image)`` takes the ``"db"`` entry of a JAX
  persistent replica's snapshot (``P_Map`` ... ``P_Sink``,
  ``P_Keyed_Windows``: the whole sqlite image) and returns it with every
  pickled row that names a JAX package class (a window's ``_KeyDesc``)
  pickled again as the port's class of the same module path; an image
  without one comes back as it is. The exactly-once sinks' state
  (``txn_last_epoch``) passes through, and the segments a JAX sink staged
  read back in the port's restore (``sinks/transactional.py:port_loads``):
  pending epochs up to the restored one roll forward, later ones abort.
- ``checkpoint_states_from_jax(states, device)`` takes what the JAX
  package's ``CheckpointStore.load_states`` returns for one committed
  checkpoint (``{(op name, replica): state}``) and returns the port's
  replica states, which ``PipeGraph.run(restore_from=states)`` installs in
  a graph of the same topology. An incremental JAX checkpoint (manifests
  with ``refs``/``deps``) is read with the port's own
  ``CheckpointStore(root).load_states``, which materializes its delta
  chains into full states the same way the JAX store does.

Both replicas then continue identically. This module takes the dicts
only: it imports neither ``jax`` nor ``windflow_tpu``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from .basic import WindFlowError
from .gpu.schema import canonical
from .pytree import tree_map

_HOST_ARRAYS = ("next_fire", "fired", "max_leaf", "count", "keys_np")
_SCALARS = ("K_cap", "F", "keys_all_int", "saw_new_key", "leaf_frontier",
            "fire_ewma", "rebuild_dirty", "ignored")


def ffat_state_from_jax(snap: Dict[str, Any], device) -> Dict[str, Any]:
    device = torch.device(device)
    missing = [k for k in _HOST_ARRAYS + _SCALARS
               + ("slot_of_key", "out_keys_by_slot", "key_dtype", "trees",
                  "tvalid") if k not in snap]
    if missing:
        raise WindFlowError(f"ffat_state_from_jax: not a full FFAT snapshot "
                            f"(missing {missing}); materialize a delta "
                            "with CheckpointStore.load_states first")
    out: Dict[str, Any] = {k: snap[k] for k in _SCALARS}
    out["slot_of_key"] = dict(snap["slot_of_key"])
    out["out_keys_by_slot"] = list(snap["out_keys_by_slot"])
    out["key_dtype"] = np.dtype(snap["key_dtype"])
    for k in _HOST_ARRAYS:
        out[k] = np.array(snap[k], dtype=np.int64)
    shape = (int(snap["K_cap"]), 2 * int(snap["F"]))
    if snap["trees"] is None:
        out["trees"] = out["tvalid"] = None
        return out
    trees = {}
    for name, plane in snap["trees"].items():
        arr = np.asarray(plane)
        if arr.shape != shape:
            raise WindFlowError(f"ffat_state_from_jax: plane {name!r} has "
                                f"shape {arr.shape}, expected {shape}")
        trees[name] = canonical(torch.from_numpy(arr.copy())).to(device)
    out["trees"] = trees
    out["tvalid"] = torch.from_numpy(
        np.asarray(snap["tvalid"], dtype=bool).copy()).to(device)
    return out


def scan_state_from_jax(snap: Dict[str, Any], device) -> Dict[str, Any]:
    """A JAX ``_KeyedStateScan.snapshot_state()`` (a FULL one: a delta
    node carries only dirty rows and is refused; the store materializes
    it) for the port's engine. A tier blob passes through unchanged: its hot-table digest is
    over the table's values, which the conversion keeps."""
    device = torch.device(device)
    if "slot_of_key" not in snap or "table_capacity" not in snap:
        raise WindFlowError("scan_state_from_jax: not a full keyed-state "
                            "snapshot (materialize a delta with "
                            "CheckpointStore.load_states first)")
    out: Dict[str, Any] = {"slot_of_key": dict(snap["slot_of_key"]),
                           "table_capacity": int(snap["table_capacity"])}
    table = snap.get("table")
    out["table"] = (None if table is None else tree_map(
        lambda a: canonical(torch.from_numpy(np.array(a))).to(device),
        table))
    if snap.get("tier") is not None:
        out["tier"] = snap["tier"]
    return out


def fused_state_from_jax(snap: Dict[str, Any], device) -> Dict[str, Any]:
    """A JAX ``FusedTPUReplica.snapshot_state()`` for the port's
    ``FusedGPUReplica.restore_state``: the chain signature and the
    watermark as they are, each stateful sub-op's engine state through
    ``scan_state_from_jax``."""
    if "__fused__" not in snap:
        raise WindFlowError("fused_state_from_jax: not a fused chain's "
                            "snapshot")
    out = dict(snap)
    out["fused_sub_states"] = [
        None if sub is None else scan_state_from_jax(sub, device)
        for sub in snap.get("fused_sub_states") or []]
    return out


_MESH_KEYS = ("mesh_ffat", "mesh_scan", "mesh_reduce")


def _np_owned(a):
    """An owned numpy copy of a JAX-written leaf in the port's dtypes
    (int64 / float64 become int32 / float32, as on the device)."""
    arr = np.array(a)
    if arr.dtype == np.int64:
        return arr.astype(np.int32)
    if arr.dtype == np.float64:
        return arr.astype(np.float32)
    return arr


def mesh_state_from_jax(entry: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX mesh replica's ``mesh_ffat`` / ``mesh_scan`` / ``mesh_reduce``
    entry (a FULL one: a delta node is refused) for the port's mesh
    replica. Per-shard blocks are copied leaf by leaf; the key directory,
    ``key_by_slot`` (int64 original keys) and the layout metadata pass
    through; a tier blob passes through unchanged."""
    if "__state_delta__" in entry or "slot_of_key" not in entry:
        raise WindFlowError("mesh_state_from_jax: not a full mesh "
                            "snapshot (materialize a delta with "
                            "CheckpointStore.load_states first)")
    out = dict(entry)
    out["slot_of_key"] = dict(entry["slot_of_key"])
    out["key_by_slot"] = np.array(entry["key_by_slot"], dtype=np.int64)
    if "trees" in entry:  # mesh_ffat: the forest and the control state
        out["trees"] = {f: [np.array(b) for b in bl]
                        for f, bl in entry["trees"].items()}
        out["tvalid"] = [np.array(b, dtype=bool) for b in entry["tvalid"]]
        for k in ("next_fire", "max_leaf", "fired"):
            out[k] = [np.array(b, dtype=np.int32) for b in entry[k]]
        out["val_dtypes"] = dict(entry["val_dtypes"])
    if entry.get("table_shards") is not None:  # mesh_scan
        out["table_shards"] = [tree_map(_np_owned, sh)
                               for sh in entry["table_shards"]]
    return out


def engine_state_from_jax(engine: Dict[str, Any]) -> Dict[str, Any]:
    from .operators.window_engine import _KeyDesc, _OpenWindow
    key_map = {}
    for key, kd in engine.get("key_map", {}).items():
        wins = [_OpenWindow(w.lwid, w.gwid, w.start, w.end,
                            _port_value(w.acc), w.n_tuples)
                for w in kd.wins]
        key_map[key] = _KeyDesc(
            next_input_id=kd.next_input_id, next_lwid=kd.next_lwid,
            last_fired_lwid=kd.last_fired_lwid, next_res_id=kd.next_res_id,
            wins=wins, arch_idx=list(kd.arch_idx),
            arch_payload=[_port_value(p) for p in kd.arch_payload])
    return {"key_map": key_map,
            "ignored_tuples": engine.get("ignored_tuples", 0),
            "cur_wm": engine.get("cur_wm", 0)}


def _port_value(v):
    """A JAX ``WinResult`` (a stage-1 result riding into a stage-2
    window) as the port's; anything else unchanged."""
    if type(v).__name__ == "WinResult":
        from .operators.window_engine import WinResult
        return WinResult(v.key, v.wid, _port_value(v.value), v.ts)
    return v


def _port_msg(m):
    from .message import Batch, Single
    kind = type(m).__name__
    if kind == "Single":
        return Single(_port_value(m.payload), m.id, m.ts, m.wm, m.is_punct,
                      m.stream_tag)
    if kind == "Batch":
        b = Batch([(_port_value(p), ts) for p, ts in m.rows], m.wm,
                  m.is_punct, m.stream_tag)
        b.id = m.id
        return b
    raise WindFlowError(f"collector_state_from_jax: unknown message {kind}")


def collector_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(state)
    if "bufs" in state:  # OrderingCollector
        out["bufs"] = [[_port_msg(m) for m in buf] for buf in state["bufs"]]
    if "pending" in state:  # IDSequencerCollector
        out["pending"] = {k: {i: _port_msg(m) for i, m in pend.items()}
                          for k, pend in state["pending"].items()}
    if "heap" in state:  # KSlackCollector / DPJoinCollector
        out["heap"] = [(*e[:-1], _port_msg(e[-1])) for e in state["heap"]]
    return out


def db_image_from_jax(image: bytes) -> bytes:
    if b"windflow_tpu" not in image:
        return image
    from .persistent.db_handle import DBHandle
    from .sinks.transactional import port_loads

    def fix(blob: bytes) -> bytes:
        if b"windflow_tpu" not in blob:
            return blob
        return pickle.dumps(port_loads(blob))

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "image.db"), "wb") as f:
            f.write(image)
        db = DBHandle("image", db_dir=d)
        try:
            conn = db._conn
            rows = [(fix(k), fix(v))
                    for k, v in conn.execute("SELECT k, v FROM kv")]
            conn.execute("DELETE FROM kv")
            conn.executemany("INSERT INTO kv (k, v) VALUES (?, ?)", rows)
            return db.snapshot_bytes()
        finally:
            db.close()


def checkpoint_states_from_jax(states: Dict[Any, Dict[str, Any]],
                               device) -> Dict[Any, Dict[str, Any]]:
    """The replica states of one JAX checkpoint for the port: a fused
    chain's through ``fused_state_from_jax``, an FFAT window's ``"ffat"``
    through ``ffat_state_from_jax``, a stateful Map/Filter's ``"scan"``
    through ``scan_state_from_jax``, a mesh replica's entry through
    ``mesh_state_from_jax``, a window replica's ``"engine"`` through
    ``engine_state_from_jax`` and a collector entry through
    ``collector_state_from_jax``, a persistent replica's sqlite image
    through ``db_image_from_jax``; source positions and Kafka offsets,
    watermarks, the other host operators' state and the emitter entries
    pass through (the two packages share their layout). A delta node is refused: the store's
    ``load_states`` returns materialized states."""
    out = {}
    for key, state in states.items():
        if "__state_delta__" in state:
            raise WindFlowError(f"checkpoint_states_from_jax: {key} holds "
                                "a delta node; materialize it with "
                                "CheckpointStore.load_states first")
        st = dict(state)
        if "fused_sub_states" in st:
            st = fused_state_from_jax(st, device)
        if st.get("ffat") is not None:
            st["ffat"] = ffat_state_from_jax(st["ffat"], device)
        if st.get("scan") is not None:
            st["scan"] = scan_state_from_jax(st["scan"], device)
        for k in _MESH_KEYS:
            if st.get(k) is not None:
                st[k] = mesh_state_from_jax(st[k])
        if st.get("engine") is not None:
            st["engine"] = engine_state_from_jax(st["engine"])
        if st.get("__collector__") is not None:
            st["__collector__"] = collector_state_from_jax(
                st["__collector__"])
        if isinstance(st.get("db"), bytes):
            st["db"] = db_image_from_jax(st["db"])
        out[key] = st
    return out
