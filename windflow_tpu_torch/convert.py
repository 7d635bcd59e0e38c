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
- ``checkpoint_states_from_jax(states, device)`` takes what the JAX
  package's ``CheckpointStore.load_states`` returns for one committed
  checkpoint (``{(op name, replica): state}``) and returns the port's
  replica states, which ``PipeGraph.run(restore_from=states)`` installs in
  a graph of the same topology.

Both replicas then continue identically. This module takes the dicts
only: it imports neither ``jax`` nor ``windflow_tpu``.
"""

from __future__ import annotations

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
                            f"(missing {missing}); delta snapshots are not "
                            "supported")
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
    snapshot carries only dirty rows and is refused) for the port's
    engine. A tier blob passes through unchanged: its hot-table digest is
    over the table's values, which the conversion keeps."""
    device = torch.device(device)
    if "slot_of_key" not in snap or "table_capacity" not in snap:
        raise WindFlowError("scan_state_from_jax: not a full keyed-state "
                            "snapshot (delta snapshots are not supported)")
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


def checkpoint_states_from_jax(states: Dict[Any, Dict[str, Any]],
                               device) -> Dict[Any, Dict[str, Any]]:
    """The replica states of one JAX checkpoint for the port: a fused
    chain's through ``fused_state_from_jax``, an FFAT window's ``"ffat"``
    through ``ffat_state_from_jax``, a stateful Map/Filter's ``"scan"``
    through ``scan_state_from_jax``; source positions, watermarks, host
    operator state and the emitter and collector entries pass through (the
    two packages share their layout). A delta state is refused."""
    out = {}
    for key, state in states.items():
        if "__state_delta__" in state:
            raise WindFlowError(f"checkpoint_states_from_jax: {key} holds "
                                "a delta state; delta checkpoints are not "
                                "supported")
        st = dict(state)
        if "fused_sub_states" in st:
            st = fused_state_from_jax(st, device)
        if st.get("ffat") is not None:
            st["ffat"] = ffat_state_from_jax(st["ffat"], device)
        if st.get("scan") is not None:
            st["scan"] = scan_state_from_jax(st["scan"], device)
        out[key] = st
    return out
