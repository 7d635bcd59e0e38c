"""Mesh execution plane: the keyed-state plane sharded over a
``('key', 'data')`` mesh of shards (the port of ``windflow_tpu/mesh``).

- ``core``: the mesh (``KeyMesh``, ``make_key_mesh``), the visible and
  excluded devices, the bucket-by-owner + ``all_to_all`` KEYBY shuffle,
  the sharded FlatFAT forest, the flat-owner grid-scan and keyed-reduce
  steps;
- ``ffat_mesh``: ``Ffat_Windows_Mesh``, keyed sliding windows sharded over
  the mesh, with sharded snapshot / restore;
- ``ops_mesh``: ``Map_Mesh`` / ``Filter_Mesh`` / ``Reduce_Mesh``, built by
  ``.with_mesh(...)`` on the device builders.

Every mesh operator runs ONE host replica driving every shard: the
topology edge into it stays single-destination, and the per-key routing
happens inside the step as a collective. Parallelism is the mesh shape,
not the replica count: ``rescale()`` refuses mesh operators; to change
capacity, checkpoint and restore with another ``with_mesh(mesh_shape=
...)`` (the restore relayouts the key axis).

The shards of a mesh sit on groups, each a contiguous block of shards
stacked along a leading shard axis on one device; a collective inside a
group is one tensor op, between groups a copy from card to card issued
by the one host process (``core``'s docstring). Without virtual devices
each CUDA card is a group of one shard. ``ensure_virtual_devices(n)``
makes ``n`` virtual devices visible on the graph's device (one group),
which is how a mesh of ``n`` shards runs on one card or on the CPU;
``ensure_virtual_devices(n, group_devices=[...])`` places them on groups,
one device each, which may be one card repeated or a card each.
"""

from __future__ import annotations

from .core import (DEFAULT_VIRTUAL_DEVICES, MESH_AXES, KeyMesh,
                   default_ring_panes, ensure_virtual_devices,
                   excluded_device_ids, healthy_devices, make_key_mesh,
                   make_mesh_table, make_sharded_state, mesh_shard_count,
                   ring_pane_window_query, set_excluded_devices,
                   sharded_ffat_forest, sharded_grid_scan,
                   sharded_keyby_window_step, sharded_keyed_reduce,
                   virtual_device_count, virtual_device_groups,
                   visible_devices)
from .ffat_mesh import Ffat_Windows_Mesh
from .ops_mesh import Filter_Mesh, Map_Mesh, Reduce_Mesh

__all__ = [
    "ensure_virtual_devices", "DEFAULT_VIRTUAL_DEVICES", "KeyMesh",
    "MESH_AXES", "default_ring_panes", "excluded_device_ids",
    "healthy_devices", "make_key_mesh", "make_mesh_table",
    "make_sharded_state", "mesh_shard_count", "ring_pane_window_query",
    "set_excluded_devices", "sharded_ffat_forest", "sharded_grid_scan",
    "sharded_keyby_window_step", "sharded_keyed_reduce",
    "virtual_device_count", "virtual_device_groups", "visible_devices",
    "Ffat_Windows_Mesh", "Map_Mesh", "Filter_Mesh", "Reduce_Mesh",
]
