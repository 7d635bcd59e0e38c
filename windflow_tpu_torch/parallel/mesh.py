"""Compatibility shim: the mesh collective core lives in
``windflow_tpu_torch.mesh.core`` (the port's copy of the JAX package's
``parallel/mesh.py`` shim over ``mesh.core``). Import from there.

The JAX shim also lists ``pvary_fn`` and ``wf_shard_map``, wrappers of
``jax.shard_map``; the port's mesh runs its shards stacked on card groups
with no ``shard_map``, so they have no counterpart."""

from ..mesh.core import (MESH_AXES, _route_flat, _route_to_owners,
                         default_ring_panes, make_key_mesh, make_mesh_table,
                         make_sharded_state, mesh_shard_count,
                         ring_pane_window_query, sharded_ffat_forest,
                         sharded_grid_scan, sharded_keyby_window_step,
                         sharded_keyed_reduce)

__all__ = [
    "MESH_AXES", "default_ring_panes", "make_key_mesh", "make_mesh_table",
    "make_sharded_state", "mesh_shard_count", "ring_pane_window_query",
    "sharded_ffat_forest", "sharded_grid_scan", "sharded_keyby_window_step",
    "sharded_keyed_reduce",
]
