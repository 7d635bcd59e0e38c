from .mesh import (make_key_mesh, make_sharded_state, ring_pane_window_query,
                   sharded_ffat_forest, sharded_keyby_window_step)

__all__ = ["make_key_mesh", "sharded_keyby_window_step",
           "make_sharded_state", "ring_pane_window_query",
           "sharded_ffat_forest"]
