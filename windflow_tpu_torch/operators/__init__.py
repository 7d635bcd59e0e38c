"""Part of the windflow_tpu_torch port (see the package docstring)."""
