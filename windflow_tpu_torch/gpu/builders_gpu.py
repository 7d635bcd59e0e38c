"""Device-operator builders (reference ``wf/builders_gpu.hpp``).

``Ffat_Windows_GPU_Builder`` is the port of
``windflow_tpu/tpu/builders_tpu.py:Ffat_Windows_TPU_Builder`` (the
reference's ``Ffat_WindowsGPU_Builder``, ``builders_gpu.hpp:576``). The
mesh plane is not part of the port yet.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..basic import WinType, WindFlowError
from ..builders import _RoutableBuilder
from .ffat_gpu import Ffat_Windows_GPU
from .schema import TupleSchema


class Ffat_Windows_GPU_Builder(_RoutableBuilder):
    """``Ffat_Windows_GPU_Builder(lift, combine)``: ``lift`` maps a dict of
    batch columns (torch tensors) to a dict of lifted columns; ``combine``
    is ``combines.fieldwise(...)`` (any torch callable on ``cpu``)."""

    _default_name = "ffat_windows_gpu"

    def __init__(self, lift: Callable, combine: Callable) -> None:
        super().__init__(lift)
        self._combine = combine
        self._schema: Optional[TupleSchema] = None
        self._win_len = 0
        self._slide_len = 0
        self._win_type = None
        self._lateness = 0
        self._nwpb = None  # default: auto-sized from key capacity
        self._key_capacity = 16

    def with_schema(self, schema) -> "Ffat_Windows_GPU_Builder":
        self._schema = (TupleSchema(schema) if isinstance(schema, dict)
                        else schema)
        return self

    def with_key_capacity(self, n: int) -> "Ffat_Windows_GPU_Builder":
        """Expected distinct-key count per replica (pre-sizes the forest)."""
        self._key_capacity = n
        return self

    def with_cb_windows(self, win_len: int, slide_len: int):
        self._win_type = WinType.CB
        self._win_len, self._slide_len = win_len, slide_len
        return self

    def with_tb_windows(self, win_usec: int, slide_usec: int):
        self._win_type = WinType.TB
        self._win_len, self._slide_len = win_usec, slide_usec
        return self

    def with_lateness(self, lateness_usec: int):
        self._lateness = lateness_usec
        return self

    def with_num_win_per_batch(self, n: int):
        self._nwpb = n
        return self

    def with_mesh(self, *args, **kwargs):
        raise WindFlowError("with_mesh: the mesh plane is not yet ported to "
                            "windflow_tpu_torch")

    def build(self) -> Ffat_Windows_GPU:
        if self._win_type is None:
            raise WindFlowError("Ffat_Windows_GPU_Builder: call "
                                "with_cb_windows() or with_tb_windows()")
        if self._key_extractor is None:
            raise WindFlowError("Ffat_Windows_GPU_Builder: withKeyBy "
                                "is mandatory")
        return self._finish(Ffat_Windows_GPU(
            self._func, self._combine, self._key_extractor, self._win_len,
            self._slide_len, self._win_type, self._lateness, self._nwpb,
            self._name, self._parallelism, self._output_batch_size,
            self._schema, self._key_capacity))
