"""windflow_tpu_torch: the PyTorch/CUDA port of windflow_tpu.

The JAX package ``windflow_tpu`` is the reference this port is held
against; the port imports nothing of it (and never imports ``jax``). This
slice runs the FFAT sliding-window main path: a (columnar) source, the
CPU -> device staging edge, ``Ffat_Windows_GPU`` with its FlatFAT forest
rebuilt by a hand-written CUDA kernel for Hopper (``kernels/``), and the
device -> host exit to a row or columnar sink.

``PipeGraph(..., device=None)`` runs on ``cuda`` and raises without a card;
pass ``device="cpu"`` for the plain PyTorch path.
"""

from .basic import (ExecutionMode, OpType, RoutingMode, TimePolicy,
                    WinType, WindFlowError)
from .builders import Columnar_Source_Builder, Sink_Builder, Source_Builder
from .combines import fieldwise
from .context import LocalStorage, RuntimeContext
from .gpu.builders_gpu import Ffat_Windows_GPU_Builder
from .gpu.ffat_gpu import Ffat_Windows_GPU
from .topology.multipipe import MultiPipe
from .topology.pipegraph import PipeGraph

__all__ = [
    "Columnar_Source_Builder", "ExecutionMode",
    "Ffat_Windows_GPU", "Ffat_Windows_GPU_Builder", "LocalStorage",
    "MultiPipe", "OpType", "PipeGraph", "RoutingMode", "RuntimeContext",
    "Sink_Builder", "Source_Builder", "TimePolicy", "WinType",
    "WindFlowError", "fieldwise",
]
