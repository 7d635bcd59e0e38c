"""windflow_tpu_torch: the PyTorch/CUDA port of windflow_tpu.

The JAX package ``windflow_tpu`` is the reference this port is held
against; the port imports nothing of it (and never imports ``jax``). It
runs linear graphs of host operators (``Map``, ``Filter``, ``FlatMap``,
``Reduce``, ``Sink``) and device operators (``Map_GPU``, ``Filter_GPU``,
``Reduce_GPU``, and ``Ffat_Windows_GPU`` with its FlatFAT forest rebuilt
by a hand-written CUDA kernel for Hopper, ``kernels/``), joined by
CPU -> device staging, forward / keyed / broadcast device -> device edges
and the device -> host exit to a row or columnar sink. Device operators
joined by ``MultiPipe.chain`` fuse into one replica per slot
(``gpu/fused_ops.py``); ``PipeGraph(fusion=..., megabatch=...)`` sets
fusion (default on) and the megabatch width (default 1, off). A keyed
``Map_GPU`` / ``Filter_GPU`` built ``with_state`` keeps per-key state in a
device table (``gpu/ops_gpu.py``), and ``with_tiering`` puts a host cold
tier behind it (``state/``, ``TierConfig``). ``MultiPipe.split`` /
``select`` / ``merge`` build branching graphs (a device split routes whole
device batches), ``with_key_by`` takes a tuple of fields for a composite
key, and ``PipeGraph.with_checkpointing`` / ``run(restore_from=...)`` take
aligned-barrier checkpoints and restore from them (``checkpoint/``).

``PipeGraph(..., device=None)`` runs on ``cuda`` and raises without a card;
pass ``device="cpu"`` for the plain PyTorch path.
"""

from .basic import (CorruptCheckpointError, ExecutionMode, KeyCapacityError,
                    OpType, RoutingMode, TimePolicy, WinType, WindFlowError)
from .builders import (Columnar_Source_Builder, Filter_Builder,
                       FlatMap_Builder, Map_Builder, Reduce_Builder,
                       Sink_Builder, Source_Builder)
from .combines import fieldwise
from .context import LocalStorage, RuntimeContext
from .gpu.builders_gpu import (Ffat_Windows_GPU_Builder, Filter_GPU_Builder,
                               Map_GPU_Builder, Reduce_GPU_Builder)
from .gpu.ffat_gpu import Ffat_Windows_GPU
from .gpu.ops_gpu import Filter_GPU, Map_GPU, Reduce_GPU
from .state import TierConfig
from .topology.multipipe import MultiPipe
from .topology.pipegraph import PipeGraph

__all__ = [
    "Columnar_Source_Builder", "CorruptCheckpointError", "ExecutionMode",
    "Ffat_Windows_GPU", "Ffat_Windows_GPU_Builder", "Filter_Builder",
    "Filter_GPU", "Filter_GPU_Builder", "FlatMap_Builder",
    "KeyCapacityError", "LocalStorage", "Map_Builder", "Map_GPU",
    "Map_GPU_Builder", "MultiPipe", "OpType", "PipeGraph", "Reduce_Builder",
    "Reduce_GPU", "Reduce_GPU_Builder", "RoutingMode", "RuntimeContext",
    "Sink_Builder", "Source_Builder", "TierConfig", "TimePolicy", "WinType",
    "WindFlowError", "fieldwise",
]
