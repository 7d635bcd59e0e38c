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
``PipeGraph.rescale`` / ``with_autoscaler`` repartition a running keyed
operator (``scaling/``); ``with_supervision`` restarts a failed graph from
its checkpoints and ``with_error_policy`` contains poison records
(``supervision/``). ``with_mesh`` on the device builders shards a keyed
operator over a ``('key', 'data')`` mesh of shards placed on card groups
(``mesh/``: ``Ffat_Windows_Mesh``, ``Map_Mesh``, ``Filter_Mesh``,
``Reduce_Mesh``; ``ensure_virtual_devices(n)`` makes n virtual devices
visible, ``group_devices=`` places them on groups), and the supervisor rebuilds them on the healthy devices a
``with_device_probe`` reports. The host plane has the window operators
(``Keyed_Windows``, ``Parallel_Windows``, ``Paned_Windows``,
``MapReduce_Windows``, ``Ffat_Windows`` over a host ``FlatFAT``) and the
``Interval_Join``, and ``PipeGraph(execution_mode=...)`` takes the
DETERMINISTIC and PROBABILISTIC modes (ordering and K-slack collectors).
``windflow_tpu_torch.kafka`` has the Kafka source and sink over the
in-process ``memory://`` broker. Exactly-once sinks (``with_exactly_once``
on the sink builders and the graph; ``sinks/``) stage their output per
checkpoint epoch and commit it on the coordinator's finalize;
``ArrayBlockSource`` is the replayable block source they restore from.
``windflow_tpu_torch.persistent`` has the operators whose keyed state
lives in sqlite (``P_Map`` ... ``P_Keyed_Windows``).

The monitoring plane (``monitoring/``: sampled latency tracing, flight
recorder and stall watchdog, ``MonitoringServer`` and the pipeline
doctor, the dataflow diagram), the overload governor behind
``PipeGraph.with_slo`` (``overload/``: ``GovernorPolicy``,
``TokenBucket``, ``ShedLog``), ``with_prewarm`` and the native host
runtime (``native/``: the C++ channel ring and the staging encoders)
complete the JAX package's surface; every name of its top level is here.

``PipeGraph(..., device=None)`` runs on ``cuda`` and raises without a card;
pass ``device="cpu"`` for the plain PyTorch path.
"""

from .basic import (CorruptCheckpointError, ExecutionMode, JoinMode,
                    KeyCapacityError, OpType, RoutingMode, TimePolicy,
                    WinType, WindFlowError)
from .builders import (Columnar_Source_Builder, Ffat_Windows_Builder,
                       Filter_Builder, FlatMap_Builder,
                       Interval_Join_Builder, Keyed_Windows_Builder,
                       Map_Builder, MapReduce_Windows_Builder,
                       Paned_Windows_Builder, Parallel_Windows_Builder,
                       Reduce_Builder, Sink_Builder, Source_Builder)
from .combines import fieldwise
from .context import LocalStorage, RuntimeContext
from .message import Batch, Single
from .gpu.builders_gpu import (Ffat_Windows_GPU_Builder, Filter_GPU_Builder,
                               Map_GPU_Builder, Reduce_GPU_Builder)
from .gpu.ffat_gpu import Ffat_Windows_GPU
from .gpu.ops_gpu import Filter_GPU, Map_GPU, Reduce_GPU
from .mesh import (Ffat_Windows_Mesh, Filter_Mesh, Map_Mesh, Reduce_Mesh,
                   ensure_virtual_devices)
from .operators.basic_ops import (Filter, FlatMap, Map, Reduce, Shipper,
                                  Sink)
from .operators.ffat import Ffat_Windows
from .operators.flatfat import FlatFAT
from .operators.join import Interval_Join
from .operators.window_engine import WinResult
from .operators.source import (ArrayBlockSource, Columnar_Source, Source,
                               SourceShipper, arrow_block_source)
from .operators.windows import (Keyed_Windows, MapReduce_Windows,
                                Paned_Windows, Parallel_Windows)
from .overload import GovernorPolicy, ShedLog, TokenBucket
from .scaling import AutoscalePolicy, RescaleReport
from .sinks.transactional import FencedWriteError
from .state import TierConfig
from .supervision import (DeadLetterQueue, ErrorPolicy, RestartPolicy,
                          StaticDeviceProbe, SupervisionEscalated,
                          TorchDeviceProbe)
from .topology.multipipe import MultiPipe
from .topology.pipegraph import PipeGraph

__version__ = "0.1.0"

__all__ = [
    "ArrayBlockSource", "AutoscalePolicy", "Batch", "Columnar_Source",
    "Columnar_Source_Builder", "CorruptCheckpointError", "DeadLetterQueue",
    "ErrorPolicy", "ExecutionMode", "FencedWriteError", "Ffat_Windows",
    "Ffat_Windows_Builder", "Ffat_Windows_GPU", "Ffat_Windows_GPU_Builder",
    "Ffat_Windows_Mesh", "Filter", "Filter_Builder", "Filter_GPU",
    "Filter_GPU_Builder", "Filter_Mesh", "FlatFAT", "FlatMap",
    "FlatMap_Builder", "GovernorPolicy", "Interval_Join",
    "Interval_Join_Builder", "JoinMode",
    "KeyCapacityError", "Keyed_Windows", "Keyed_Windows_Builder",
    "LocalStorage", "Map", "MapReduce_Windows", "MapReduce_Windows_Builder",
    "Map_Builder", "Map_GPU", "Map_GPU_Builder", "Map_Mesh", "MultiPipe",
    "OpType", "Paned_Windows", "Paned_Windows_Builder", "Parallel_Windows",
    "Parallel_Windows_Builder", "PipeGraph", "Reduce", "Reduce_Builder",
    "Reduce_GPU", "Reduce_GPU_Builder", "Reduce_Mesh", "RescaleReport",
    "RestartPolicy", "RoutingMode", "RuntimeContext", "ShedLog", "Shipper",
    "Single",
    "Sink", "Sink_Builder", "Source", "SourceShipper", "Source_Builder",
    "StaticDeviceProbe", "SupervisionEscalated", "TierConfig", "TimePolicy",
    "TokenBucket", "TorchDeviceProbe", "WinResult", "WinType", "WindFlowError",
    "__version__", "arrow_block_source", "ensure_virtual_devices",
    "fieldwise",
]

# top-level names of the JAX package whose plane is not ported yet
_NOT_PORTED: dict = {}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise WindFlowError(f"{name} ({_NOT_PORTED[name]}) is not yet "
                            "ported to windflow_tpu_torch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
