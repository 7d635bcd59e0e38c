"""Device plane of the port: batches, staging/exit/device edges and the
device operators ``Map_GPU``, ``Filter_GPU`` (stateless, or keyed with
device state), ``Reduce_GPU`` and ``Ffat_Windows_GPU`` (the counterpart of
``windflow_tpu.tpu``)."""

from .batch import BatchGPU, bucket_capacity
from .builders_gpu import (Ffat_Windows_GPU_Builder, Filter_GPU_Builder,
                           Map_GPU_Builder, Reduce_GPU_Builder)
from .ffat_gpu import Ffat_Windows_GPU, FfatGPUReplica
from .ops_gpu import Filter_GPU, Map_GPU, Reduce_GPU
from .schema import TupleSchema
from ..state.tiered import TierConfig

__all__ = ["BatchGPU", "Ffat_Windows_GPU", "Ffat_Windows_GPU_Builder",
           "FfatGPUReplica", "Filter_GPU", "Filter_GPU_Builder", "Map_GPU",
           "Map_GPU_Builder", "Reduce_GPU", "Reduce_GPU_Builder",
           "TierConfig", "TupleSchema", "bucket_capacity"]
