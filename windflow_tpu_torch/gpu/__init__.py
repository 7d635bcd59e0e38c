"""Device plane of the port: batches, staging/exit edges and the
``Ffat_Windows_GPU`` operator (the counterpart of ``windflow_tpu.tpu``)."""

from .batch import BatchGPU, bucket_capacity
from .builders_gpu import Ffat_Windows_GPU_Builder
from .ffat_gpu import Ffat_Windows_GPU, FfatGPUReplica
from .schema import TupleSchema

__all__ = ["BatchGPU", "Ffat_Windows_GPU", "Ffat_Windows_GPU_Builder",
           "FfatGPUReplica", "TupleSchema", "bucket_capacity"]
