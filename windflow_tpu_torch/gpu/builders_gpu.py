"""Device-operator builders (reference ``wf/builders_gpu.hpp``).

The port of ``windflow_tpu/tpu/builders_tpu.py``: ``Map_GPU_Builder``,
``Filter_GPU_Builder``, ``Reduce_GPU_Builder`` and
``Ffat_Windows_GPU_Builder`` (the reference's ``Ffat_WindowsGPU_Builder``,
``builders_gpu.hpp:576``), with ``with_schema`` in place of C++ type
deduction (or inferred from the first tuple at the staging boundary).
``with_state`` makes a Map_GPU or Filter_GPU keyed and stateful and
``with_tiering`` puts a host cold tier behind its device table;
``with_mesh`` shards a keyed operator's state over a ``('key', 'data')``
mesh of shards on card groups (``windflow_tpu_torch/mesh``), with
the JAX package's signatures and refusals.

User functions take a dict of torch columns on the graph's device and
return new tensors: they must not write an input column in place (a
broadcast edge shares one batch's columns between replicas).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..basic import RoutingMode, WinType, WindFlowError
from ..builders import _RoutableBuilder
from ..state.tiered import TierConfig
from .ffat_gpu import Ffat_Windows_GPU
from .ops_gpu import Filter_GPU, Map_GPU, Reduce_GPU
from .schema import TupleSchema


class _GPUBuilder(_RoutableBuilder):
    """``with_schema``, shared by the device builders."""

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._schema: Optional[TupleSchema] = None

    def with_schema(self, schema) -> "_GPUBuilder":
        self._schema = (TupleSchema(schema) if isinstance(schema, dict)
                        else schema)
        return self


class _MeshBuilderMixin:
    """``with_mesh`` for the keyed device operators: shard the operator's
    keyed-state plane over a ``('key', 'data')`` mesh (``mesh/``) instead
    of one replica's table."""

    _mesh_cfg: Optional[dict] = None

    def with_mesh(self, n_devices: Optional[int] = None,
                  mesh_shape: Optional[tuple] = None,
                  local_batch: Optional[int] = None,
                  key_capacity: int = 1024):
        """``build()`` returns the mesh-sharded operator (``Map_Mesh`` /
        ``Filter_Mesh`` / ``Reduce_Mesh``): ONE host replica drives every
        shard, the KEYBY shuffle runs as a bucket-by-owner +
        ``all_to_all`` inside the step, and per-key state is
        block-sharded over the shards. ``mesh_shape=(ka, da)`` forces the
        factorization (results are invariant under reshape); the default
        uses every visible device (``mesh.ensure_virtual_devices(n)``
        places n shards on the graph's card, or on card groups with
        ``group_devices=``). ARBITRARY int64 keys
        densify to ``key_capacity`` slots (more distinct keys raise).
        Mesh operators refuse ``rescale()``: to change capacity,
        checkpoint and restore with another ``mesh_shape``."""
        self._mesh_cfg = {"n_devices": n_devices, "mesh_shape": mesh_shape,
                          "local_batch": local_batch,
                          "key_capacity": key_capacity}
        return self

    def _mesh_guard(self, what: str) -> None:
        if self._parallelism != 1:
            raise WindFlowError(
                f"{what}: with_mesh and with_parallelism are exclusive — "
                "the mesh IS the parallelism (one host replica drives "
                "every shard)")
        if self._output_batch_size:
            raise WindFlowError(
                f"{what}: with_output_batch_size does not apply to the "
                "mesh plane (batches pad to the mesh's global batch)")
        if self._key_extractor is None:
            raise WindFlowError(f"{what}: with_mesh requires with_key_by "
                                "(the mesh shards the KEYED plane)")

    def _mesh_name(self, mesh_default: str) -> str:
        return (self._name if self._name != self._default_name
                else mesh_default)


class _KeyedStateBuilder(_GPUBuilder, _MeshBuilderMixin):
    """``with_state`` and ``with_tiering`` of the Map/Filter builders, with
    the JAX package's build-time refusals."""

    def __init__(self, func: Callable) -> None:
        super().__init__(func)
        self._state_init: Any = None
        self._tiering: Optional[TierConfig] = None

    def with_state(self, initial_state: Any):
        """Per-key device state (needs ``with_key_by``): the function
        becomes ``func(row, state) -> (row | keep, state)`` over 0-d
        tensors, under ``torch.func.vmap``, scanned in arrival order.
        ``initial_state`` is a scalar or a dict of scalars; int64 / float64
        become int32 / float32, as in the JAX package."""
        self._state_init = initial_state
        return self

    def with_tiering(self, policy: Optional[str] = None,
                     hot_capacity: int = 1024,
                     db_dir: Optional[str] = None):
        """Hot/cold key tiers: the device table holds ``hot_capacity``
        keys, the rest live in a host sqlite store (``policy`` "lru" or
        "lfu" picks which stay hot). ``hot_capacity`` must exceed every
        batch's distinct keys (``KeyCapacityError`` otherwise)."""
        self._tiering = TierConfig(policy=policy, hot_capacity=hot_capacity,
                                   db_dir=db_dir)
        return self

    def _state_args(self) -> dict:
        what = type(self).__name__
        if self._state_init is not None and self._key_extractor is None:
            raise WindFlowError(f"{what}: with_state requires with_key_by")
        if self._tiering is not None and self._state_init is None:
            raise WindFlowError(f"{what}: with_tiering requires with_state "
                                "(tiers hold the keyed device state)")
        return dict(state_init=self._state_init, tiering=self._tiering)


class Map_GPU_Builder(_KeyedStateBuilder):
    """``Map_GPU_Builder(func)``: ``func(fields) -> fields`` over a dict of
    torch columns, returning new tensors (never writing its input); with
    ``with_state``, ``func(row, state) -> (row, state)``."""

    _default_name = "map_gpu"

    def build(self) -> Map_GPU:
        if self._mesh_cfg is not None:
            from ..mesh.ops_mesh import Map_Mesh
            self._state_args()
            self._mesh_guard("Map_GPU_Builder")
            return self._finish(Map_Mesh(
                self._func, self._state_init, self._key_extractor,
                self._mesh_name("map_mesh"), schema=self._schema,
                tiering=self._tiering, **self._mesh_cfg))
        return self._finish(Map_GPU(self._func, self._name, self._parallelism,
                                    self._routing, self._key_extractor,
                                    self._output_batch_size, self._schema,
                                    **self._state_args()))


class Filter_GPU_Builder(_KeyedStateBuilder):
    """``Filter_GPU_Builder(pred)``: ``pred(fields)`` gives a bool (or int
    0/1) column; it must not write its input. With ``with_state``,
    ``pred(row, state) -> (keep, state)``."""

    _default_name = "filter_gpu"

    def build(self) -> Filter_GPU:
        if self._mesh_cfg is not None:
            from ..mesh.ops_mesh import Filter_Mesh
            self._state_args()
            self._mesh_guard("Filter_GPU_Builder")
            return self._finish(Filter_Mesh(
                self._func, self._state_init, self._key_extractor,
                self._mesh_name("filter_mesh"), schema=self._schema,
                tiering=self._tiering, **self._mesh_cfg))
        return self._finish(Filter_GPU(self._func, self._name,
                                       self._parallelism, self._routing,
                                       self._key_extractor,
                                       self._output_batch_size, self._schema,
                                       **self._state_args()))


class Reduce_GPU_Builder(_GPUBuilder, _MeshBuilderMixin):
    """``Reduce_GPU_Builder(combine)``: ``combine(a, b) -> fields`` over two
    dicts of torch columns, associative and commutative, returning new
    tensors; a field it does not return passes through from ``b``.
    ``with_key_by`` gives one output per key per batch; without it each
    batch folds to one tuple."""

    _default_name = "reduce_gpu"

    def build(self) -> Reduce_GPU:
        if self._routing is RoutingMode.BROADCAST:
            # the op derives its routing from the key extractor (keyed
            # shuffle or forward); the reference reduce has no broadcast
            raise WindFlowError("Reduce_GPU_Builder: withBroadcast is not "
                                "supported (use withKeyBy or forward)")
        if self._mesh_cfg is not None:
            from ..mesh.ops_mesh import Reduce_Mesh
            self._mesh_guard("Reduce_GPU_Builder")
            return self._finish(Reduce_Mesh(
                self._func, self._key_extractor,
                self._mesh_name("reduce_mesh"), schema=self._schema,
                **self._mesh_cfg))
        return self._finish(Reduce_GPU(self._func, self._key_extractor,
                                       self._name, self._parallelism,
                                       self._output_batch_size, self._schema))


class Ffat_Windows_GPU_Builder(_GPUBuilder):
    """``Ffat_Windows_GPU_Builder(lift, combine)``: ``lift`` maps a dict of
    batch columns (torch tensors) to a dict of lifted columns; ``combine``
    is any torch combine of two such dicts (``a`` the earlier side), as in
    the JAX package. On a card the forest rebuild (K1) runs it compiled:
    ``combines.fieldwise(...)`` in the fieldwise library, any other
    combine traced (``kernels/combine_trace.py`` lists what it takes;
    the run fails before its first commit on what it refuses)."""

    _default_name = "ffat_windows_gpu"

    def __init__(self, lift: Callable, combine: Callable) -> None:
        super().__init__(lift)
        self._combine = combine
        self._win_len = 0
        self._slide_len = 0
        self._win_type = None
        self._lateness = 0
        self._nwpb = None  # default: auto-sized from key capacity
        self._key_capacity = 16
        self._mesh_cfg: Optional[dict] = None

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

    def with_mesh(self, n_devices: Optional[int] = None,
                  mesh_shape: Optional[tuple] = None,
                  local_batch: Optional[int] = None,
                  fire_rounds: int = 4, ring_panes: int = 0,
                  late_policy: str = "keep_open"):
        """Shard the FlatFAT forest over a ('key', 'data') mesh:
        ``build()`` returns ``Ffat_Windows_Mesh`` (keyby as an
        ``all_to_all`` inside the step, on-device fire control, K1
        rebuilding every shard's rows in one launch) instead of the
        single-card plane. ``mesh_shape=(ka, da)`` forces the
        factorization; the default uses every visible device. TB windows
        only; ARBITRARY int64 keys, densified to ``with_key_capacity``
        slots (more distinct keys raise). ``late_policy``: "keep_open"
        (default) drops a tuple only when every window containing it
        already fired; "ref_fired" reproduces the reference's
        fired-window bound. Windows are origin-anchored (PARITY.md
        §2.3), unlike the single-card plane's."""
        self._mesh_cfg = {"n_devices": n_devices, "mesh_shape": mesh_shape,
                          "local_batch": local_batch,
                          "fire_rounds": fire_rounds,
                          "ring_panes": ring_panes,
                          "late_policy": late_policy}
        return self

    def build(self) -> Ffat_Windows_GPU:
        if self._win_type is None:
            raise WindFlowError("Ffat_Windows_GPU_Builder: call "
                                "with_cb_windows() or with_tb_windows()")
        if self._key_extractor is None:
            raise WindFlowError("Ffat_Windows_GPU_Builder: withKeyBy "
                                "is mandatory")
        if self._mesh_cfg is not None:
            from ..mesh.ffat_mesh import Ffat_Windows_Mesh
            if self._parallelism != 1:
                raise WindFlowError(
                    "Ffat_Windows_GPU_Builder: with_mesh and "
                    "with_parallelism are exclusive — the mesh IS the "
                    "parallelism (one host replica drives every shard)")
            if self._nwpb is not None:
                raise WindFlowError(
                    "Ffat_Windows_GPU_Builder: with_num_win_per_batch does "
                    "not apply to the mesh plane; the per-step fire budget "
                    "is with_mesh(fire_rounds=...)")
            if self._output_batch_size:
                raise WindFlowError(
                    "Ffat_Windows_GPU_Builder: with_output_batch_size does "
                    "not apply to the mesh plane (windows emit as rows "
                    "through the exit edge)")
            return self._finish(Ffat_Windows_Mesh(
                self._func, self._combine, self._key_extractor,
                self._win_len, self._slide_len, self._win_type,
                self._lateness, self._name,
                key_capacity=self._key_capacity,
                schema=self._schema, **self._mesh_cfg))
        return self._finish(Ffat_Windows_GPU(
            self._func, self._combine, self._key_extractor, self._win_len,
            self._slide_len, self._win_type, self._lateness, self._nwpb,
            self._name, self._parallelism, self._output_batch_size,
            self._schema, self._key_capacity))
