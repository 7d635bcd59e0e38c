"""PipeGraph: the streaming environment — build, wire, run, wait.

Trimmed copy of ``windflow_tpu/topology/pipegraph.py`` (parity with
``wf/pipegraph.hpp``: ``add_source``, ``run`` = ``start`` + ``wait_end``,
per-operator stats), for linear graphs of host and device operators. A
chained device stage runs as one fused replica per slot
(``gpu/fused_ops.py``): ``fusion`` (default on, the JAX package's
``WF_TPU_FUSION``) lets ``MultiPipe.chain`` fuse device operators, and
``megabatch`` (default 1 = off, its ``WF_MEGABATCH``) is the width of
the megabatch groups of every device replica's dispatch queue.

The graph carries the torch ``device`` its device operators run on:
``device=None`` means ``cuda``, and a graph refuses to exist when no CUDA
card is present unless the caller asked for ``device="cpu"`` — it never
falls back silently. ``start()`` initialises CUDA on the main thread.
Checkpointing, supervision, rescaling, overload protection, prewarm and
the mesh plane are not ported yet and raise.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from ..basic import (DEFAULT_BUFFER_CAPACITY, ExecutionMode, OpType,
                     RoutingMode, TimePolicy, WindFlowError,
                     WorkerFailuresError)
from ..operators.base import BasicOperator
from ..runtime.channel import Channel, InlinePort, QueuePort
from ..runtime.collectors import AtomicCounter, WatermarkCollector
from ..runtime.emitters import (BasicEmitter, BroadcastEmitter,
                                ForwardEmitter, KeyByEmitter, NullEmitter)
from ..runtime.worker import Worker
from .multipipe import MultiPipe
from .stage import Stage


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise WindFlowError(f"PipeGraph: unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise WindFlowError(
            "PipeGraph: no CUDA device is available; pass device='cpu' to "
            "run the port's plain PyTorch path on the CPU")
    return dev


class PipeGraph:
    def __init__(self, name: str = "pipegraph",
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT,
                 time_policy: TimePolicy = TimePolicy.INGRESS_TIME,
                 channel_capacity: int = DEFAULT_BUFFER_CAPACITY,
                 device=None, fusion: bool = True,
                 megabatch: int = 1) -> None:
        if execution_mode is not ExecutionMode.DEFAULT:
            raise WindFlowError(f"{execution_mode.name} execution mode is "
                                "not yet ported to windflow_tpu_torch")
        self.name = name
        self.execution_mode = execution_mode
        self.time_policy = time_policy
        self.channel_capacity = channel_capacity
        self.device = resolve_device(device)
        self.fusion = fusion
        self.megabatch = max(1, megabatch)  # 0 and 1 both mean off
        self._stages: List[Stage] = []
        self._ops: List[BasicOperator] = []
        self._workers: List[Worker] = []
        self.dropped = AtomicCounter()
        self._built = False
        self._started = False
        self._ended = False
        self.elapsed_sec = 0.0

    # -- surfaces of the JAX package that are not ported yet ---------------
    def _not_ported(self, what: str):
        raise WindFlowError(f"{what} is not yet ported to windflow_tpu_torch")

    def with_checkpointing(self, *args, **kwargs):
        self._not_ported("with_checkpointing")

    def with_supervision(self, *args, **kwargs):
        self._not_ported("with_supervision")

    def with_autoscaler(self, *args, **kwargs):
        self._not_ported("with_autoscaler")

    def with_slo(self, *args, **kwargs):
        self._not_ported("with_slo")

    def with_prewarm(self, *args, **kwargs):
        self._not_ported("with_prewarm")

    def with_exactly_once(self, *args, **kwargs):
        self._not_ported("with_exactly_once")

    def rescale(self, *args, **kwargs):
        self._not_ported("rescale")

    # ------------------------------------------------------------------
    def _register_op(self, op: BasicOperator) -> None:
        self._ops.append(op)

    def add_source(self, source_op: BasicOperator) -> MultiPipe:
        if self._started:
            raise WindFlowError("cannot add sources after start()")
        if source_op.op_type != OpType.SOURCE:
            raise WindFlowError("add_source requires a Source-kind operator")
        mp = MultiPipe(self)
        mp._claim(source_op)
        stage = Stage(source_op)
        self._stages.append(stage)
        mp.tail = stage
        return mp

    # ------------------------------------------------------------------
    # build & wiring
    # ------------------------------------------------------------------
    def _build(self) -> None:
        if self._built:
            return
        self._built = True
        if self.device.type == "cuda":
            # initialise CUDA on the MAIN thread, before any worker touches
            # the card, and pin the device index the operators will use
            torch.cuda.init()
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        for s in self._stages:
            for op in s.ops:
                op.configure(self.execution_mode, self.time_policy,
                             self.device)
                if getattr(op, "is_gpu", False):
                    op.megabatch = self.megabatch
            if s.is_fused_gpu:
                # ONE fused replica per slot runs the whole chain; every
                # sub-op aliases the list so edge wiring (first_op /
                # last_op replicas) stays uniform
                from ..gpu.fused_ops import make_fused_replica
                fused = [make_fused_replica(s.ops, i)
                         for i in range(s.parallelism)]
                for op in s.ops:
                    op.replicas = fused
                    op._fused_hidden = op is not s.first_op
                s.first_op._fused_stage_label = s.describe()
            else:
                for op in s.ops:
                    op.build_replicas()
        for s in self._stages:
            if not s.is_source:
                s.channels = [Channel(self.channel_capacity)
                              for _ in range(s.parallelism)]
        # intra-stage chain wiring (InlinePort edges); a fused device stage
        # has none: the chain runs inside one replica
        for s in self._stages:
            if s.is_fused_gpu:
                continue
            for a, b in zip(s.ops[:-1], s.ops[1:]):
                for i in range(s.parallelism):
                    em = ForwardEmitter(1, 0, self.execution_mode)
                    em.punct_generation = False
                    em.set_ports([InlinePort(b.replicas[i])])
                    a.replicas[i].set_emitter(em)
        for c in self._stages:
            for edge in c.upstreams:
                self._wire_edge(edge.stage, c)
        for s in self._stages:
            for r in s.last_op.replicas:
                if r.emitter is None:
                    r.set_emitter(NullEmitter())
        for s in self._stages:
            self._make_workers(s)

    def _wire_edge(self, producer: Stage, consumer: Stage) -> None:
        """One emitter per producer replica targeting all consumer replicas
        (or one-to-one for same-parallelism FORWARD, reference Case 2)."""
        first = consumer.first_op
        routing = first.input_routing
        obs = producer.last_op.output_batch_size
        n_dests = consumer.parallelism
        p_gpu = getattr(producer.last_op, "is_gpu", False)
        c_gpu = getattr(first, "is_gpu", False)
        if c_gpu and not p_gpu and obs <= 0:
            # reference: a GPU operator's predecessor must declare an
            # output batch size (wf/multipipe.hpp:457-460)
            raise WindFlowError(
                f"operator {producer.last_op.name!r} feeds GPU operator "
                f"{first.name!r} but declares no output batch size; call "
                "with_output_batch_size(n) on the producer")
        one_to_one = (routing is RoutingMode.FORWARD
                      and not (c_gpu and not p_gpu)
                      and producer.parallelism == n_dests)
        if routing is RoutingMode.BROADCAST:
            for op in consumer.ops:
                for r in op.replicas:
                    r.copy_on_write = True
        # the op whose key the consumer stage reads on the host: its
        # entry's, or for a fused stage with an unkeyed entry its
        # terminator's (a fused prefix never rewrites the key field), so
        # that staging attaches host keys and a device edge starts the key
        # column's copy early
        key_op = first
        if consumer.is_fused_gpu and first.key_extractor is None:
            key_op = consumer.last_op
        for pi, pr in enumerate(producer.last_op.replicas):
            em = self._create_edge_emitter(first, key_op, routing, obs,
                                           n_dests, p_gpu, c_gpu, one_to_one)
            if one_to_one:
                ports = [QueuePort(consumer.channels[pi])]
            else:
                ports = [QueuePort(ch) for ch in consumer.channels]
            em.set_ports(ports)
            pr.set_emitter(em)

    def _create_edge_emitter(self, first: BasicOperator,
                             key_op: BasicOperator, routing: RoutingMode,
                             obs: int, n_dests: int, p_gpu: bool,
                             c_gpu: bool, one_to_one: bool) -> BasicEmitter:
        """Emitter kind per (device plane, routing): the reference's
        ``create_emitter`` (``wf/multipipe.hpp:248-362``) plus the GPU
        emitter cases."""
        from ..gpu.emitters_gpu import (GPUBroadcastEmitter,
                                        GPUColumnarExitEmitter,
                                        GPUExitEmitter, GPUForwardEmitter,
                                        GPUKeyByEmitter, GPUStageEmitter)
        if c_gpu and not p_gpu:  # CPU -> device staging boundary
            return GPUStageEmitter(
                n_dests, obs, getattr(first, "schema", None),
                key_op.key_extractor,
                "keyby" if routing is RoutingMode.KEYBY else
                "broadcast" if routing is RoutingMode.BROADCAST
                else "forward",
                self.execution_mode, key_op.key_field, self.device)
        if p_gpu and c_gpu:  # device -> device
            if routing is RoutingMode.KEYBY:
                return GPUKeyByEmitter(n_dests, self.execution_mode,
                                       key_field=first.key_field)
            if routing is RoutingMode.BROADCAST:
                em = GPUBroadcastEmitter(n_dests, 0, self.execution_mode)
            else:
                em = GPUForwardEmitter(1 if one_to_one else n_dests, 0,
                                       self.execution_mode)
            # a keyed consumer fed by forward/broadcast: its key column's
            # copy to the host starts here
            em.prefetch_field = key_op.key_field
            return em
        if getattr(first, "accepts_columns", False):
            if not p_gpu:
                raise WindFlowError(
                    f"{first.name}: with_columns sink needs a device-plane "
                    "producer (CPU-plane edges deliver rows)")
            if routing in (RoutingMode.KEYBY, RoutingMode.BROADCAST):
                raise WindFlowError(
                    f"{first.name}: with_columns sink supports forward/"
                    "rebalancing routing only")
            return GPUColumnarExitEmitter(1 if one_to_one else n_dests,
                                          self.execution_mode)
        if routing is RoutingMode.KEYBY:
            em: BasicEmitter = KeyByEmitter(first.key_extractor, n_dests,
                                            obs, self.execution_mode)
        elif routing is RoutingMode.BROADCAST:
            em = BroadcastEmitter(n_dests, obs, self.execution_mode)
        else:
            em = ForwardEmitter(1 if one_to_one else n_dests, obs,
                                self.execution_mode)
        if p_gpu:  # device -> host exit
            return GPUExitEmitter(em)
        return em

    def _make_workers(self, stage: Stage) -> None:
        for i in range(stage.parallelism):
            chain: List[Any] = []
            channel = None
            if not stage.is_source:
                channel = stage.channels[i]
                stage.first_op.replicas[i].stats.input_channel = channel
                if channel.n_inputs > 1:
                    chain.append(WatermarkCollector(
                        channel.n_inputs, stage.first_op.replicas[i]))
            if stage.is_fused_gpu:
                # every sub-op aliases the one fused replica
                chain.append(stage.first_op.replicas[i])
            else:
                chain.extend(op.replicas[i] for op in stage.ops)
            w = Worker(f"{self.name}/{stage.describe()}[{i}]", chain, channel)
            stage.workers.append(w)
            self._workers.append(w)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._started:
            raise WindFlowError("PipeGraph already started")
        self._validate()
        self._build()
        self._started = True
        self._t0 = time.monotonic()
        for w in self._workers:
            w.start()

    def wait_end(self) -> None:
        if not self._started:
            raise WindFlowError("PipeGraph not started")
        if self._ended:
            return
        for w in self._workers:
            w.join()
        self._ended = True
        self.elapsed_sec = time.monotonic() - self._t0
        errors = {w.name: w.error for w in self._workers
                  if w.error is not None}
        if len(errors) == 1:
            raise next(iter(errors.values()))
        if errors:
            raise WorkerFailuresError(errors) from next(iter(errors.values()))

    def run(self) -> None:
        """Blocking run (reference ``PipeGraph::run``)."""
        self.start()
        self.wait_end()

    def _validate(self) -> None:
        if not self._stages:
            raise WindFlowError("empty PipeGraph: no sources")
        for s in self._stages:
            if s.downstream is None and not s.is_sink:
                raise WindFlowError(
                    f"stage {s.describe()} has no sink downstream")

    # ------------------------------------------------------------------
    def get_num_threads(self) -> int:
        self._build()
        return len(self._workers)

    def get_num_dropped_tuples(self) -> int:
        return self.dropped.value

    def get_stats(self) -> Dict[str, Any]:
        return {
            "PipeGraph_name": self.name,
            "Device": str(self.device),
            "Mode": self.execution_mode.name,
            "Time_policy": self.time_policy.name,
            "Threads": len(self._workers),
            "Dropped_tuples": self.dropped.value,
            # a fused stage reports once, under its fused name m∘f∘r
            "Operators": [{
                "name": getattr(op, "_fused_stage_label", op.name),
                "kind": ("Fused_GPU_Chain"
                         if hasattr(op, "_fused_stage_label")
                         else type(op).__name__),
                "parallelism": op.parallelism,
                "replicas": [r.stats.to_dict() for r in op.replicas],
            } for op in self._ops if not getattr(op, "_fused_hidden",
                                                  False)],
        }
