"""PipeGraph: the streaming environment — build, wire, run, wait.

Trimmed copy of ``windflow_tpu/topology/pipegraph.py`` (parity with
``wf/pipegraph.hpp``: ``add_source``, ``run`` = ``start`` + ``wait_end``,
per-operator stats), for graphs of host and device operators with splits
(``MultiPipe.split``/``select``) and merges. A chained device stage runs
as one fused replica per slot (``gpu/fused_ops.py``): ``fusion`` (default
on, the JAX package's ``WF_TPU_FUSION``) lets ``MultiPipe.chain`` fuse
device operators, and ``megabatch`` (default 1 = off, its
``WF_MEGABATCH``) is the width of the megabatch groups of every device
replica's dispatch queue.

``with_checkpointing`` turns on aligned-barrier checkpoints
(``windflow_tpu_torch.checkpoint``): FULL and synchronous by default, with
opt-in delta snapshots and an asynchronous uploader. ``run(restore_from=
...)`` restores a graph of the same topology from a committed one: a
missing operator, a parallelism or fusion mismatch, or a corrupt blob
raises; a restore never degrades to a fresh start.

The graph carries the torch ``device`` its device operators run on:
``device=None`` means ``cuda``, and a graph refuses to exist when no CUDA
card is present unless the caller asked for ``device="cpu"`` — it never
falls back silently. ``start()`` initialises CUDA on the main thread.

``rescale(op, n)`` repartitions a running keyed operator live
(``scaling/``), ``with_autoscaler`` closes that loop over the queues'
backpressure, ``with_supervision`` restarts a graph whose worker died from
its newest committed checkpoint (``supervision/``), and an operator's
``with_error_policy`` contains failing records (a device batch is bisected
to its poison record). Mesh operators (``with_mesh`` on the device
builders, ``mesh/``) shard keyed state over a mesh of shards on the
graph's card; ``with_device_probe`` lets the supervisor rebuild them on
the healthy devices. ``with_exactly_once`` (or a sink builder's) makes
sinks deliver each result once across kills and restores: an
epoch-fenced two-phase commit on the checkpoint coordinator's finalize
(``sinks/transactional.py``). Overload protection, prewarm, the
monitoring plane's tracing and exports, and ``with_compile_cache`` are
not ported yet and raise.

``execution_mode`` picks the collector in front of each stage
(``_make_collector``): DEFAULT merges watermarks, DETERMINISTIC merges the
input channels into one timestamp order, PROBABILISTIC reorders with
K-slack and counts what it drops (``get_num_dropped_tuples``). The device
operators run in DEFAULT mode only and refuse the others when the graph
configures them.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from ..basic import (DEFAULT_BUFFER_CAPACITY, ExecutionMode, JoinMode,
                     OpType, RoutingMode, TimePolicy, WindFlowError,
                     WorkerFailuresError)
from ..operators.base import BasicOperator
from ..runtime.channel import Channel, InlinePort, QueuePort
from ..runtime.collectors import (AtomicCounter, DPJoinCollector,
                                  IDSequencerCollector, KSlackCollector,
                                  OrderingCollector, WatermarkCollector)
from ..runtime.emitters import (BasicEmitter, BroadcastEmitter,
                                ForwardEmitter, KeyByEmitter, NullEmitter,
                                SplittingEmitter)
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
        self._coordinator = None
        self._ckpt_enabled = False
        self._ckpt_interval: Optional[float] = None
        self._ckpt_dir: Optional[str] = None
        self._ckpt_retain = 3
        self._ckpt_timeout = 0.0
        self._ckpt_delta = False
        self._ckpt_async = False
        self._ckpt_full_every = 8
        # live rescale (scaling/): the controller is made on first use;
        # _rescaling keeps wait_end waiting while a rescale swaps the plane
        self._rescale_ctrl = None
        self._rescaling = False
        self._autoscale_enabled = False
        self._autoscale_policy = None
        self._autoscaler = None
        # replicas a scale-down removed: reported once more, marked Final
        self._final_series: List[Dict[str, Any]] = []
        # supervision (supervision/): _supervising keeps wait_end waiting
        # while the supervisor rebuilds the plane
        self._supervise_enabled = False
        self._supervise_policy = None
        self._supervisor = None
        self._supervising = False
        self._device_probe = None
        self._initial_positions: Dict[Any, Any] = {}
        self._dlq = None  # the graph's dead-letter queue, on first use
        # exactly-once sinks: graph-wide switch and staging root (the JAX
        # package's WF_EXACTLY_ONCE / WF_TXN_DIR); per-sink builders opt in
        # on their own
        self._exactly_once = False
        self._txn_dir: Optional[str] = None

    # -- surfaces of the JAX package that are not ported yet ---------------
    def _not_ported(self, what: str):
        raise WindFlowError(f"{what} is not yet ported to windflow_tpu_torch")

    def with_slo(self, *args, **kwargs):
        self._not_ported("with_slo")

    def with_prewarm(self, *args, **kwargs):
        self._not_ported("with_prewarm")

    def with_compile_cache(self, *args, **kwargs):
        self._not_ported("with_compile_cache")

    def with_flight_recorder(self, *args, **kwargs):
        self._not_ported("with_flight_recorder")

    def prewarm_report(self, *args, **kwargs):
        self._not_ported("prewarm_report")

    def dump_stats(self, *args, **kwargs):
        self._not_ported("dump_stats")

    def dump_trace(self, *args, **kwargs):
        self._not_ported("dump_trace")

    def trace_document(self, *args, **kwargs):
        self._not_ported("trace_document")

    def to_dot(self, *args, **kwargs):
        self._not_ported("to_dot")

    def to_svg(self, *args, **kwargs):
        self._not_ported("to_svg")

    # ------------------------------------------------------------------
    # exactly-once sinks (windflow_tpu_torch.sinks.transactional)
    # ------------------------------------------------------------------
    def with_exactly_once(self, staging_dir: Optional[str] = None
                          ) -> "PipeGraph":
        """Graph-wide exactly-once delivery: every sink runs the
        epoch-fenced two-phase commit (stage per checkpoint epoch,
        pre-commit at the aligned barrier, commit atomically when the
        coordinator finalizes the epoch). Requires ``with_checkpointing``;
        a sink family that cannot honour the protocol makes ``start()``
        refuse rather than silently downgrade the guarantee.
        ``staging_dir`` is the segment root of every sink that names none
        of its own (default ``wf_txn_sinks``; the JAX package's
        ``WF_TXN_DIR``)."""
        if self._started:
            raise WindFlowError("with_exactly_once after start()")
        self._exactly_once = True
        if staging_dir is not None:
            self._txn_dir = staging_dir
        return self

    # ------------------------------------------------------------------
    # supervision (windflow_tpu_torch.supervision)
    # ------------------------------------------------------------------
    def with_supervision(self, policy: Optional[Any] = None) -> "PipeGraph":
        """Recover the whole graph from worker deaths by itself: a
        supervisor tears the runtime plane down, restores the newest
        committed checkpoint that verifies, resumes the sources from their
        recorded positions and restarts, under ``policy`` (a
        ``RestartPolicy``: jittered exponential backoff, a bounded restart
        budget; None = its defaults). An exhausted budget raises
        ``SupervisionEscalated`` from ``wait_end``. Turns checkpointing on
        when it is not configured (set an interval, or request
        checkpoints, to bound the replay)."""
        if self._started:
            raise WindFlowError("with_supervision after start()")
        self._supervise_enabled = True
        self._supervise_policy = policy
        if not self._ckpt_enabled:
            self.with_checkpointing()
        return self

    def with_device_probe(self, probe: Any) -> "PipeGraph":
        """Install a device-health probe (``supervision/health.py``):
        during every supervised recovery the probe's dead devices are
        excluded from the rebuilt meshes (``mesh.set_excluded_devices``),
        so mesh operators come back on the surviving devices with their
        sharded state relayouted; the graph runs degraded
        (``Recovery_degraded_devices`` > 0) until the probe sees the
        devices return and one planned restart re-expands the meshes.
        Without a supervisor the probe is never read."""
        if self._started:
            raise WindFlowError("with_device_probe after start()")
        self._device_probe = probe
        return self

    def failure_domains(self) -> Dict[int, List[str]]:
        """Device id -> the mesh operators whose sharded state lives on it
        (built replicas only): the unit of loss for device failover."""
        from ..supervision.health import failure_domain_map
        return failure_domain_map(self)

    def _capture_initial_positions(self) -> None:
        """Each replayable source replica's STARTING cursor, taken before
        the first tuple ships. A failure before any checkpoint committed
        leaves nothing to restore: the supervisor then resets the sources
        to these positions (a full replay) instead of resuming from their
        in-memory cursors and losing what sat in the discarded channels."""
        from ..operators.base import arity
        from ..operators.source import Source
        self._initial_positions = {}
        for s in self._stages:
            if not s.is_source or not isinstance(s.first_op, Source):
                continue
            op = s.first_op
            snap = getattr(op.func, "snapshot_position", None)
            if snap is None:
                continue
            for r in op.replicas:
                pos = r._restore_position  # a restore_from= start
                if pos is None:
                    pos = snap(r.context) if arity(snap) >= 1 else snap()
                self._initial_positions[(op.name, r.idx)] = pos

    def dead_letter_queue(self):
        """The graph's quarantine side channel (made on first use; see
        ``supervision/errors.py:DeadLetterQueue``)."""
        if self._dlq is None:
            from ..supervision.errors import DeadLetterQueue
            self._dlq = DeadLetterQueue(self.name)
        return self._dlq

    def dead_letters(self) -> List[Dict[str, Any]]:
        """Records quarantined by DEAD_LETTER error policies (payload,
        exception, traceback), newest last."""
        return [] if self._dlq is None else self._dlq.records()

    def _negotiate_error_policies(self) -> None:
        """At build: refuse a policy where it means nothing (a source), and
        give every operator whose policy can quarantine, and that names no
        queue of its own, the graph's dead-letter queue. The queue is set
        on the OPERATOR: ``ErrorPolicy.DEAD_LETTER`` is shared by every
        graph."""
        for op in self._ops:
            pol = getattr(op, "error_policy", None)
            if pol is None or pol.is_fail:
                continue
            if op.op_type == OpType.SOURCE:
                raise WindFlowError(
                    f"with_error_policy: source {op.name!r} drives its own "
                    "generation loop — there is no per-record invocation "
                    "to contain; use with_supervision() for source "
                    "failures")
            if pol.may_dead_letter:
                op._dlq = pol.dlq if pol.dlq is not None \
                    else self.dead_letter_queue()

    def _negotiate_exactly_once(self) -> None:
        """At build, before the replicas are made (their classes follow
        ``op.exactly_once``): turn graph-wide exactly-once on in every sink,
        then check that every exactly-once sink can deliver it, and that
        the checkpoint plane that drives its commits is on. Refuses loudly:
        a guarantee that silently downgrades is worse than a refusal."""
        sinks = [op for op in self._ops if op.op_type == OpType.SINK]
        if self._exactly_once:
            for op in sinks:
                if not getattr(op, "supports_exactly_once", False):
                    raise WindFlowError(
                        f"with_exactly_once: sink {op.name!r} "
                        f"({type(op).__name__}) does not implement the "
                        "transactional sink protocol (precommit_epoch / "
                        "commit-on-finalize); it would deliver "
                        "at-least-once and break the graph guarantee")
                op.exactly_once = True
        eo_sinks = [op for op in sinks
                    if getattr(op, "exactly_once", False)]
        for op in eo_sinks:
            if not getattr(op, "supports_exactly_once", False):
                raise WindFlowError(
                    f"sink {op.name!r} ({type(op).__name__}) has "
                    "exactly_once set but does not implement the "
                    "transactional sink protocol")
            if self._txn_dir is not None and hasattr(op, "txn_dir") \
                    and op.txn_dir is None:
                op.txn_dir = self._txn_dir
        if eo_sinks and not self._ckpt_enabled:
            raise WindFlowError(
                "exactly-once sinks need the checkpoint plane that "
                f"drives their commits: sink(s) "
                f"{[op.name for op in eo_sinks]} request exactly-once "
                "but checkpointing is off — call with_checkpointing(...) "
                "before start()")

    def _negotiate_mesh_checkpoint(self) -> None:
        """At build, under checkpointing: a mesh operator without a
        sharded snapshot/restore path would produce checkpoints that
        silently omit its mesh state, and could never restore it. Refuse
        loudly instead (every in-tree mesh operator is snapshot-capable;
        this is the standing guard for one that is not)."""
        if not self._ckpt_enabled:
            return
        for op in self._ops:
            if getattr(op, "is_mesh", False) \
                    and not getattr(op, "mesh_snapshot_capable", False):
                raise WindFlowError(
                    f"with_checkpointing: mesh operator {op.name!r} "
                    f"({type(op).__name__}) has no sharded "
                    "snapshot/restore path — a checkpoint would silently "
                    "omit its mesh state and a restore could not "
                    "rebuild it; run this graph without checkpointing/"
                    "supervision or use a snapshot-capable mesh operator")

    # ------------------------------------------------------------------
    # live rescale (windflow_tpu_torch.scaling)
    # ------------------------------------------------------------------
    def with_autoscaler(self, policy: Optional[Any] = None) -> "PipeGraph":
        """Attach the autoscaler loop: a thread reads every operator's
        queue backpressure and starvation and rescales the bottleneck up
        (starved operators down) with hysteresis and a cooldown.
        ``policy`` is an ``AutoscalePolicy`` (None = its defaults). Turns
        checkpointing on when it is not configured."""
        if self._started:
            raise WindFlowError("with_autoscaler after start()")
        self._autoscale_enabled = True
        self._autoscale_policy = policy
        if not self._ckpt_enabled:
            self.with_checkpointing()
        return self

    def _rescale_controller(self):
        if self._rescale_ctrl is None:
            from ..scaling.controller import RescaleController
            self._rescale_ctrl = RescaleController(self)
        return self._rescale_ctrl

    def rescale(self, op_name: str, parallelism: int,
                timeout_s: Optional[float] = None) -> Any:
        """LIVE rescale of one operator (its whole chained stage) to a new
        parallelism: trigger an aligned checkpoint, quiesce at the
        barrier, rebuild the stage's replicas and every affected routing
        table, restore the repartitioned keyed state, resume, without a
        replay from the start. Returns a ``RescaleReport`` with the
        measured ``checkpoint_s`` / ``pause_s`` / ``total_s`` and the
        pause's split. Raises ``WindFlowError`` for an operator whose
        state cannot be repartitioned (a global reduce, a non-keyed
        window, a source), a source that is not replayable, a graph
        without checkpointing, and a quiesce that outlives ``timeout_s``
        (default: the graph's ``epoch_timeout_s``, else 60 s); after a
        refusal or a timeout the graph goes on as it was."""
        self._rescaling = True
        try:
            return self._rescale_controller().rescale(op_name, parallelism,
                                                      timeout_s)
        finally:
            self._rescaling = False

    def _note_retired_replicas(self, stage, new_n: int) -> None:
        """The final stats of the replicas a scale-down removes (shown in
        the next ``get_stats`` marked ``Final``, then dropped)."""
        for op in stage.ops:
            if getattr(op, "_fused_hidden", False):
                continue
            label = getattr(op, "_fused_stage_label", None) or op.name
            finals = []
            for r in op.replicas[new_n:]:
                d = r.stats.to_dict()
                d["Final"] = True
                finals.append(d)
            if finals:
                self._final_series.append({
                    "name": label, "kind": type(op).__name__,
                    "parallelism": 0, "retired": True,
                    "replicas": finals})

    def _rebuild_runtime(self) -> None:
        """Discard the runtime plane (replicas, channels, collectors,
        workers) and rebuild it from the (possibly re-parallelized) stage
        IR, its workers bound to the coordinator and the supervisor. The
        caller (the rescale controller, the supervisor) owns quiescing:
        every old worker must already be parked or joined."""
        for s in self._stages:
            s.channels = []
            s.workers = []
            for op in s.ops:
                op.replicas = []
        self._workers = []
        self._built = False
        self._build()
        self._bind_workers()

    def _bind_workers(self) -> None:
        coord = self._coordinator
        if coord is not None:
            for w in self._workers:
                w.bind_coordinator(coord)
            coord.expected_acks = len(self._workers)
            coord.worker_names = [w.name for w in self._workers]

    def _sync_device(self) -> None:
        """Wait for the card's queued work (nothing to wait for on the
        CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # checkpointing (windflow_tpu_torch.checkpoint)
    # ------------------------------------------------------------------
    def with_checkpointing(self, interval: Optional[float] = None,
                           store_dir: Optional[str] = None,
                           retain: int = 3,
                           epoch_timeout_s: float = 0.0,
                           delta: bool = False, async_upload: bool = False,
                           full_every: int = 8) -> "PipeGraph":
        """Enable aligned-barrier checkpointing (by default FULL snapshots,
        written synchronously by each worker).

        ``interval`` (seconds) drives periodic checkpoints; None disables
        the timer — checkpoints then happen only on explicit triggers
        (``SourceShipper.request_checkpoint()`` or
        ``graph.trigger_checkpoint()``). ``store_dir`` is the store root
        (default ``wf_checkpoints/<graph name>``); the last ``retain``
        committed checkpoints are kept. An epoch pending longer than
        ``epoch_timeout_s`` fails naming the workers that never acked
        (0 = never; the JAX package's ``WF_CKPT_TIMEOUT``).

        ``delta`` (the JAX package's ``WF_CKPT_DELTA``): incremental
        checkpoints. An unchanged blob becomes a manifest ref to its
        ancestor, and the keyed device engines (stateful Map/Filter_GPU,
        their tiered stores, Ffat_Windows_GPU) snapshot only the slot rows
        touched since their last FULL snapshot, at least one FULL every
        ``full_every`` captures (``WF_CKPT_FULL_EVERY``; 1 = always FULL).
        ``async_upload`` (``WF_CKPT_ASYNC``): a worker's ack only queues
        its captured blobs; one uploader thread writes them and the epoch
        commits when the last one lands."""
        if self._started:
            raise WindFlowError("with_checkpointing after start()")
        self._ckpt_enabled = True
        if interval is not None:
            self._ckpt_interval = float(interval)
        if store_dir is not None:
            self._ckpt_dir = store_dir
        self._ckpt_retain = retain
        self._ckpt_timeout = float(epoch_timeout_s)
        self._ckpt_delta = bool(delta)
        self._ckpt_async = bool(async_upload)
        self._ckpt_full_every = max(1, int(full_every))
        return self

    def trigger_checkpoint(self, wait: bool = False,
                           timeout_s: Optional[float] = None
                           ) -> Optional[int]:
        """Force a checkpoint epoch now (sources inject barriers at their
        next push boundary). Returns the checkpoint id, or None when
        checkpointing is not enabled or not running. With ``wait=True``,
        blocks until the epoch commits and raises a ``WindFlowError``
        naming the unacked workers if it times out (``timeout_s``, default
        the graph's ``epoch_timeout_s``)."""
        if self._coordinator is None:
            return None
        cid = self._coordinator.trigger(force=True)
        if wait and cid is not None:
            self._coordinator.wait_committed(cid, timeout_s)
        return cid

    def _ckpt_store_dir(self) -> str:
        if self._ckpt_dir:
            return self._ckpt_dir
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in self.name) or "pipegraph"
        return os.path.join("wf_checkpoints", safe)

    def _setup_checkpointing(self, restore_from: Optional[str]):
        """Create the store and the coordinator and resolve the restore
        target. Returns ``(ckpt_dir, manifest)`` or ``(None, None)``."""
        from ..checkpoint import CheckpointCoordinator, CheckpointStore

        resolved = None
        if restore_from is not None:
            resolved = CheckpointStore.resolve(restore_from)
            if not self._ckpt_enabled:
                # restoring implies checkpointing: keep writing new
                # checkpoints into the same store unless told otherwise
                self._ckpt_enabled = True
                if self._ckpt_dir is None:
                    self._ckpt_dir = os.path.dirname(resolved[1])
        if not self._ckpt_enabled:
            return None, None
        store = CheckpointStore(self._ckpt_store_dir(),
                                retain=self._ckpt_retain,
                                delta=self._ckpt_delta)
        self._coordinator = CheckpointCoordinator(
            store, self.name, interval_s=self._ckpt_interval,
            epoch_timeout_s=self._ckpt_timeout,
            async_upload=self._ckpt_async,
            full_every=self._ckpt_full_every)
        if resolved is not None:
            cid, ckpt_dir, manifest = resolved
            # new epochs continue after the restored one; sources bind
            # their injection cursor to this before any trigger fires
            self._coordinator.rewind_to(cid)
            return ckpt_dir, manifest
        return None, None

    def _restore_replicas(self, ckpt_dir: str, manifest: Dict[str, Any]
                          ) -> None:
        self._restore_states(
            self._coordinator.store.load_states(ckpt_dir, manifest))

    def _restore_states(self, states: Dict[Any, Any]) -> None:
        """Push every blob's state into the matching rebuilt replica.
        Topology mismatches fail loudly: silently dropping state would
        trade a crash for wrong answers."""
        by_name = {op.name: op for op in self._ops}
        for (op_name, idx), state in states.items():
            op = by_name.get(op_name)
            if op is None:
                raise WindFlowError(
                    f"restore: checkpoint has state for operator "
                    f"{op_name!r} which this graph does not contain")
            if getattr(op, "_fused_hidden", False):
                raise WindFlowError(
                    f"restore: checkpoint holds standalone state for "
                    f"{op_name!r}, but this graph fuses it into the device "
                    f"chain {op.replicas[0].fused_name!r} — the "
                    "checkpointed topology was fused differently (match "
                    "PipeGraph(fusion=...) / the chain() calls of the "
                    "original graph)")
            if idx >= len(op.replicas):
                raise WindFlowError(
                    f"restore: operator {op_name!r} was checkpointed with "
                    f"parallelism > {len(op.replicas)}; restore_from needs "
                    "the checkpointed topology")
            replica = op.replicas[idx]
            if state.get("__fused__") is not None \
                    and getattr(replica, "fused_signature", None) is None:
                raise WindFlowError(
                    f"restore: checkpoint blob for {op_name!r} holds a "
                    f"fused device chain {'∘'.join(state['__fused__'])!r}, "
                    "but this graph runs the operator standalone — the "
                    "checkpointed topology was fused differently (match "
                    "PipeGraph(fusion=...) / the chain() calls of the "
                    "original graph)")
            if "txn_last_epoch" in state \
                    and not hasattr(replica, "precommit_epoch"):
                raise WindFlowError(
                    f"restore: checkpoint blob for {op_name!r} was taken "
                    "by an exactly-once sink, but this graph runs the "
                    "sink at-least-once — staged epochs would neither "
                    "commit nor abort; enable with_exactly_once() to "
                    "match the checkpointed guarantee")
            state = dict(state)
            em_state = state.pop("__emitter__", None)
            coll_state = state.pop("__collector__", None)
            replica.restore_state(state)
            if em_state is not None and replica.emitter is not None:
                replica.emitter.restore_emitter_state(em_state)
            coll = getattr(replica, "_collector", None)
            if coll_state is not None and coll is not None:
                coll.restore_state(coll_state)

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
        mp.tail_groups = [[stage]]
        return mp

    # ------------------------------------------------------------------
    # build & wiring
    # ------------------------------------------------------------------
    def _build(self) -> None:
        if self._built:
            return
        self._built = True
        self._negotiate_exactly_once()
        self._negotiate_error_policies()
        self._negotiate_mesh_checkpoint()
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
        # inter-stage wiring, consumer-driven so that input channel indices
        # follow upstream order
        for c in self._stages:
            for edge in c.upstreams:
                self._wire_edge(edge.stage, edge.branch, c)
        for s in self._stages:
            if s.is_split:
                self._assemble_split(s)
            for r in s.last_op.replicas:
                if r.emitter is None:
                    r.set_emitter(NullEmitter())
        for s in self._stages:
            self._make_workers(s)

    def _assemble_split(self, s: Stage) -> None:
        """Each replica of a split stage gets one splitting emitter over
        its per-branch edge emitters: the device one after a device stage
        (branches get device gathers), the host one otherwise."""
        from ..gpu.emitters_gpu import GPUSplittingEmitter
        for r in s.last_op.replicas:
            inner = r._split_inner  # branch -> edge emitter
            ems = [inner.get(b) for b in range(len(s.split_branches))]
            missing = [b for b, e in enumerate(ems) if e is None]
            if missing:
                raise WindFlowError(
                    f"split stage {s.describe()}: branches {missing} have "
                    "no operators")
            logic = s.split_logic
            if s.split_gpu:
                se: BasicEmitter = GPUSplittingEmitter(
                    logic, ems, self.execution_mode)
            else:
                if isinstance(logic, str):
                    field = logic
                    logic = (lambda t, _f=field:
                             t[_f] if isinstance(t, dict)
                             else getattr(t, _f))
                se = SplittingEmitter(logic, ems, self.execution_mode)
            r.set_emitter(se)

    def _wire_edge(self, producer: Stage, branch: Optional[int],
                   consumer: Stage) -> None:
        """One emitter per producer replica targeting all consumer replicas
        (or one-to-one for same-parallelism FORWARD, reference Case 2). An
        edge out of split branch ``branch`` is kept per replica in
        ``_split_inner`` for the splitting emitter (``_assemble_split``)."""
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
                      and branch is None
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
            if branch is None:
                pr.set_emitter(em)
            else:
                if not hasattr(pr, "_split_inner"):
                    pr._split_inner = {}
                pr._split_inner[branch] = em

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
                self.execution_mode, key_op.key_field, self.device,
                key_fields=key_op.key_fields)
        if p_gpu and c_gpu:  # device -> device
            if routing is RoutingMode.KEYBY:
                return GPUKeyByEmitter(n_dests, self.execution_mode,
                                       key_field=first.key_field,
                                       key_fields=first.key_fields)
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

    def _make_collector(self, stage: Stage, replica_idx: int):
        """The collector in front of one replica (``wf/multipipe.hpp:
        200-244``): the WLQ/REDUCE stages of composite windows sequence
        per-key result ids in every mode; a join tags its two streams;
        DEFAULT merges watermarks (a DP join needs one total order),
        DETERMINISTIC merges by timestamp, PROBABILISTIC always reorders
        with K-slack, its drops counted in ``dropped``."""
        first_replica = stage.first_op.replicas[replica_idx]
        n_in = stage.channels[replica_idx].n_inputs
        if getattr(stage.first_op, "collector_override", None) == "id":
            return IDSequencerCollector(n_in, first_replica,
                                        stage.first_op.key_extractor)
        separator = None
        if stage.first_op.op_type == OpType.JOIN:
            separator = sum(s.parallelism for s in stage.join_a_stages)
        mode = self.execution_mode
        if mode is ExecutionMode.DEFAULT:
            if separator is not None \
                    and getattr(stage.first_op, "join_mode", None) \
                    is JoinMode.DP:
                return DPJoinCollector(n_in, first_replica, separator)
            if n_in > 1 or separator is not None:
                return WatermarkCollector(n_in, first_replica, separator)
            return None
        if mode is ExecutionMode.DETERMINISTIC:
            if n_in > 1 or separator is not None:
                return OrderingCollector(n_in, first_replica, separator)
            return None
        # PROBABILISTIC: disorder exists within one channel too
        return KSlackCollector(n_in, first_replica, self.dropped, separator)

    def _make_workers(self, stage: Stage) -> None:
        for i in range(stage.parallelism):
            chain: List[Any] = []
            channel = None
            if not stage.is_source:
                channel = stage.channels[i]
                stage.first_op.replicas[i].stats.input_channel = channel
                coll = self._make_collector(stage, i)
                if coll is not None:
                    chain.append(coll)
                    # restore reaches the collector through its replica
                    stage.first_op.replicas[i]._collector = coll
            if stage.is_fused_gpu:
                # every sub-op aliases the one fused replica
                chain.append(stage.first_op.replicas[i])
            else:
                chain.extend(op.replicas[i] for op in stage.ops)
            w = Worker(f"{self.name}/{stage.describe()}[{i}]", chain, channel)
            if self._supervisor is not None:
                # supervised: a dying worker wakes the supervisor instead
                # of draining and forcing EOS
                w.on_failure = self._supervisor.note_failure
            stage.workers.append(w)
            self._workers.append(w)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def start(self, restore_from=None) -> None:
        if self._started:
            raise WindFlowError("PipeGraph already started")
        self._validate()
        if self._supervise_enabled:
            # the supervisor exists BEFORE the build, so every worker gets
            # its failure hook
            from ..supervision.supervisor import Supervisor
            self._supervisor = Supervisor(self, self._supervise_policy)
        states = restore_from if isinstance(restore_from, dict) else None
        ckpt_dir, manifest = self._setup_checkpointing(
            None if states is not None else restore_from)
        if states is not None and self._coordinator is not None:
            # a states dict names no checkpoint id, but an exactly-once
            # sink's blob records its epoch: new epochs continue after it
            # (an id at or below it would be discarded as committed)
            self._coordinator.rewind_to(max(
                (int(st.get("txn_last_epoch", 0)) for st in states.values()),
                default=0))
        self._build()
        if states is not None:
            self._restore_states(states)
        elif ckpt_dir is not None:
            self._restore_replicas(ckpt_dir, manifest)
        # bound here, not at build: get_num_threads() may have built the
        # workers before the coordinator existed
        self._bind_workers()
        if self._coordinator is not None:
            self._coordinator.start()
        if self._supervisor is not None:
            self._capture_initial_positions()
        self._started = True
        self._t0 = time.monotonic()
        for w in self._workers:
            w.start()
        if self._supervisor is not None:
            self._supervisor.start()
        if self._autoscale_enabled:
            from ..scaling.autoscaler import Autoscaler
            self._autoscaler = Autoscaler(self, self._autoscale_policy)
            self._autoscaler.start()

    def wait_end(self) -> None:
        """Join every worker, then raise: a supervisor's
        ``SupervisionEscalated``, else the first worker error (several:
        ``WorkerFailuresError``), else a failed checkpoint upload's
        (``CheckpointCoordinator.upload_error``). A live rescale or a
        supervised restart REPLACES the workers mid-run, so the join
        sweep runs again over the current plane until it stays put."""
        if not self._started:
            raise WindFlowError("PipeGraph not started")
        if self._ended:
            return
        while True:
            workers = self._workers
            try:
                for w in workers:
                    w.join()
            except RuntimeError:
                # mid-rebuild: the new plane is published but its threads
                # are not started yet
                time.sleep(0.02)
                continue
            if self._workers is not workers:
                continue
            if self._rescaling or self._supervising:
                time.sleep(0.05)  # the new plane is coming
                continue
            sup = self._supervisor
            if sup is not None and sup.active \
                    and any(w.error is not None for w in workers):
                # a worker died but the supervisor has not reacted yet
                time.sleep(0.02)
                continue
            break
        self._ended = True
        if self._supervisor is not None:
            self._supervisor.stop()
        if self._autoscaler is not None:
            self._autoscaler.stop()
        self.elapsed_sec = time.monotonic() - self._t0
        if self._coordinator is not None:
            self._coordinator.stop()
        if self._supervisor is not None \
                and self._supervisor.escalated is not None:
            raise self._supervisor.escalated
        errors = {w.name: w.error for w in self._workers
                  if w.error is not None}
        if len(errors) == 1:
            raise next(iter(errors.values()))
        if errors:
            raise WorkerFailuresError(errors) from next(iter(errors.values()))
        if self._coordinator is not None \
                and self._coordinator.upload_error is not None:
            raise self._coordinator.upload_error
        # exactly-once sinks: the run finished cleanly, so every pending
        # epoch (the tail after the last barrier, and any epoch finalized
        # after its sink's worker exited) commits now, in epoch order, on
        # this thread. After an error they stay pending: a restore rolls
        # them forward or aborts them.
        for op in self._ops:
            for r in {id(r): r for r in op.replicas}.values():
                fin = getattr(r, "txn_complete", None)
                if fin is not None:
                    fin()

    def run(self, restore_from=None) -> None:
        """Blocking run (reference ``PipeGraph::run``). ``restore_from``: a
        checkpoint store root (resumes from its latest committed
        checkpoint), one checkpoint directory, or the replica states of
        one checkpoint as a dict ``{(op name, replica): state}`` (what
        ``convert.checkpoint_states_from_jax`` returns). The topology must
        match the checkpointed one (operator names, parallelisms, fusion),
        and replayable sources resume from their recorded positions."""
        self.start(restore_from)
        self.wait_end()

    def _validate(self) -> None:
        if not self._stages:
            raise WindFlowError("empty PipeGraph: no sources")
        for s in self._stages:
            if s.is_split:
                missing = [b for b, st in enumerate(s.split_branches)
                           if st is None]
                if missing:
                    raise WindFlowError(
                        f"split after {s.describe()}: empty branches "
                        f"{missing}")
            elif s.downstream is None and not s.is_sink:
                raise WindFlowError(
                    f"stage {s.describe()} has no sink downstream")

    # ------------------------------------------------------------------
    def get_num_threads(self) -> int:
        self._build()
        return len(self._workers)

    def get_num_dropped_tuples(self) -> int:
        return self.dropped.value

    def get_stats(self) -> Dict[str, Any]:
        # replicas a scale-down removed appear in exactly ONE report,
        # marked Final, then their series end
        finals, self._final_series = self._final_series, []
        st = {
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
                                                  False)] + finals,
        }
        if self._coordinator is not None:
            st["Checkpoints"] = self._coordinator.stats()
        if self._rescale_ctrl is not None:
            st["Rescales"] = self._rescale_ctrl.stats()
        if self._autoscaler is not None:
            st["Autoscaler"] = self._autoscaler.stats()
        if self._supervisor is not None:
            st["Supervision"] = self._supervisor.stats()
        if self._dlq is not None:
            st["Dead_letters"] = self._dlq.total
        return st
