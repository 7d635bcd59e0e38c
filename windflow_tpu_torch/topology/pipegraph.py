"""PipeGraph: the streaming environment — build, wire, run, wait.

Copy of ``windflow_tpu/topology/pipegraph.py`` (parity with
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
(``sinks/transactional.py``).

The monitoring plane: sampled latency tracing (``latency_sample`` and the
builders' ``with_latency_tracing``), per-worker flight-recorder rings
(``with_flight_recorder``, ``dump_trace`` / ``trace_document``, automatic
post-mortems), the stall watchdog (``stall_sec``; a supervisor restarts on
a stall), the dashboard reports (``dashboard=(machine, port)``, 1 Hz over
TCP to a ``MonitoringServer``) and ``dump_stats`` / ``to_dot`` /
``to_svg``. ``with_slo`` attaches the overload governor (``overload/``),
``with_prewarm`` builds every capacity bucket's device state before the
sources open, and ``native_channels`` puts the C++ channel ring of
``native/`` on the host plane, whose staging encoders row staging uses
whenever the runtime builds.
The JAX package's ``WF_*`` knobs of these planes are the constructor's
arguments. ``with_compile_cache`` points the build of the hand-written
kernels' libraries at a directory of the user's, process-wide.

``execution_mode`` picks the collector in front of each stage
(``_make_collector``): DEFAULT merges watermarks, DETERMINISTIC merges the
input channels into one timestamp order, PROBABILISTIC reorders with
K-slack and counts what it drops (``get_num_dropped_tuples``). The device
operators run in DEFAULT mode only and refuse the others when the graph
configures them.
"""

from __future__ import annotations

import json
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
                 megabatch: int = 1, native_channels: bool = False,
                 latency_sample=0,
                 stall_sec: float = 0.0,
                 wm_stall_sec: Optional[float] = None,
                 dashboard: Optional[Any] = None,
                 log_dir: str = "log") -> None:
        """``native_channels`` (the JAX package's WF_NATIVE_CHANNELS):
        every worker's input channel is the C++ ring of ``native/`` (row
        staging fills its columns with the native encoders whenever the
        runtime builds, as in the JAX package). ``latency_sample``
        (WF_LATENCY_SAMPLE): the sampling rate of every operator without
        its own ``with_latency_tracing``. ``stall_sec`` (WF_STALL_SEC): the
        stall watchdog's threshold, 0 = off. ``wm_stall_sec``
        (WF_WM_STALL_SEC): the watermark-stall threshold of the stats.
        ``dashboard`` (WF_TRACING_ENABLED with WF_DASHBOARD_MACHINE /
        WF_DASHBOARD_PORT): a ``(machine, port)`` the graph's
        ``MonitoringThread`` reports to, and ``wait_end`` then writes
        ``dump_stats`` into ``log_dir`` (WF_LOG_DIR, also where
        post-mortem traces go)."""
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
        # native host runtime (native/)
        self.native_channels = bool(native_channels)
        # the staging encoders; only a comparison run switches them off
        self._native_encoders = True
        # monitoring plane (monitoring/)
        from ..monitoring.tracing import parse_sample_rate
        self.latency_sample = parse_sample_rate(latency_sample)
        self.stall_sec = max(0.0, float(stall_sec))
        self.wm_stall_sec = wm_stall_sec
        self.dashboard = dashboard
        self.log_dir = log_dir
        self._monitor = None
        self._flightrec_events = 0
        self._recorders: List[Any] = []
        self._watchdog = None
        self.last_postmortem: Optional[str] = None  # newest dump path
        # overload protection (overload/): with_slo attaches the governor
        # at start()
        self._slo_p99_ms: Optional[float] = None
        self._overload_policy = None
        self._overload_governor = None
        # the kernels' compile cache directory (with_compile_cache)
        self._compile_cache_dir: Optional[str] = None
        # prewarm (with_prewarm): every capacity bucket's device state is
        # made at start(), before the sources open
        self._prewarm_enabled = False
        self._prewarm_report: Optional[Dict[str, Any]] = None

    def with_compile_cache(self, cache_dir: str) -> "PipeGraph":
        """Build the hand-written kernels' libraries (K1's fieldwise
        library and each traced combine's variant) into ``cache_dir``
        from ``start()`` on, or load them from there without ``nvcc`` when
        a current build is there, so that restarts, rescales and later
        processes reuse them. Process-wide from ``start()``, as the JAX
        package's ``jax.config`` cache is: later graphs of the process
        build there too, and a library already loaded stays loaded. A
        directory that cannot be created raises at ``start()``; a build
        never falls back to ``build/kernels/``. The C++ runtime of
        ``native/`` is not cached here (the JAX cache holds device
        programs only). No environment variable takes the place of the
        JAX package's ``WF_COMPILE_CACHE_DIR``."""
        if self._started:
            raise WindFlowError("with_compile_cache after start()")
        self._compile_cache_dir = os.fspath(cache_dir)
        return self

    def _setup_compile_cache(self) -> None:
        """``start()``: create the cache directory and point the kernel
        builds at it, before any replica loads a kernel."""
        d = self._compile_cache_dir
        if d is None:
            return
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            raise WindFlowError(
                f"with_compile_cache: cannot create {d!r}: {e}") from e
        from ..kernels import build
        build.set_cache_dir(d)

    # ------------------------------------------------------------------
    # overload protection (windflow_tpu_torch.overload)
    # ------------------------------------------------------------------
    def with_slo(self, p99_ms: float, policy: Optional[Any] = None
                 ) -> "PipeGraph":
        """Declare the graph's end-to-end p99 latency budget (ms) and
        attach the ``OverloadGovernor`` at ``start()``: when the sinks'
        windowed p99 breaches the SLO the governor walks its ladder —
        halve dispatch depths and host output batches, rescale the
        bottleneck (bounded by MAX_PAR), then admission-control the
        sources (token bucket plus the policy's shed policy) — and
        recovers with hysteresis and cooldown. ``policy`` is a
        ``GovernorPolicy`` (None = its defaults). Sources may declare
        budgets of their own (``Source_Builder.with_slo``); the tightest
        governs. Sink-side sampling turns on at 1/16 where nothing set a
        rate: the governor is blind without end-to-end samples."""
        if self._started:
            raise WindFlowError("with_slo after start()")
        if p99_ms <= 0:
            raise WindFlowError("with_slo: p99_ms must be > 0")
        self._slo_p99_ms = float(p99_ms)
        self._overload_policy = policy
        return self

    def _effective_slo_ms(self) -> Optional[float]:
        budgets = [self._slo_p99_ms] if self._slo_p99_ms else []
        budgets += [op.slo_p99_ms for op in self._ops
                    if getattr(op, "slo_p99_ms", None)]
        return min(budgets) if budgets else None

    def _setup_overload_governor(self) -> None:
        """Make the governor (started with the other control threads).
        A key_priority policy without priorities refuses here, not
        mid-surge."""
        slo_ms = self._effective_slo_ms()
        if slo_ms is None and self._overload_policy is None:
            return
        from ..overload import GovernorPolicy, OverloadGovernor
        policy = self._overload_policy
        if policy is None:
            policy = GovernorPolicy(slo_p99_ms=slo_ms)
        elif slo_ms is not None and slo_ms * 1e3 < policy.slo_us:
            policy.slo_us = slo_ms * 1e3  # a source declared tighter
        if policy.shed_policy == "key_priority":
            for op in self._ops:
                if op.op_type == OpType.SOURCE \
                        and getattr(op, "priority_fn", None) is None:
                    raise WindFlowError(
                        f"with_slo: shed policy 'key_priority' needs "
                        f"with_priority(fn) on source {op.name!r} — "
                        "records have no priority to shed by otherwise")
        self._overload_governor = OverloadGovernor(self, policy)

    def _ensure_slo_sampling(self) -> None:
        """Before the build (replica histograms are made with the
        replicas): an SLO turns on 1/16 sampling at sources and sinks
        where nothing configured a rate."""
        if self._effective_slo_ms() is None or self.latency_sample > 0:
            return
        for op in self._ops:
            if op.op_type in (OpType.SOURCE, OpType.SINK) \
                    and op.latency_sample is None:
                op.latency_sample = 16

    # ------------------------------------------------------------------
    # prewarm (every capacity bucket before the first batch)
    # ------------------------------------------------------------------
    def with_prewarm(self) -> "PipeGraph":
        """Prewarm the device plane at ``start()``, before the sources
        open: the forest-rebuild kernel's library is built or loaded, and
        every device replica makes the first allocations of every
        power-of-two capacity bucket up to the graph's largest staging
        batch (staging pools, per-bucket device buffers), so batch 0 pays
        none of it. Operators whose state depends on the stream
        (inferred schemas, key cardinality) are named in the report's
        ``skipped``. Results in ``prewarm_report`` /
        ``get_stats()["Prewarm"]``."""
        if self._started:
            raise WindFlowError("with_prewarm after start()")
        self._prewarm_enabled = True
        return self

    def _bucket_caps(self) -> List[int]:
        """Powers of two from the smallest staging bucket up to the
        largest declared output batch."""
        from ..gpu.batch import bucket_capacity
        max_obs = max((op.output_batch_size for op in self._ops),
                      default=0)
        top = bucket_capacity(max(1, max_obs))
        caps, c = [], bucket_capacity(1)
        while c <= top:
            caps.append(c)
            c <<= 1
        return caps

    def _prewarm_device_programs(self) -> None:
        if not any(getattr(op, "is_gpu", False) for op in self._ops):
            self._prewarm_report = {"bucket_caps": [],
                                    "signatures_compiled": 0,
                                    "skipped": ["no device stages"],
                                    "elapsed_s": 0.0}
            return
        t0 = time.monotonic()
        caps = self._bucket_caps()
        warmed = 0
        skipped: List[str] = []
        for s in self._stages:
            first = s.first_op
            if not getattr(first, "is_gpu", False):
                continue
            label = s.describe()
            for r in {id(r): r for r in first.replicas}.values():
                pw = getattr(r, "prewarm", None)
                if pw is None:
                    skipped.append(f"{label}: no prewarm hook "
                                   f"({type(r).__name__})")
                    continue
                n = pw(caps)
                if n is None:
                    skipped.append(f"{label}: " + getattr(
                        r, "prewarm_skip", "runtime-dependent signature "
                        "(stateful/inferred schema)"))
                else:
                    warmed += n
        # the staging edges' pinned pools, one buffer per field and bucket
        for s in self._stages:
            for r in s.last_op.replicas:
                em = r.emitter
                pw = getattr(em, "prewarm", None)
                if pw is not None:
                    pw(caps)
        self._sync_device()
        self._prewarm_report = {
            "bucket_caps": caps,
            "signatures_compiled": warmed,
            "skipped": skipped,
            "elapsed_s": round(time.monotonic() - t0, 4),
        }

    @property
    def prewarm_report(self) -> Optional[Dict[str, Any]]:
        return self._prewarm_report

    # ------------------------------------------------------------------
    # flight recorder (monitoring/flightrec.py)
    # ------------------------------------------------------------------
    def with_flight_recorder(self, events: int = 0,
                             log_dir: Optional[str] = None) -> "PipeGraph":
        """Give every worker a fixed-size single-writer ring of
        ``events`` span events (0: the 4096 default; the JAX package's
        WF_FLIGHTREC_EVENTS). Export with ``dump_trace(path)``, the
        ``MonitoringServer``'s ``GET /trace`` window, or the automatic
        post-mortem a worker crash or a stall-watchdog fire writes into
        ``log_dir`` (default: the graph's ``log_dir``)."""
        if self._started:
            raise WindFlowError("with_flight_recorder after start()")
        from ..monitoring.flightrec import DEFAULT_EVENTS
        self._flightrec_events = int(events) if events and events > 0 \
            else DEFAULT_EVENTS
        if log_dir is not None:
            self.log_dir = log_dir
        return self

    def _stage_flightrec_events(self, stage: Stage) -> int:
        """Ring capacity of one stage's workers: the largest per-op
        builder override, else the graph's (0 = off)."""
        per_op = max((op.flightrec_events or 0 for op in stage.ops),
                     default=0)
        return per_op if per_op > 0 else self._flightrec_events

    def _stage_flightrec_events_max(self) -> int:
        """Largest ring any stage runs with (the control threads size
        theirs to match; 0 = recording off)."""
        return max((self._stage_flightrec_events(s) for s in self._stages),
                   default=0)

    def trace_document(self, stacks: bool = False,
                       extra: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
        """The graph's flight rings as a Chrome trace-event document
        (empty ``traceEvents`` when no recorder is on)."""
        from ..monitoring.flightrec import thread_stacks, to_chrome_trace
        return to_chrome_trace(
            self._recorders,
            stacks=thread_stacks() if stacks else None, extra=extra)

    def dump_trace(self, path: str, stacks: bool = False) -> str:
        """Write the flight-recorder timeline as Chrome / Perfetto trace
        JSON; ``stacks=True`` adds every runtime thread's stack."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.trace_document(stacks=stacks), f)
        return path

    def _postmortem_path(self, kind: str, wname: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in f"{self.name}_{kind}_{wname}")
        return os.path.join(self.log_dir, f"{safe}.json")

    def _write_postmortem(self, kind: str, wname: str,
                          extra: Dict[str, Any]) -> None:
        """The graph's rings, every thread's stack and ``extra``; a dump
        failure never masks what it reports."""
        try:
            path = self._postmortem_path(kind, wname)
            doc = self.trace_document(stacks=True, extra=extra)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f)
            self.last_postmortem = path
        except Exception:
            pass

    def _crash_dump(self, worker, exc: BaseException) -> None:
        import traceback
        self._write_postmortem("crash", worker.name, {
            "crashedWorker": worker.name,
            "exception": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))})

    def _stall_dump(self, wname: str) -> None:
        self._write_postmortem("stall", wname, {"stalledWorker": wname})

    def _worker_diagnostics(self, names: List[str]) -> str:
        """Evidence for a checkpoint-timeout error: the named workers'
        crash tracebacks and stall-watchdog flags."""
        parts = []
        stalled = set(getattr(self._watchdog, "fired", []) or [])
        for w in self._workers:
            if w.name not in names:
                continue
            if w.error is not None:
                parts.append(f"{w.name} died: {type(w.error).__name__}: "
                             f"{w.error}")
                continue
            stats = w._stats()
            last = getattr(stats, "worker_last_error", None) if stats \
                else None
            if last:
                parts.append(f"{w.name} last error: "
                             f"{last.strip().splitlines()[-1]}")
            if w.name in stalled:
                parts.append(f"{w.name} flagged by the stall watchdog")
        return "; ".join(parts)

    # ------------------------------------------------------------------
    # stats export and the dataflow diagram (monitoring/diagram.py)
    # ------------------------------------------------------------------
    def dump_stats(self, log_dir: Optional[str] = None) -> str:
        """JSON stats and the dataflow diagram into ``log_dir`` (default
        the graph's): the dot source and an SVG always (the built-in
        renderer when no ``dot`` binary exists), a PDF when Graphviz is
        installed (``wf/pipegraph.hpp:525-534,732-734``)."""
        from ..monitoring.diagram import render_graphviz
        log_dir = self.log_dir if log_dir is None else log_dir
        os.makedirs(log_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in self.name) or "pipegraph"
        path = os.path.join(log_dir, f"{safe}_stats.json")
        with open(path, "w") as f:
            json.dump(self.get_stats(), f, indent=2)
        dot_src = self.to_dot()
        with open(os.path.join(log_dir, f"{safe}_diagram.dot"), "w") as f:
            f.write(dot_src + "\n")
        svg = render_graphviz(dot_src, "svg")
        with open(os.path.join(log_dir, f"{safe}_diagram.svg"), "wb") as f:
            f.write(svg if svg is not None else self.to_svg().encode())
        pdf = render_graphviz(dot_src, "pdf")
        if pdf is not None:
            with open(os.path.join(log_dir, f"{safe}_diagram.pdf"),
                      "wb") as f:
                f.write(pdf)
        return path

    def to_svg(self) -> str:
        """Dependency-free layered SVG of the stage DAG (the dashboard's
        diagram; ``dump_stats`` prefers Graphviz output when a binary
        exists)."""
        from ..monitoring.diagram import stages_to_svg
        return stages_to_svg(self._stages, self.name)

    def to_dot(self) -> str:
        gname = self.name.replace('"', "'")
        lines = [f'digraph "{gname}" {{', "  rankdir=LR;",
                 "  node [shape=box, style=rounded];"]
        for s in self._stages:
            label = s.describe().replace('"', "'")
            par = "|".join(str(o.parallelism) for o in s.ops)
            extra = ""
            if s.chain_refused:
                # why this stage did not fuse into its predecessor
                reason = s.chain_refused.replace('"', "'")
                extra = f"\\n[unchained: {reason}]"
            lines.append(f'  s{s.id} [label="{label}\\n({par}){extra}"];')
        for s in self._stages:
            for e in s.upstreams:
                style = ""
                if e.branch is not None:
                    style = f' [label="b{e.branch}"]'
                lines.append(f"  s{e.stage.id} -> s{s.id}{style};")
        lines.append("}")
        return "\n".join(lines)

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
                # read when the replicas are made: the stats histograms
                # and the watermark stall threshold
                op.graph_latency_sample = self.latency_sample
                op.wm_stall_sec = self.wm_stall_sec
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
        channel_cls = Channel
        if self.native_channels:
            from ..native import (NativeChannel, native_available,
                                  native_build_error)
            if not native_available():
                raise WindFlowError(
                    "PipeGraph(native_channels=True): the native runtime "
                    f"did not build: {native_build_error()}")
            channel_cls = NativeChannel
        for s in self._stages:
            if not s.is_source:
                s.channels = [channel_cls(self.channel_capacity)
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
            em = GPUStageEmitter(
                n_dests, obs, getattr(first, "schema", None),
                key_op.key_extractor,
                "keyby" if routing is RoutingMode.KEYBY else
                "broadcast" if routing is RoutingMode.BROADCAST
                else "forward",
                self.execution_mode, key_op.key_field, self.device,
                key_fields=key_op.key_fields)
            em.native = self._native_encoders
            if em.native:
                # build (or load) the encoders now, on the building
                # thread, not inside the first staged batch
                from ..native import native_available
                native_available()
            return em
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
        rec_events = self._stage_flightrec_events(stage)
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
            wname = f"{self.name}/{stage.describe()}[{i}]"
            rec = None
            if rec_events > 0:
                from ..monitoring.flightrec import FlightRecorder
                rec = FlightRecorder(rec_events, pid_label=stage.describe(),
                                     tid_label=wname)
                self._recorders.append(rec)
            w = Worker(wname, chain, channel, flightrec=rec)
            if rec is not None:
                w.on_crash = self._crash_dump
            if self._supervisor is not None:
                # supervised: a dying worker wakes the supervisor instead
                # of draining and forcing EOS
                w.on_failure = self._supervisor.note_failure
            if self.stall_sec > 0:
                w.force_idle_tick = True  # liveness ticks for the watchdog
            stage.workers.append(w)
            self._workers.append(w)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def start(self, restore_from=None) -> None:
        if self._started:
            raise WindFlowError("PipeGraph already started")
        self._validate()
        # before any replica can load a kernel
        self._setup_compile_cache()
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
        # replica histograms are made with the replicas: SLO sampling
        # first
        self._ensure_slo_sampling()
        self._build()
        if states is not None:
            self._restore_states(states)
        elif ckpt_dir is not None:
            self._restore_replicas(ckpt_dir, manifest)
        if self._prewarm_enabled:
            # every capacity bucket before any source opens
            self._prewarm_device_programs()
        # bound here, not at build: get_num_threads() may have built the
        # workers before the coordinator existed
        self._bind_workers()
        if self._coordinator is not None:
            self._coordinator.diagnose = self._worker_diagnostics
            self._coordinator.start()
        if self._supervisor is not None:
            self._capture_initial_positions()
        self._started = True
        self._t0 = time.monotonic()
        # the flight-recorder registry (MonitoringServer's /trace), the
        # stall watchdog and the dashboard reports
        from ..monitoring.flightrec import StallWatchdog, register_graph
        register_graph(self)
        if self.stall_sec > 0:
            self._watchdog = StallWatchdog(self, self.stall_sec,
                                           dump_fn=self._stall_dump)
        if self.dashboard is not None:
            from ..monitoring.monitor import MonitoringThread
            machine, port = self.dashboard
            self._monitor = MonitoringThread(self, machine, port)
            self._monitor.start()
        for w in self._workers:
            w.start()
        if self._watchdog is not None:
            self._watchdog.start()
        if self._supervisor is not None:
            self._supervisor.start()
        if self._autoscale_enabled:
            from ..scaling.autoscaler import Autoscaler
            self._autoscaler = Autoscaler(self, self._autoscale_policy)
            self._autoscaler.start()
        # the governor after the autoscaler: its SCALE rung reads the
        # autoscaler's MAX_PAR
        self._setup_overload_governor()
        if self._overload_governor is not None:
            self._overload_governor.start()

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
        if self._overload_governor is not None:
            self._overload_governor.stop()
        self.elapsed_sec = time.monotonic() - self._t0
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._coordinator is not None:
            self._coordinator.stop()
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor.join(timeout=3)
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
        if self.dashboard is not None:
            self.dump_stats()

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
        if self._overload_governor is not None:
            st["Overload"] = self._overload_governor.stats()
        if self._prewarm_report is not None:
            st["Prewarm"] = self._prewarm_report
        if self._dlq is not None:
            st["Dead_letters"] = self._dlq.total
        if self.native_channels or self._native_encoders:
            from ..native import native_state
            st["Native"] = native_state()
        # a worker that died shows its exception in the report
        errs = {w.name: f"{type(w.error).__name__}: {w.error}"
                for w in self._workers if w.error is not None}
        if errs:
            st["Worker_errors"] = errs
        return st
