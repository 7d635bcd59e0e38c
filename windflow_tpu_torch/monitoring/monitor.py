"""Monitoring thread + collection server.

The port's copy of ``windflow_tpu/monitoring/monitor.py``.

Parity: ``wf/monitoring.hpp:161-295`` — with tracing enabled the reference
spawns one thread per PipeGraph that connects over raw TCP to the Java
dashboard, sends the graph diagram once, then 1 Hz JSON stat reports.
Here the protocol is newline-delimited JSON over TCP, to the address a
graph names with ``PipeGraph(dashboard=(machine, port))`` (the JAX
package's WF_TRACING_ENABLED / WF_DASHBOARD_MACHINE / WF_DASHBOARD_PORT):

    {"type": "diagram", "graph": ..., "dot": ...}
    {"type": "report", "graph": ..., "stats": {...}}    (1 Hz)

``MonitoringServer`` is the in-tree collector (the dashboard-server
analog): it accepts those connections and keeps the latest report per
graph, queryable in-process or dumpable to JSON.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, Dict, Optional


class MonitoringThread(threading.Thread):
    """Streams diagram + 1 Hz reports to the dashboard with BOUNDED
    reconnect/backoff: a dashboard absent at startup (or restarted
    mid-run) still gets reports once it comes up — the seed behavior
    (one ``create_connection`` then give up forever) silently lost the
    whole run's telemetry to a startup race."""

    # reconnect backoff: 0.5 s doubling to a 5 s cap; retries continue
    # until the graph stops (each attempt is one cheap connect() probe)
    _BACKOFF_MIN_S = 0.5
    _BACKOFF_MAX_S = 5.0

    def __init__(self, graph, machine: str = "127.0.0.1",
                 port: int = 20300, period_sec: float = 1.0) -> None:
        super().__init__(name=f"monitor:{graph.name}", daemon=True)
        self.graph = graph
        self.machine = machine
        self.port = int(port)
        self.period = period_sec
        # NB: threading.Thread has a private _stop METHOD; don't shadow it
        self._stop_evt = threading.Event()
        self.connects = 0  # successful connections (observability/tests)

    def stop(self) -> None:
        self._stop_evt.set()

    def _connect(self) -> Optional[socket.socket]:
        try:
            return socket.create_connection((self.machine, self.port),
                                            timeout=2.0)
        except OSError:
            return None

    def run(self) -> None:
        backoff = self._BACKOFF_MIN_S
        while not self._stop_evt.is_set():
            sock = self._connect()
            if sock is None:
                # dashboard absent: back off and retry until stopped
                if self._stop_evt.wait(backoff):
                    return
                backoff = min(backoff * 2, self._BACKOFF_MAX_S)
                continue
            backoff = self._BACKOFF_MIN_S
            self.connects += 1
            try:
                f = sock.makefile("w")
                # (re)send the diagram on every connection: a freshly
                # started dashboard has no prior state
                f.write(json.dumps({"type": "diagram",
                                    "graph": self.graph.name,
                                    "dot": self.graph.to_dot(),
                                    "svg": self.graph.to_svg()}) + "\n")
                f.flush()
                while not self._stop_evt.wait(self.period):
                    f.write(json.dumps(
                        {"type": "report", "graph": self.graph.name,
                         "stats": self.graph.get_stats()}) + "\n")
                    f.flush()
                f.write(json.dumps({"type": "report",
                                    "graph": self.graph.name, "final": True,
                                    "stats": self.graph.get_stats()}) + "\n")
                f.flush()
                return  # clean final report delivered
            except OSError:
                pass  # connection lost mid-run: reconnect loop resumes
            finally:
                try:
                    sock.close()
                except OSError:
                    pass


def _prom_escape(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# (family, TYPE, HELP, stats-dict field, scale) — scalar per-replica series
_PROM_SCALARS = (
    ("windflow_inputs_received_total", "counter",
     "Tuples received by the replica", "Inputs_received", 1),
    ("windflow_outputs_sent_total", "counter",
     "Tuples sent downstream", "Outputs_sent", 1),
    ("windflow_inputs_ignored_total", "counter",
     "Tuples dropped/filtered by the replica", "Inputs_ignored", 1),
    ("windflow_punctuations_received_total", "counter",
     "Watermark punctuations received", "Punctuations_received", 1),
    ("windflow_throughput_tuples_per_second", "gauge",
     "Replica input throughput since start", "Throughput_tuples_sec", 1),
    ("windflow_service_time_ewma_usec", "gauge",
     "EWMA per-tuple service time (microseconds)", "Service_time_usec", 1),
    ("windflow_device_programs_run_total", "counter",
     "XLA programs dispatched by the replica", "Device_programs_run", 1),
    ("windflow_device_bytes_h2d_total", "counter",
     "Bytes staged host-to-device", "Device_bytes_H2D", 1),
    ("windflow_device_bytes_d2h_total", "counter",
     "Bytes fetched device-to-host", "Device_bytes_D2H", 1),
    ("windflow_dispatch_batches_total", "counter",
     "Batches through the device-ahead dispatch pipeline",
     "Dispatch_batches", 1),
    ("windflow_dispatch_stalls_total", "counter",
     "Forced ordering-point drains with commits in flight",
     "Dispatch_readback_stalls", 1),
    ("windflow_megabatch_loops_total", "counter",
     "Megabatch scan loops dispatched (K batches per loop)",
     "Megabatch_loops", 1),
    ("windflow_megabatch_batches_per_loop_avg", "gauge",
     "Mean batches retired per megabatch scan loop",
     "Megabatch_batches_per_loop_avg", 1),
    ("windflow_megabatch_max", "gauge",
     "Widest megabatch group committed by one scan dispatch",
     "Megabatch_max", 1),
    ("windflow_programs_per_batch", "gauge",
     "Device programs dispatched per prepped batch (1.0 = fused "
     "baseline, < 1.0 = megabatch amortization)",
     "Programs_per_batch", 1),
    ("windflow_ingest_blocks_total", "counter",
     "Column blocks shipped through the columnar ingest fast path",
     "Ingest_blocks", 1),
    ("windflow_ingest_rows_per_block_avg", "gauge",
     "Mean rows per ingested column block",
     "Ingest_rows_per_block_avg", 1),
    ("windflow_ingest_block_ns_per_row", "gauge",
     "Host ingest cost per row on the columnar path (nanoseconds)",
     "Ingest_block_ns_per_row", 1),
    ("windflow_queue_occupancy", "gauge",
     "Input channel occupancy (messages)", "Queue_len", 1),
    ("windflow_queue_capacity", "gauge",
     "Input channel capacity (messages)", "Queue_capacity", 1),
    ("windflow_queue_depth_max", "gauge",
     "Input channel occupancy high-water mark", "Queue_depth_max", 1),
    ("windflow_queue_blocked_put_seconds_total", "counter",
     "Producer time blocked on this full input channel (backpressure)",
     "Queue_blocked_put_usec", 1e-6),
    ("windflow_queue_blocked_get_seconds_total", "counter",
     "Consumer time blocked on this empty input channel (starvation)",
     "Queue_blocked_get_usec", 1e-6),
    ("windflow_emit_fifo_depth_max", "gauge",
     "Emitter-side pipelined FIFO high-water mark",
     "Queue_emit_fifo_depth_max", 1),
    ("windflow_worker_idle_ticks_total", "counter",
     "Worker idle-drain ticks", "Worker_idle_ticks", 1),
    ("windflow_checkpoint_snapshots_total", "counter",
     "Aligned checkpoint snapshots taken by the replica's worker",
     "Checkpoint_snapshots", 1),
    ("windflow_checkpoint_bytes_total", "counter",
     "Checkpoint blob bytes written by the replica's worker",
     "Checkpoint_bytes_total", 1),
    ("windflow_checkpoint_snapshot_seconds_total", "counter",
     "Time spent capturing checkpoint snapshots",
     "Checkpoint_snapshot_usec_total", 1e-6),
    ("windflow_checkpoint_align_stall_seconds_total", "counter",
     "Time multi-input workers stalled aligning checkpoint barriers",
     "Checkpoint_align_stall_usec_total", 1e-6),
    ("windflow_checkpoint_cut_pause_seconds", "counter",
     "Time the barrier actually fenced the worker (state cut + ack; "
     "excludes async uploads)", "Checkpoint_cut_pause_usec_total", 1e-6),
    ("windflow_sink_txn_precommits_total", "counter",
     "Exactly-once sink epochs pre-committed at the aligned barrier",
     "Sink_txn_precommits", 1),
    ("windflow_sink_txn_commits_total", "counter",
     "Exactly-once sink epochs committed on coordinator finalize",
     "Sink_txn_commits", 1),
    ("windflow_sink_txn_aborts_total", "counter",
     "Exactly-once sink epochs aborted (restore discard / replayed "
     "duplicate)", "Sink_txn_aborts", 1),
    ("windflow_sink_txn_fenced_writes_total", "counter",
     "Writes refused from stale (zombie) exactly-once sink replicas",
     "Sink_txn_fenced_writes", 1),
    ("windflow_compile_total", "counter",
     "XLA (re)trace+compiles of the replica's device programs",
     "Compile_count", 1),
    ("windflow_compile_cache_hits_total", "counter",
     "Device-program calls served by the jit compile cache",
     "Compile_cache_hits", 1),
    ("windflow_compile_seconds_total", "counter",
     "Time spent tracing+compiling device programs",
     "Compile_usec_total", 1e-6),
    ("windflow_worker_crashes_total", "counter",
     "Worker threads that died on an unhandled exception",
     "Worker_crashes", 1),
    ("windflow_dlq_records_total", "counter",
     "Poison records quarantined to the dead-letter queue "
     "(DEAD_LETTER error policy)", "Dlq_records", 1),
    ("windflow_dlq_skipped_total", "counter",
     "Records dropped by a SKIP error policy", "Dlq_skipped", 1),
    ("windflow_dlq_retries_total", "counter",
     "Record-level retry attempts under a RETRY error policy",
     "Dlq_retries", 1),
    ("windflow_kafka_reconnects_total", "counter",
     "Kafka transient-error retries/reconnects (connect/produce/consume)",
     "Kafka_reconnects", 1),
    ("windflow_shed_records_total", "counter",
     "Records shed by source admission control (overload governor)",
     "Shed_records", 1),
    ("windflow_shed_bytes_total", "counter",
     "Approximate bytes shed by source admission control",
     "Shed_bytes", 1),
    # mesh execution plane (mesh/): present only on replicas
    # that drive a device mesh (StatsRecord omits Mesh_* elsewhere, so
    # these families carry series only where a mesh exists)
    ("windflow_mesh_devices", "gauge",
     "Devices of the mesh this replica drives (0 series absent = not a "
     "mesh operator)", "Mesh_devices", 1),
    ("windflow_mesh_steps_total", "counter",
     "Sharded shard_map steps dispatched over the mesh", "Mesh_steps", 1),
    ("windflow_mesh_shuffle_bytes_total", "counter",
     "Bytes moved by the in-program all_to_all KEYBY shuffle",
     "Mesh_shuffle_bytes", 1),
    ("windflow_mesh_step_seconds_total", "counter",
     "Host-observed time dispatching sharded mesh steps",
     "Mesh_step_usec_total", 1e-6),
    ("windflow_mesh_shard_occupancy", "gauge",
     "Max key-slot occupancy of any mesh shard (block-owner mapping)",
     "Mesh_shard_occupancy", 1),
    ("windflow_mesh_shard_skew", "gauge",
     "Max/mean shard occupancy (1.0 = even key spread)",
     "Mesh_shard_skew", 1),
    ("windflow_mesh_degraded_devices", "gauge",
     "Devices this mesh replica runs WITHOUT (device-loss failover)",
     "Mesh_degraded_devices", 1),
    # tiered keyed state (state/): present only on replicas
    # with with_tiering enabled (StatsRecord omits Tier_* elsewhere)
    ("windflow_tier_hot_keys", "gauge",
     "Keys resident in the device (hot) tier of the tiered key store",
     "Tier_hot_keys", 1),
    ("windflow_tier_cold_keys", "gauge",
     "Keys spilled to the host (cold) tier of the tiered key store",
     "Tier_cold_keys", 1),
    ("windflow_tier_promotes_total", "counter",
     "Keys promoted cold -> hot (batched slot-row scatters)",
     "Tier_promotes", 1),
    ("windflow_tier_demotes_total", "counter",
     "Keys demoted hot -> cold (batched slot-row gathers)",
     "Tier_demotes", 1),
    ("windflow_tier_promote_seconds_total", "counter",
     "Host-observed time spent in batched tier promote/demote movement",
     "Tier_promote_usec_total", 1e-6),
    ("windflow_tier_miss_rate", "gauge",
     "Fraction of distinct batch keys absent from the hot tier",
     "Tier_miss_rate", 1),
    # event-time health plane: watermark progress + late-record accounting
    # (uniform across host window engines, FFAT GPU/mesh and fused chains;
    # conservation: inputs == on_time + late_admitted + late_dropped)
    ("windflow_watermark_timestamp_usec", "gauge",
     "Current watermark of the replica (event-time microseconds)",
     "Watermark_current_ts", 1),
    ("windflow_watermark_advances_total", "counter",
     "Watermark advances observed by the replica",
     "Watermark_advances", 1),
    ("windflow_watermark_lag_seconds", "gauge",
     "Wall-clock time since the replica's watermark last advanced",
     "Watermark_lag_usec", 1e-6),
    ("windflow_watermark_event_lag_seconds", "gauge",
     "Event-time gap between the max source timestamp seen and the "
     "current watermark (event-time source paths only)",
     "Watermark_event_lag_usec", 1e-6),
    ("windflow_watermark_idle", "gauge",
     "1 when no inputs arrived since the watermark last advanced "
     "(idle, not stalled)", "Watermark_idle", 1),
    ("windflow_watermark_stalls_total", "counter",
     "Watermark stall episodes: frozen past wm_stall_sec while "
     "inputs kept arriving", "Watermark_stalls", 1),
    ("windflow_late_records_total", "counter",
     "Tuples observed behind the watermark/fired-window frontier",
     "Late_records", 1),
    ("windflow_late_dropped_total", "counter",
     "Late tuples discarded (behind the allowed-lateness frontier)",
     "Late_dropped", 1),
    ("windflow_late_admitted_total", "counter",
     "Late tuples still admitted into window state (within lateness)",
     "Late_admitted", 1),
)

# per-operator merged histograms: (family, HELP, stats hist field)
_PROM_HISTS = (
    ("windflow_service_latency_usec", "Sampled per-tuple service time",
     "Latency_service_hist"),
    ("windflow_dispatch_prep_latency_usec",
     "Host-prep stage latency per device batch", "Latency_prep_hist"),
    ("windflow_dispatch_commit_latency_usec",
     "Device-commit stage latency per device batch", "Latency_commit_hist"),
    ("windflow_e2e_latency_usec",
     "Sampled end-to-end tuple latency recorded at sinks",
     "Latency_e2e_hist"),
    ("windflow_lateness_usec",
     "Observed lateness (watermark - ts) of late tuples",
     "Latency_lateness_hist"),
)


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render the latest reports as Prometheus text exposition format
    (version 0.0.4). Scalars are per-replica series; latency histograms
    are merged per operator (the replica histograms are mergeable by
    construction — monitoring/histogram.py)."""
    from .histogram import LatencyHistogram

    reports = snapshot.get("reports", {})
    lines = []
    # scalar families
    for fam, typ, help_, field, scale in _PROM_SCALARS:
        body = []
        for graph, st in reports.items():
            if not isinstance(st, dict):
                continue
            g = _prom_escape(graph)
            for op in st.get("Operators", []) or []:
                o = _prom_escape(op.get("name", "?"))
                for rep in op.get("replicas", []) or []:
                    v = rep.get(field)
                    if not isinstance(v, (int, float)):
                        continue
                    body.append(
                        f'{fam}{{graph="{g}",operator="{o}",'
                        f'replica="{int(rep.get("Replica_id", 0))}"}} '
                        f'{v * scale:g}')
        if body:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {typ}")
            lines.extend(body)
    # graph-level counters
    drop_body = []
    for graph, st in reports.items():
        if isinstance(st, dict) and isinstance(st.get("Dropped_tuples"),
                                               (int, float)):
            drop_body.append(
                f'windflow_dropped_tuples_total'
                f'{{graph="{_prom_escape(graph)}"}} '
                f'{st["Dropped_tuples"]:g}')
    if drop_body:
        lines.append("# HELP windflow_dropped_tuples_total Tuples dropped "
                     "by reordering collectors")
        lines.append("# TYPE windflow_dropped_tuples_total counter")
        lines.extend(drop_body)
    ckpt_body = []
    for graph, st in reports.items():
        ck = st.get("Checkpoints") if isinstance(st, dict) else None
        if isinstance(ck, dict) and isinstance(
                ck.get("Checkpoints_completed"), (int, float)):
            ckpt_body.append(
                f'windflow_checkpoints_completed_total'
                f'{{graph="{_prom_escape(graph)}"}} '
                f'{ck["Checkpoints_completed"]:g}')
    if ckpt_body:
        lines.append("# HELP windflow_checkpoints_completed_total Aligned "
                     "checkpoints committed by the coordinator")
        lines.append("# TYPE windflow_checkpoints_completed_total counter")
        lines.extend(ckpt_body)
    # checkpoint integrity + storage hardening (durable-recovery plane)
    _CKPT_FAMS = (
        ("windflow_ckpt_verify_failures_total", "counter",
         "Checkpoint blobs that failed sha256 verification on restore",
         "Checkpoint_verify_failures", 1),
        ("windflow_ckpt_failures_total", "counter",
         "Checkpoint epochs failed (timeout or storage write error)",
         "Checkpoint_failures", 1),
        ("windflow_ckpt_storage_failures_total", "counter",
         "Checkpoint epochs aborted by an OSError while staging blobs",
         "Checkpoint_storage_failures", 1),
        # incremental + async checkpointing (with_checkpointing(delta=,
        # async_upload=))
        ("windflow_checkpoint_delta_bytes_total", "counter",
         "Physical bytes of delta-form checkpoint blobs (dirty rows + "
         "WAL; unchanged ref'd shards cost zero)",
         "Checkpoint_delta_bytes", 1),
        ("windflow_checkpoint_async_uploads_total", "counter",
         "Background snapshot uploads completed by the coordinator's "
         "uploader", "Checkpoint_async_uploads", 1),
        ("windflow_checkpoint_async_pending", "gauge",
         "Async snapshot uploads currently in flight",
         "Checkpoint_async_pending", 1),
    )
    for fam, typ, help_, field, scale in _CKPT_FAMS:
        body = []
        for graph, st in reports.items():
            if not isinstance(st, dict):
                continue
            v = (st.get("Checkpoints") or {}).get(field)
            if isinstance(v, (int, float)):
                body.append(f'{fam}{{graph="{_prom_escape(graph)}"}} '
                            f'{v * scale:g}')
        if body:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {typ}")
            lines.extend(body)
    # elastic rescaling (scaling/): per-operator parallelism
    # gauge + per-graph rescale counters/timings so a scaling event is a
    # first-class Prometheus signal
    par_body = []
    for graph, st in reports.items():
        if not isinstance(st, dict):
            continue
        g = _prom_escape(graph)
        for op in st.get("Operators", []) or []:
            if op.get("retired"):
                continue  # mark-final replicas end series; no fresh gauge
            if isinstance(op.get("parallelism"), (int, float)):
                par_body.append(
                    f'windflow_operator_parallelism{{graph="{g}",'
                    f'operator="{_prom_escape(op.get("name", "?"))}"}} '
                    f'{op["parallelism"]:g}')
    if par_body:
        lines.append("# HELP windflow_operator_parallelism Current replica "
                     "count per operator (changes on rescale)")
        lines.append("# TYPE windflow_operator_parallelism gauge")
        lines.extend(par_body)
    _RESCALE_FAMS = (
        ("windflow_rescale_total", "counter",
         "Live rescales completed", "Rescale_events", 1),
        ("windflow_rescale_failures_total", "counter",
         "Rescale attempts that aborted", "Rescale_failures", 1),
        ("windflow_rescale_last_pause_seconds", "gauge",
         "Stop-the-world pause of the last rescale (quiesce->resume)",
         "Rescale_last_pause_s", 1),
        ("windflow_rescale_last_total_seconds", "gauge",
         "Trigger->resume duration of the last rescale",
         "Rescale_last_total_s", 1),
        ("windflow_autoscaler_decisions_total", "counter",
         "Autoscaler decisions acted on", "Autoscaler_decisions", 1),
    )
    for fam, typ, help_, field, scale in _RESCALE_FAMS:
        body = []
        for graph, st in reports.items():
            if not isinstance(st, dict):
                continue
            block = st.get("Rescales") if field.startswith("Rescale") \
                else st.get("Autoscaler")
            v = (block or {}).get(field)
            if isinstance(v, (int, float)):
                body.append(f'{fam}{{graph="{_prom_escape(graph)}"}} '
                            f'{v * scale:g}')
        if body:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {typ}")
            lines.extend(body)
    # self-healing supervision (supervision/): restart count
    # + last-event MTTR per graph, so availability is a first-class
    # Prometheus signal (alert on rate(restart_total) and on
    # restart_last_seconds spikes)
    _SUPERVISE_FAMS = (
        ("windflow_restart_total", "counter",
         "Supervised automatic restarts of the whole graph",
         "Supervision_restarts", 1),
        ("windflow_restart_last_seconds", "gauge",
         "Detect->resume duration (MTTR) of the last supervised restart",
         "Supervision_last_restart_s", 1),
        ("windflow_restart_seconds_total", "counter",
         "Cumulative detect->resume time across supervised restarts",
         "Supervision_restart_total_s", 1),
        # durable-recovery plane: fallback-ladder + device-loss signals
        ("windflow_recovery_ladder_depth", "gauge",
         "Checkpoint rungs skipped by the last supervised restore "
         "(0 = latest restored cleanly)", "Recovery_ladder_depth", 1),
        ("windflow_recovery_verify_failures_total", "counter",
         "Corrupt/unusable checkpoint rungs walked past by the "
         "fallback-ladder restore", "Recovery_verify_failures", 1),
        ("windflow_recovery_degraded_devices", "gauge",
         "Mesh devices currently excluded by the device-health probe "
         "(degraded capacity; 0 = full shape)",
         "Recovery_degraded_devices", 1),
        ("windflow_recovery_planned_restarts_total", "counter",
         "Planned supervised restarts (mesh re-expansion after a device "
         "returned)", "Supervision_planned_restarts", 1),
    )
    for fam, typ, help_, field, scale in _SUPERVISE_FAMS:
        body = []
        for graph, st in reports.items():
            if not isinstance(st, dict):
                continue
            v = (st.get("Supervision") or {}).get(field)
            if isinstance(v, (int, float)):
                body.append(f'{fam}{{graph="{_prom_escape(graph)}"}} '
                            f'{v * scale:g}')
        if body:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {typ}")
            lines.extend(body)
    # overload-protection plane (overload/): governor state
    # (0=idle 1=tune 2=scale 3=shed — alert on state==3 sustained),
    # escalation counters and the admitted-vs-offered rates that define
    # the shed fraction during an overload
    _OVERLOAD_FAMS = (
        ("windflow_overload_state", "gauge",
         "Overload-governor escalation rung (0=idle 1=tune 2=scale "
         "3=shed)", "Overload_state", 1),
        ("windflow_overload_escalations_total", "counter",
         "Overload-governor ladder escalations", "Overload_escalations", 1),
        ("windflow_overload_releases_total", "counter",
         "Overload-governor recovery releases (one rung down)",
         "Overload_releases", 1),
        ("windflow_overload_window_p99_seconds", "gauge",
         "Windowed sink-side e2e p99 the governor acted on last",
         "Overload_window_p99_usec", 1e-6),
        ("windflow_overload_slo_p99_seconds", "gauge",
         "Declared end-to-end p99 SLO", "Overload_slo_p99_usec", 1e-6),
        ("windflow_overload_admit_rate_tuples_per_second", "gauge",
         "Token-bucket admit rate while shedding (0 = not shedding)",
         "Overload_admit_rate_tps", 1),
        ("windflow_overload_offered_tuples_per_second", "gauge",
         "Offered rate at the sources (admitted + shed) last window",
         "Overload_offered_tps", 1),
        ("windflow_overload_shed_tuples_per_second", "gauge",
         "Shed rate last window", "Overload_shed_tps", 1),
    )
    for fam, typ, help_, field, scale in _OVERLOAD_FAMS:
        body = []
        for graph, st in reports.items():
            if not isinstance(st, dict):
                continue
            v = (st.get("Overload") or {}).get(field)
            if isinstance(v, (int, float)):
                body.append(f'{fam}{{graph="{_prom_escape(graph)}"}} '
                            f'{v * scale:g}')
        if body:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {typ}")
            lines.extend(body)
    # pipeline doctor (monitoring/doctor.py): bottleneck attribution over
    # tick-over-tick deltas — findings count + per-finding scores + an
    # info-style bottleneck series (verdict rides in a label; alert on
    # windflow_doctor_healthy == 0 sustained)
    doctor = snapshot.get("doctor") or {}
    dr_healthy, dr_findings, dr_scores, dr_info = [], [], [], []
    for graph, diag in doctor.items():
        if not isinstance(diag, dict):
            continue
        g = _prom_escape(graph)
        dr_healthy.append(f'windflow_doctor_healthy{{graph="{g}"}} '
                          f'{1 if diag.get("healthy") else 0}')
        finds = diag.get("findings") or []
        dr_findings.append(f'windflow_doctor_findings{{graph="{g}"}} '
                           f'{len(finds)}')
        for fnd in finds:
            o = _prom_escape(fnd.get("operator", "?"))
            v = _prom_escape(fnd.get("verdict", "?"))
            dr_scores.append(
                f'windflow_doctor_verdict_score{{graph="{g}",'
                f'operator="{o}",verdict="{v}"}} '
                f'{float(fnd.get("score", 0)):g}')
        top = diag.get("bottleneck")
        if isinstance(top, dict):
            dr_info.append(
                f'windflow_doctor_bottleneck_info{{graph="{g}",'
                f'operator="{_prom_escape(top.get("operator", "?"))}",'
                f'verdict="{_prom_escape(top.get("verdict", "?"))}"}} 1')
    for fam, typ, help_, body in (
            ("windflow_doctor_healthy", "gauge",
             "1 when the pipeline doctor found no bottleneck this tick",
             dr_healthy),
            ("windflow_doctor_findings", "gauge",
             "Doctor findings emitted for the last tick", dr_findings),
            ("windflow_doctor_verdict_score", "gauge",
             "Severity score of each doctor finding (per operator and "
             "verdict)", dr_scores),
            ("windflow_doctor_bottleneck_info", "gauge",
             "Top-ranked doctor finding (operator + verdict in labels)",
             dr_info)):
        if body:
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {typ}")
            lines.extend(body)
    # compile attribution: the LAST retrace-triggering abstract signature
    # per replica as an info-style series (the string rides in a label;
    # the retrace-storm query is rate(windflow_compile_total) paired with
    # a churning signature label here)
    sig_body = []
    for graph, st in reports.items():
        if not isinstance(st, dict):
            continue
        g = _prom_escape(graph)
        for op in st.get("Operators", []) or []:
            o = _prom_escape(op.get("name", "?"))
            for rep in op.get("replicas", []) or []:
                sig = rep.get("Compile_last_signature")
                if not sig:
                    continue
                sig_body.append(
                    f'windflow_compile_last_signature_info{{graph="{g}",'
                    f'operator="{o}",'
                    f'replica="{int(rep.get("Replica_id", 0))}",'
                    f'signature="{_prom_escape(sig)}"}} 1')
    if sig_body:
        lines.append("# HELP windflow_compile_last_signature_info Abstract "
                     "signature that triggered the replica's last XLA "
                     "retrace")
        lines.append("# TYPE windflow_compile_last_signature_info gauge")
        lines.extend(sig_body)
    # merged per-operator histograms
    for fam, help_, field in _PROM_HISTS:
        body = []
        for graph, st in reports.items():
            if not isinstance(st, dict):
                continue
            g = _prom_escape(graph)
            for op in st.get("Operators", []) or []:
                parts = [LatencyHistogram.from_sparse(rep.get(field))
                         for rep in op.get("replicas", []) or []
                         if isinstance(rep, dict) and rep.get(field)]
                if not parts:
                    continue
                h = LatencyHistogram.merged(parts)
                if h.count == 0:
                    continue
                o = _prom_escape(op.get("name", "?"))
                base = f'graph="{g}",operator="{o}"'
                for le, cum in h.cumulative_buckets():
                    if le == float("inf"):
                        continue
                    body.append(f'{fam}_bucket{{{base},le="{le:g}"}} {cum}')
                body.append(f'{fam}_bucket{{{base},le="+Inf"}} {h.count}')
                body.append(f'{fam}_sum{{{base}}} {h.sum_us:g}')
                body.append(f'{fam}_count{{{base}}} {h.count}')
        if body:
            lines.append(f"# HELP {fam} {help_} (microseconds)")
            lines.append(f"# TYPE {fam} histogram")
            lines.extend(body)
    lines.append(f"# HELP windflow_reports_total Monitoring reports "
                 f"received by this server")
    lines.append("# TYPE windflow_reports_total counter")
    lines.append(f'windflow_reports_total {snapshot.get("n_reports", 0)}')
    return "\n".join(lines) + "\n"


def _safe_diagram(svg, dot: str) -> str:
    """Diagram data arrives over an unauthenticated TCP port, so it is
    untrusted: embed the SVG only when it provably carries no active
    content, otherwise fall back to the HTML-escaped dot source. The
    checks are deliberately over-broad (reject-by-default): legitimate
    diagrams come from our own renderer or Graphviz, which emit none of
    the rejected constructs — entity references, scripts, event handlers
    (any delimiter: space, /, quote), foreignObject, or URI schemes."""
    import html as _html
    import re

    if svg:
        low = svg.lower()
        if (low.lstrip().startswith("<svg")
                and "<script" not in low
                and "&#" not in low              # numeric entities (the
                # built-in renderer escapes only &<> — see stages_to_svg)
                and "&colon" not in low
                and "<foreignobject" not in low
                and not re.search(r"""[\s/"'=]on\w+\s*=""", low)
                and not re.search(r"""(javascript|data|vbscript)\s*:""",
                                  low)):
            return svg
    return f"<pre>{_html.escape(dot)}</pre>"


class MonitoringServer:
    """Accepts monitoring connections; keeps the latest diagram/report per
    graph (the dashboard-server analog, ``dashboard/Server`` in the
    reference)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self.diagrams: Dict[str, str] = {}
        self.svgs: Dict[str, str] = {}  # rendered dataflow SVG per graph
        self.reports: Dict[str, Any] = {}
        self.n_reports = 0
        # pipeline doctor: reports arrive ~1 Hz per graph; diagnosing on
        # arrival (vs on query) gives every scrape a consistent tick delta
        from .doctor import PipelineDoctor
        self._doctor = PipelineDoctor()
        self.diagnoses: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._srv.settimeout(0.2)
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            f = conn.makefile("r")
            for line in f:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                with self._lock:
                    if msg.get("type") == "diagram":
                        self.diagrams[msg["graph"]] = msg["dot"]
                        if msg.get("svg"):
                            self.svgs[msg["graph"]] = msg["svg"]
                    elif msg.get("type") == "report":
                        self.reports[msg["graph"]] = msg["stats"]
                        self.n_reports += 1
                        try:
                            diag = self._doctor.observe(msg["graph"],
                                                        msg["stats"])
                            if diag is not None:
                                self.diagnoses[msg["graph"]] = diag
                        except Exception:
                            pass  # a malformed report must not kill intake
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"diagrams": dict(self.diagrams),
                    "svgs": dict(self.svgs),
                    "reports": dict(self.reports),
                    "doctor": dict(self.diagnoses),
                    "n_reports": self.n_reports}

    # -- web view (the reference ships a Spring+React dashboard; this is
    # the minimal in-tree equivalent: JSON API + a static HTML view) ------
    def serve_http(self, port: int = 0) -> int:
        """Start the HTTP dashboard; returns the bound port.
        GET /        -> interactive client (polls /json, live tables,
                        throughput sparkline, SVG diagram, replica
                        drill-down — the reference's React app equivalent)
        GET /json    -> full snapshot (sanitized SVGs)
        GET /graph/<name> -> one graph's latest stats
        GET /metrics -> Prometheus text exposition (counters, queue
                        gauges, per-operator latency histograms); 503
                        until the first graph report arrives
        GET /doctor  -> pipeline-doctor diagnosis per graph (ranked
                        bottleneck verdicts over the last report tick);
                        503 until two reports give a delta
        GET /trace?ms=N -> capture N ms of flight-recorder events from
                        every in-process graph, returned as Chrome
                        trace-event JSON (requires the recorder enabled
                        and the graph running in THIS process)
        GET /plain   -> server-rendered static view (no JS)"""
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                import html as _html

                esc = _html.escape
                snap = server.snapshot()
                # untrusted diagram data is sanitized for every HTML/JSON
                # consumer (the client injects the svg via innerHTML);
                # a rejected svg falls back to the escaped dot source
                snap["svgs"] = {g: _safe_diagram(s, snap["diagrams"]
                                                 .get(g, ""))
                                for g, s in snap["svgs"].items()}
                if self.path == "/":
                    from .webclient import CLIENT_HTML
                    self._send(200, CLIENT_HTML, "text/html")
                elif self.path == "/metrics":
                    if not snap["reports"]:
                        # a scraper that lands before the first report
                        # must see "not ready", not an empty-but-200
                        # exposition it would record as all-zero series
                        self._send(503, "no monitoring reports received "
                                   "yet: graph not running, or it names "
                                   "no dashboard (PipeGraph(dashboard="
                                   "...))\n",
                                   "text/plain; charset=utf-8")
                    else:
                        self._send(200, prometheus_text(snap),
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                elif self.path == "/doctor":
                    if not snap.get("doctor"):
                        # one report gives no delta to diagnose; mirror
                        # the /metrics not-ready contract
                        self._send(503, json.dumps(
                            {"error": "no diagnosis yet: need two "
                             "monitoring reports for a tick delta"}))
                    else:
                        self._send(200, json.dumps(snap["doctor"]))
                elif self.path.startswith("/trace"):
                    from urllib.parse import parse_qs, urlparse
                    from .flightrec import capture_trace
                    q = parse_qs(urlparse(self.path).query)
                    try:
                        ms = float(q.get("ms", ["100"])[0])
                    except ValueError:
                        self._send(400, json.dumps(
                            {"error": "ms must be a number"}))
                        return
                    # blocks THIS handler thread for the capture window
                    # (ThreadingHTTPServer: other endpoints stay live)
                    self._send(200, json.dumps(capture_trace(ms)))
                elif self.path == "/json":
                    self._send(200, json.dumps(snap))
                elif self.path.startswith("/graph/"):
                    name = self.path[len("/graph/"):]
                    st = snap["reports"].get(name)
                    if st is None:
                        self._send(404, json.dumps({"error": "unknown graph"}))
                    else:
                        self._send(200, json.dumps(st))
                else:  # /plain: server-rendered fallback view
                    rows = []
                    for g, st in snap["reports"].items():
                        ops = []
                        for o in st.get("Operators", []):
                            reps = o["replicas"]
                            tin = sum(r["Inputs_received"] for r in reps)
                            tout = sum(r["Outputs_sent"] for r in reps)
                            tput = sum(r.get("Throughput_tuples_sec", 0)
                                       for r in reps)
                            svc = max((r.get("Service_time_usec", 0)
                                       for r in reps), default=0)
                            dev = sum(r.get("Device_programs_run", 0)
                                      for r in reps)
                            ign = sum(r.get("Inputs_ignored", 0)
                                      for r in reps)
                            # report fields arrive over the untrusted
                            # monitoring port: escape before interpolation
                            ops.append(
                                f"<tr><td>{esc(str(o['name']))}</td>"
                                f"<td>{esc(str(o['kind']))}</td>"
                                f"<td>{int(o['parallelism'])}</td>"
                                f"<td>{tin}</td><td>{tout}</td><td>{ign}</td>"
                                f"<td>{tput:,.0f}</td><td>{svc:.1f}</td>"
                                f"<td>{dev}</td></tr>")
                        rows.append(
                            f"<h2>{esc(str(g))} <small>"
                            f"[{esc(str(st.get('Mode')))}] threads="
                            f"{int(st.get('Threads') or 0)} dropped="
                            f"{int(st.get('Dropped_tuples') or 0)}"
                            f"</small></h2>"
                            f"<table border=1 cellpadding=4 "
                            f"style='border-collapse:collapse'>"
                            f"<tr><th>op</th><th>kind</th><th>par</th>"
                            f"<th>in</th><th>out</th><th>ignored</th>"
                            f"<th>tuples/s</th><th>svc µs</th>"
                            f"<th>device progs</th></tr>"
                            + "".join(ops) + "</table>"
                            f"<details open><summary>dataflow graph</summary>"
                            + _safe_diagram(snap["svgs"].get(g),
                                            snap["diagrams"].get(g, ""))
                            + "</details>")
                    self._send(200,
                               "<html><head><meta http-equiv='refresh' "
                               "content='2'><title>windflow_tpu_torch</title>"
                               "</head><body style='font-family:monospace'>"
                               "<h1>windflow_tpu_torch dashboard</h1>"
                               + "".join(rows) + "</body></html>",
                               "text/html")

        httpd = http.server.ThreadingHTTPServer((self.host, port), Handler)
        self._httpd = httpd
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd.server_address[1]

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        httpd = getattr(self, "_httpd", None)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()  # release the bound listening socket
