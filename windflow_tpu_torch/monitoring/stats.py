"""Per-replica statistics (reference ``wf/stats_record.hpp:49-160``).

Trimmed copy of ``windflow_tpu/monitoring/stats.py``: the counters the
replicas of the ported slice write (tuples in/out, ignored tuples, the
device-plane traffic and program counts, the dispatch-pipeline split, the
watermark gauges, the unified late-record accounting, the fused-chain
and megabatch counters, the tier plane's ``Tier_*`` counters and gauges,
and the aligned checkpoints' ``Checkpoint_*`` counters). On top of those,
``rebuild_kernel_launches`` counts the launches of the hand-written
FlatFAT forest-rebuild kernel on this replica's forest, so a run can show
that the main path went through it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

_EWMA_ALPHA = 0.1


class StatsRecord:
    __slots__ = (
        "op_name", "replica_idx", "start_time",
        "inputs_received", "outputs_sent", "inputs_ignored",
        "punct_received", "punct_sent", "service_time_us",
        "device_batches_in", "device_batches_out",
        "device_bytes_h2d", "device_bytes_d2h", "device_programs_run",
        "rebuild_kernel_launches", "fused_ops",
        "megabatch_loops", "megabatch_batches", "megabatch_max",
        "dispatch_host_prep_us", "dispatch_commit_us",
        "dispatch_host_prep_total_us", "dispatch_commit_total_us",
        "dispatch_batches", "dispatch_stalls", "dispatch_depth_max",
        "ingest_blocks", "ingest_rows",
        "wm_current", "wm_advances", "wm_max_source_ts",
        "late_records", "late_dropped",
        # aligned checkpoints (runtime/worker.py:checkpoint_now): snapshots
        # taken by this worker chain, capture time, blob bytes, barrier
        # alignment stall and the barrier cut pause (capture + ack)
        "checkpoints_taken", "checkpoint_snapshot_total_us",
        "checkpoint_last_snapshot_us", "checkpoint_bytes_total",
        "checkpoint_align_total_us", "checkpoint_cut_total_us",
        "checkpoint_last_cut_us",
        # tiered keyed state (state/tiered.py): hot/cold key gauges, the
        # batched promote/demote counters with promote time, and the
        # lookup/miss counters behind Tier_miss_rate. tier_enabled marks
        # a replica whose engine runs with_tiering: to_dict omits the
        # Tier_* keys elsewhere
        "tier_enabled", "tier_hot_keys", "tier_cold_keys",
        "tier_promotes", "tier_demotes", "tier_promote_usec_total",
        "tier_lookups", "tier_misses",
        "input_channel", "pipe_depth_max", "worker_idle_ticks",
        "worker_last_error", "is_terminated",
        "_last_svc_start", "_svc_seeded", "_prep_seeded", "_commit_seeded",
    )

    def __init__(self, op_name: str = "", replica_idx: int = 0) -> None:
        self.op_name = op_name
        self.replica_idx = replica_idx
        self.start_time = time.monotonic()
        self.inputs_received = 0
        self.outputs_sent = 0
        self.inputs_ignored = 0
        self.punct_received = 0
        self.punct_sent = 0
        self.service_time_us = 0.0  # EWMA over svc() durations
        self.device_batches_in = 0
        self.device_batches_out = 0
        self.device_bytes_h2d = 0
        self.device_bytes_d2h = 0
        self.device_programs_run = 0
        self.rebuild_kernel_launches = 0
        self.fused_ops = 0  # sub-ops fused into this replica (gpu/fused_ops)
        # megabatch groups (runtime/dispatch.py + gpu/fused_ops.py): groups
        # run, batches they committed and the widest group
        self.megabatch_loops = 0
        self.megabatch_batches = 0
        self.megabatch_max = 0
        self.dispatch_host_prep_us = 0.0  # EWMA
        self.dispatch_commit_us = 0.0  # EWMA
        self.dispatch_host_prep_total_us = 0.0
        self.dispatch_commit_total_us = 0.0
        self.dispatch_batches = 0
        self.dispatch_stalls = 0  # forced ordering-point drains
        self.dispatch_depth_max = 0
        self.ingest_blocks = 0
        self.ingest_rows = 0
        self.wm_current = 0
        self.wm_advances = 0
        self.wm_max_source_ts = 0
        self.late_records = 0
        self.late_dropped = 0
        self.checkpoints_taken = 0
        self.checkpoint_snapshot_total_us = 0.0
        self.checkpoint_last_snapshot_us = 0.0
        self.checkpoint_bytes_total = 0
        self.checkpoint_align_total_us = 0.0
        self.checkpoint_cut_total_us = 0.0
        self.checkpoint_last_cut_us = 0.0
        self.tier_enabled = False
        self.tier_hot_keys = 0
        self.tier_cold_keys = 0
        self.tier_promotes = 0
        self.tier_demotes = 0
        self.tier_promote_usec_total = 0.0
        self.tier_lookups = 0
        self.tier_misses = 0
        self.input_channel = None  # wired by PipeGraph._make_workers
        self.pipe_depth_max = 0  # emitter-side FIFO high-water mark
        self.worker_idle_ticks = 0
        self.worker_last_error = ""
        self.is_terminated = False
        self._last_svc_start = 0.0
        self._svc_seeded = False
        self._prep_seeded = False
        self._commit_seeded = False

    # -- service-time recording (wf/basic_operator.hpp:134-158) -------------
    def start_svc(self) -> None:
        self._last_svc_start = time.perf_counter()

    def end_svc(self, n_tuples: int = 1) -> None:
        dt_us = (time.perf_counter() - self._last_svc_start) * 1e6
        per_tuple = dt_us / max(1, n_tuples)
        if not self._svc_seeded:
            self._svc_seeded = True
            self.service_time_us = per_tuple
        else:
            self.service_time_us += _EWMA_ALPHA * (per_tuple
                                                   - self.service_time_us)

    # -- dispatch-pipeline stages (runtime/dispatch.py) ----------------------
    def note_host_prep(self, us: float) -> None:
        self.dispatch_batches += 1
        self.dispatch_host_prep_total_us += us
        if not self._prep_seeded:
            self._prep_seeded = True
            self.dispatch_host_prep_us = us
        else:
            self.dispatch_host_prep_us += _EWMA_ALPHA * (
                us - self.dispatch_host_prep_us)

    def note_dispatch_commit(self, us: float) -> None:
        self.dispatch_commit_total_us += us
        if not self._commit_seeded:
            self._commit_seeded = True
            self.dispatch_commit_us = us
        else:
            self.dispatch_commit_us += _EWMA_ALPHA * (
                us - self.dispatch_commit_us)

    def note_dispatch_depth(self, depth: int) -> None:
        if depth > self.dispatch_depth_max:
            self.dispatch_depth_max = depth

    def note_dispatch_stall(self) -> None:
        self.dispatch_stalls += 1

    def note_megabatch(self, k: int) -> None:
        """One megabatch group: ``k`` same-signature batches committed as
        one device program (``FusedGPUReplica._run_megabatch``; its time
        lands in the dispatch commit clock)."""
        self.megabatch_loops += 1
        self.megabatch_batches += k
        if k > self.megabatch_max:
            self.megabatch_max = k

    def note_ingest_block(self, n_rows: int) -> None:
        self.ingest_blocks += 1
        self.ingest_rows += n_rows

    def note_checkpoint(self, snapshot_us: float, nbytes: int,
                        align_us: float,
                        cut_us: Optional[float] = None) -> None:
        """One aligned snapshot of this replica's worker chain: capture
        time, blob bytes written, how long barrier alignment stalled the
        chain (0 for single-input workers), and the barrier cut pause
        (barrier at the worker -> ack; the capture time when not given)."""
        if cut_us is None:
            cut_us = snapshot_us
        self.checkpoints_taken += 1
        self.checkpoint_snapshot_total_us += snapshot_us
        self.checkpoint_last_snapshot_us = snapshot_us
        self.checkpoint_bytes_total += nbytes
        self.checkpoint_align_total_us += align_us
        self.checkpoint_cut_total_us += cut_us
        self.checkpoint_last_cut_us = cut_us

    def note_late(self, n_records: int, n_dropped: int = 0) -> None:
        """Late-record accounting: ``n_records`` tuples observed behind the
        watermark / a fired boundary, ``n_dropped`` of them discarded."""
        self.late_records += n_records
        self.late_dropped += n_dropped

    # -- tiered keyed state (state/tiered.py) ---------------------------------
    def note_tier_promote(self, n_keys: int, usec: float) -> None:
        """One BATCHED promote (cold rows -> one slot-row scatter):
        ``n_keys`` keys moved hot in ``usec`` host-observed time."""
        self.tier_promotes += n_keys
        self.tier_promote_usec_total += usec

    def note_tier_demote(self, n_keys: int) -> None:
        """One BATCHED demote (slot-row gather -> cold writes)."""
        self.tier_demotes += n_keys

    def note_tier_gauges(self, hot: int, cold: int, lookups: int,
                         misses: int) -> None:
        self.tier_enabled = True
        self.tier_hot_keys = hot
        self.tier_cold_keys = cold
        self.tier_lookups = lookups
        self.tier_misses = misses

    def note_pipe_depth(self, depth: int) -> None:
        if depth > self.pipe_depth_max:
            self.pipe_depth_max = depth

    def to_dict(self) -> Dict[str, Any]:
        elapsed = max(time.monotonic() - self.start_time, 1e-9)
        ch = self.input_channel
        d = {
            "Operator_name": self.op_name,
            "Replica_id": self.replica_idx,
            "Inputs_received": self.inputs_received,
            "Outputs_sent": self.outputs_sent,
            "Inputs_ignored": self.inputs_ignored,
            "Punctuations_received": self.punct_received,
            "Punctuations_sent": self.punct_sent,
            "Service_time_usec": round(self.service_time_us, 3),
            "Throughput_tuples_sec": round(self.inputs_received / elapsed, 1),
            "Device_batches_in": self.device_batches_in,
            "Device_batches_out": self.device_batches_out,
            "Device_bytes_H2D": self.device_bytes_h2d,
            "Device_bytes_D2H": self.device_bytes_d2h,
            "Device_programs_run": self.device_programs_run,
            "Rebuild_kernel_launches": self.rebuild_kernel_launches,
            "Fused_ops": self.fused_ops,
            "Dispatch_host_prep_usec": round(self.dispatch_host_prep_us, 3),
            "Dispatch_commit_usec": round(self.dispatch_commit_us, 3),
            "Dispatch_host_prep_total_usec": round(
                self.dispatch_host_prep_total_us, 1),
            "Dispatch_commit_total_usec": round(
                self.dispatch_commit_total_us, 1),
            "Dispatch_batches": self.dispatch_batches,
            "Dispatch_readback_stalls": self.dispatch_stalls,
            "Dispatch_queue_depth_max": self.dispatch_depth_max,
            # megabatch groups (0s with megabatch off or on unfused
            # replicas); Programs_per_batch < 1.0 means groups retire
            # several batches per device program
            "Megabatch_loops": self.megabatch_loops,
            "Megabatch_batches_per_loop_avg": round(
                self.megabatch_batches / self.megabatch_loops, 2)
                if self.megabatch_loops else 0.0,
            "Megabatch_max": self.megabatch_max,
            "Programs_per_batch": round(
                self.device_programs_run / self.dispatch_batches, 3)
                if self.dispatch_batches else 0.0,
            "Ingest_blocks": self.ingest_blocks,
            "Ingest_rows": self.ingest_rows,
            "Watermark_current_ts": self.wm_current,
            "Watermark_advances": self.wm_advances,
            "Late_records": self.late_records,
            "Late_dropped": self.late_dropped,
            "Late_admitted": max(0, self.late_records - self.late_dropped),
            "Checkpoint_snapshots": self.checkpoints_taken,
            "Checkpoint_snapshot_usec_total": round(
                self.checkpoint_snapshot_total_us, 1),
            "Checkpoint_last_snapshot_usec": round(
                self.checkpoint_last_snapshot_us, 1),
            "Checkpoint_bytes_total": self.checkpoint_bytes_total,
            "Checkpoint_align_stall_usec_total": round(
                self.checkpoint_align_total_us, 1),
            "Checkpoint_cut_pause_usec_total": round(
                self.checkpoint_cut_total_us, 1),
            "Checkpoint_cut_pause_usec": round(
                self.checkpoint_last_cut_us, 1),
            "Queue_depth_max": getattr(ch, "depth_max", 0),
            "Queue_emit_fifo_depth_max": self.pipe_depth_max,
            "Worker_idle_ticks": self.worker_idle_ticks,
            "Worker_last_error": self.worker_last_error,
            "isTerminated": self.is_terminated,
        }
        if self.tier_enabled:  # with_tiering replicas only
            d["Tier_hot_keys"] = self.tier_hot_keys
            d["Tier_cold_keys"] = self.tier_cold_keys
            d["Tier_promotes"] = self.tier_promotes
            d["Tier_demotes"] = self.tier_demotes
            d["Tier_promote_usec_total"] = round(
                self.tier_promote_usec_total, 1)
            d["Tier_miss_rate"] = round(
                self.tier_misses / self.tier_lookups, 4) \
                if self.tier_lookups else 0.0
        return d
