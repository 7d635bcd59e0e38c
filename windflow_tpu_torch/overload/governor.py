"""OverloadGovernor: the SLO control loop and its escalation ladder.

The port's copy of ``windflow_tpu/overload/governor.py``. The governor
consumes three planes that already exist and closes the loop none of
them closes alone:

- the **latency plane** (PR 2/5): sink-side end-to-end latency
  histograms, diffed tick-over-tick into a WINDOWED p99 (the cumulative
  histograms would otherwise average the breach away);
- the **backpressure plane** (PR 2): per-operator
  ``Queue_blocked_put_usec`` rates name the bottleneck to scale;
- the **elastic plane** (PR 6): ``graph.rescale`` is the SCALE rung,
  bounded by the autoscaler's MAX_PAR.

Ladder (one rung per breach decision, hysteresis + cooldown between
decisions; a rung that is a structural no-op falls through to the next
within the same decision):

1. **TUNE**  — halve device dispatch-queue depths and CPU-plane output
   batch sizes (latency for throughput; restored on recovery);
2. **SCALE** — rescale the worst-backpressured eligible operator up
   (FACTOR-multiplied, bounded by MAX_PAR), synchronizing the
   autoscaler's cooldown so the two loops never double-act;
3. **SHED**  — install :class:`~.admission.AdmissionGate` on every
   source replica: token-bucket admission at the measured downstream
   capacity, AIMD-adjusted every tick (×``aimd_down`` while breached,
   ×``aimd_up`` while under), with the configured shed policy.

Recovery walks back down: ``recover_hysteresis`` consecutive
deep-under-SLO windows with the gate no longer limiting release one
rung per cooldown (gates disengage pass-through — buffered records are
admitted, never shed; tuned knobs restore last).

Interlocks: while the governor is actively shedding (or within its
cooldown), the autoscaler must not scale DOWN (post-surge lull ==
admission control working, not idle capacity) and the stall watchdog
stands down for source workers (a 100%-shed source makes no progress by
design). Both read :meth:`OverloadGovernor.blocks_scale_down` /
``.shedding``.

The JAX package's ``WF_SLO_*`` / ``WF_SHED_*`` knobs are
``GovernorPolicy``'s own fields here (``interval_s``, ``cooldown_s``,
``breach_hysteresis``, ``recover_hysteresis``, ``shed_policy``,
``shed_dir``); the graph declares the SLO with
``PipeGraph.with_slo(p99_ms, policy)``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..basic import WindFlowError
from .admission import AdmissionGate, ShedLog, parse_shed_policy

SLO_STATES = ("idle", "tune", "scale", "shed")
IDLE, TUNE, SCALE, SHED = range(4)


class GovernorPolicy:
    """Pure ladder logic over windowed (p99, shed-rate) observations;
    unit-testable without a running graph. ``observe`` returns a
    directive for the actuator: ``"escalate"``, ``"release"``,
    ``"shed_down"``, ``"shed_up"``, or None."""

    def __init__(self,
                 slo_p99_ms: Optional[float] = None,
                 interval_s: float = 0.5,
                 cooldown_s: float = 2.0,
                 breach_hysteresis: int = 2,
                 recover_hysteresis: int = 4,
                 shed_policy: str = "drop_newest",
                 recover_margin: float = 0.8,
                 shed_setpoint: float = 0.7,
                 aimd_down: float = 0.8,
                 aimd_up: float = 1.05,
                 min_rate_tps: float = 10.0,
                 shed_start_factor: float = 0.9,
                 release_shed_tps: float = 1.0,
                 max_parallelism: int = 8,
                 shed_buffer: int = 64,
                 shed_dir: Optional[str] = None) -> None:
        if slo_p99_ms is None or slo_p99_ms <= 0:
            raise WindFlowError(
                "GovernorPolicy: a positive SLO is required "
                "(with_slo(p99_ms) or GovernorPolicy(slo_p99_ms=...))")
        self.slo_us = float(slo_p99_ms) * 1e3
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.breach_hysteresis = int(breach_hysteresis)
        self.recover_hysteresis = int(recover_hysteresis)
        self.shed_policy = parse_shed_policy(shed_policy)
        self.recover_margin = float(recover_margin)
        # the shed rung regulates to setpoint*SLO, NOT to the SLO: the
        # p99 signal lags by the standing queue, so a controller aimed
        # at the limit oscillates ACROSS it — aimed below, the probing
        # sawtooth's peaks stay inside the budget
        self.shed_setpoint = float(shed_setpoint)
        self.aimd_down = float(aimd_down)
        self.aimd_up = float(aimd_up)
        self.min_rate_tps = float(min_rate_tps)
        self.shed_start_factor = float(shed_start_factor)
        self.release_shed_tps = float(release_shed_tps)
        # MAX_PAR for the SCALE rung (a running autoscaler's own wins)
        self.max_parallelism = int(max_parallelism)
        self.shed_buffer = int(shed_buffer)
        # the shed audit log's directory (None = in-memory ring only)
        self.shed_dir = shed_dir
        self.rung = IDLE  # highest engaged rung
        self._breach_streak = 0
        self._ok_streak = 0
        self._last_action_t = float("-inf")

    # -- bookkeeping -------------------------------------------------------
    def note_action(self, now: float, rung: Optional[int] = None) -> None:
        self._last_action_t = now
        self._breach_streak = 0
        self._ok_streak = 0
        if rung is not None:
            self.rung = rung

    def _cooled(self, now: float) -> bool:
        return now - self._last_action_t >= self.cooldown_s

    # -- one decision step -------------------------------------------------
    def observe(self, p99_us: Optional[float], shed_tps: float,
                now: float) -> Optional[str]:
        if p99_us is None:
            return None  # no samples and no queue: hold
        if self.rung == SHED:
            # rate regulation runs every tick — it is the shed rung's
            # steady-state behavior, not a ladder transition
            set_us = self.slo_us * self.shed_setpoint
            if p99_us > set_us:
                self._ok_streak = 0
                return "shed_down"
            self._ok_streak += 1
            if self._ok_streak >= self.recover_hysteresis \
                    and shed_tps <= self.release_shed_tps \
                    and self._cooled(now):
                return "release"
            if p99_us <= 0.5 * set_us:
                return "shed_up"
            return None
        breach = p99_us > self.slo_us
        deep_ok = p99_us <= self.recover_margin * self.slo_us
        if breach:
            self._breach_streak += 1
            self._ok_streak = 0
        elif deep_ok:
            self._ok_streak += 1
            self._breach_streak = 0
        else:  # inside the hysteresis band: hold position
            self._breach_streak = 0
            self._ok_streak = 0
            return None
        if breach and self._breach_streak >= self.breach_hysteresis \
                and self._cooled(now):
            return "escalate"
        if self.rung > IDLE and deep_ok \
                and self._ok_streak >= self.recover_hysteresis \
                and self._cooled(now):
            return "release"
        return None


class OverloadGovernor(threading.Thread):
    """Actuator thread: windows the latency plane, feeds the policy,
    walks the ladder (see module doc). Attached by
    ``PipeGraph.with_slo``."""

    def __init__(self, graph, policy: Optional[GovernorPolicy] = None
                 ) -> None:
        super().__init__(name=f"overload-governor:{graph.name}", daemon=True)
        self.graph = graph
        if policy is None:
            raise WindFlowError("OverloadGovernor needs a GovernorPolicy "
                                "(with_slo declares the SLO)")
        self.policy = policy
        self.shed_log = ShedLog(graph.name, dir=policy.shed_dir)
        self.escalations = 0  # ladder transitions upward
        self.releases = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self.history: List[Dict[str, Any]] = []  # transitions, newest last
        self.window_p99_us = 0.0
        self.admit_rate_tps = 0.0  # current per-graph token rate (shed rung)
        self.offered_tps = 0.0
        self.admitted_tps = 0.0
        self.shed_tps = 0.0
        self._stop_evt = threading.Event()
        self._gates: List[Any] = []  # engaged (replica, gate) pairs
        self._tuned: List[Any] = []  # (obj, attr, original) restore list
        self._prev_e2e: Optional[List[int]] = None
        self._prev_counts: Optional[Dict[str, float]] = None
        self._prev_t = 0.0
        # windowed blocked-put plane for the SCALE rung (sampled every
        # tick; _try_scale must rank the LIVE bottleneck, not whoever
        # accumulated the most backpressure since process start)
        self._prev_blocked: Optional[Dict[str, Dict[str, float]]] = None
        self._prev_blocked_t = 0.0
        self._blocked_rates: Dict[str, float] = {}
        self._last_shed_active_t = float("-inf")
        # the "overload" track of the flight recorder (overload:* and
        # shed:* spans)
        from ..monitoring.flightrec import ControlRing
        self._ring = ControlRing(graph, "overload", "overload-governor")

    # -- interlocks (autoscaler / stall watchdog) --------------------------
    @property
    def shedding(self) -> bool:
        """Admission gates engaged right now (stall-watchdog interlock:
        a fully shed source makes no progress by design)."""
        return bool(self._gates)

    def blocks_scale_down(self, now: Optional[float] = None) -> bool:
        """Autoscaler interlock: a scale-DOWN while shedding (or within
        the governor cooldown after) reads admission control as idle
        capacity and flaps."""
        if self.shedding:
            return True
        now = time.monotonic() if now is None else now
        return now - self._last_shed_active_t < self.policy.cooldown_s

    # -- flight recorder ---------------------------------------------------
    def _span(self, name: str, dur_us: float = 0.0, arg: Any = None) -> None:
        self._ring.span(name, dur_us, arg)

    # -- signal extraction -------------------------------------------------
    def _sink_replicas(self):
        from ..basic import OpType
        for op in self.graph._ops:
            if op.op_type == OpType.SINK:
                for r in {id(r): r for r in op.replicas}.values():
                    yield r

    def _source_replicas(self):
        from ..basic import OpType
        for op in self.graph._ops:
            if op.op_type == OpType.SOURCE:
                for r in op.replicas:
                    if hasattr(r, "_gate"):
                        yield r

    def _window_p99(self) -> Optional[float]:
        """p99 over THIS window: bucket-wise diff of the merged sink-side
        cumulative e2e histograms (rescale/restart counter resets clip to
        zero and cost one quiet window)."""
        from ..monitoring.histogram import N_BUCKETS, LatencyHistogram
        cum = [0] * N_BUCKETS
        for r in self._sink_replicas():
            h = r.stats.hist_e2e
            if h is None:
                continue
            c = h.counts
            for i in range(N_BUCKETS):
                if c[i]:
                    cum[i] += c[i]
        prev, self._prev_e2e = self._prev_e2e, cum
        if prev is None:
            return None
        win = LatencyHistogram()
        total = 0
        for i in range(N_BUCKETS):
            d = cum[i] - prev[i]
            if d > 0:
                win.counts[i] = d
                total += d
        if total == 0:
            return None
        win.count = total
        from ..monitoring.histogram import bucket_bounds
        hi_edge = 0.0
        for i in range(N_BUCKETS - 1, -1, -1):
            if win.counts[i]:
                hi_edge = bucket_bounds(i)[1]
                break
        win.max_us = hi_edge if hi_edge != float("inf") else 2 ** 40
        return win.percentile(0.99)

    def _queue_delay_us(self) -> float:
        """Instantaneous worst queue-drain estimate (Little's law:
        occupancy x per-tuple service EWMA). The windowed p99 LAGS by
        exactly the standing queue it measures; this gauge reads the
        queue being built RIGHT NOW, so the shed controller reacts a
        tick after an overshoot instead of a queue-drain later."""
        from ..basic import OpType
        worst = 0.0
        for op in self.graph._ops:
            if op.op_type == OpType.SOURCE:
                continue
            for r in {id(r): r for r in op.replicas}.values():
                ch = r.stats.input_channel
                if ch is None:
                    continue
                est = len(ch) * max(1.0, r.stats.service_time_us)
                if est > worst:
                    worst = est
        return worst

    def _window_rates(self, now: float) -> None:
        """offered/admitted/shed records per second over this window,
        from the source replicas' cumulative counters."""
        admitted = shed = 0
        for r in self._source_replicas():
            admitted += r.stats.inputs_received
            shed += r.stats.shed_records
        cur = {"admitted": float(admitted), "shed": float(shed)}
        prev, self._prev_counts = self._prev_counts, cur
        prev_t, self._prev_t = self._prev_t, now
        if prev is None or now <= prev_t:
            self.admitted_tps = self.shed_tps = self.offered_tps = 0.0
            return
        dt = now - prev_t
        self.admitted_tps = max(0.0, cur["admitted"] - prev["admitted"]) / dt
        self.shed_tps = max(0.0, cur["shed"] - prev["shed"]) / dt
        self.offered_tps = self.admitted_tps + self.shed_tps

    # -- control loop ------------------------------------------------------
    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        while not self._stop_evt.wait(self.policy.interval_s):
            try:
                self._tick()
            except Exception as e:  # a bad tick must not kill the loop
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"

    def _tick(self) -> None:
        g = self.graph
        if g._ended or g._rescaling or getattr(g, "_supervising", False):
            return
        now = time.monotonic()
        if self._gates:
            # a supervised restart or rescale rebuilds the runtime plane
            # with FRESH replicas: prune gates bound to discarded ones
            # and re-engage on the new sources while the shed rung holds
            live = {id(r) for r in self._source_replicas()}
            self._gates = [(r, gt) for r, gt in self._gates
                           if id(r) in live]
        if not self._gates and self.policy.rung == SHED:
            self._engage_shed()
        p99 = self._window_p99()
        if p99 is not None:
            self.window_p99_us = p99
        # effective latency signal: the windowed p99 OR the live
        # queue-delay estimate, whichever is worse — a pegged queue must
        # register even when the starved sink produced no samples
        q_est = self._queue_delay_us()
        p99_eff = max(p99 or 0.0, q_est)
        if p99 is None and q_est <= 0.0:
            p99_eff = None
        self._window_rates(now)
        self._window_blocked(now)
        if self.shedding or self.shed_tps > 0:
            self._last_shed_active_t = now
        directive = self.policy.observe(p99_eff, self.shed_tps, now)
        if directive == "escalate":
            self._escalate(now, p99_eff)
        elif directive == "release":
            self._release(now, p99_eff)
        elif directive == "shed_down":
            # proportional cut toward the setpoint (bounded): a 2x
            # overshoot halves in one step instead of bleeding down
            set_us = self.policy.slo_us * self.policy.shed_setpoint
            factor = max(0.5, min(self.policy.aimd_down,
                                  set_us / max(p99_eff or 1.0, 1.0)))
            self._aimd(factor)
        elif directive == "shed_up":
            # probe upward only while the bucket is the binding
            # constraint (tokens fully consumed): raising the rate when
            # DOWNSTREAM is the limiter just rebuilds the queue
            if self.admitted_tps >= 0.7 * self.admit_rate_tps:
                self._aimd(self.policy.aimd_up)

    def _note(self, kind: str, now: float, p99: Optional[float],
              detail: Any) -> None:
        self.history.append({
            "t_unix": time.time(), "event": kind,
            "state": SLO_STATES[self.policy.rung],
            "window_p99_us": round(p99 or 0.0, 1),
            "detail": detail,
        })
        del self.history[:-64]
        self._span(f"overload:{kind}", 0.0,
                   {"state": SLO_STATES[self.policy.rung],
                    "p99_us": round(p99 or 0.0, 1), "detail": detail})

    def _degraded_devices(self) -> int:
        """Devices the supervision plane is currently running WITHOUT
        (device-loss failover): read from the graph's supervisor. While
        > 0 the graph's capacity is physically reduced — TUNE and SCALE
        cannot buy it back (mesh ops refuse to rescale, and the missing
        chip is the bottleneck), so escalation jumps straight to SHED."""
        sup = getattr(self.graph, "_supervisor", None)
        return int(getattr(sup, "degraded_devices", 0) or 0) \
            if sup is not None else 0

    # -- escalation ladder -------------------------------------------------
    def _escalate(self, now: float, p99: Optional[float]) -> None:
        pol = self.policy
        degraded = self._degraded_devices()
        if degraded > 0:
            # degraded mesh capacity: shed immediately instead of
            # silently overloading the surviving devices
            try:
                self._engage_shed()
            except WindFlowError as e:
                self.last_error = f"shed rung (degraded): {e}"
                return
            pol.note_action(now, SHED)
            self.escalations += 1
            self._note("escalate", now, p99,
                       f"shed (mesh degraded by {degraded} device(s))")
            return
        if pol.rung < TUNE and self._try_tune():
            pol.note_action(now, TUNE)
            self.escalations += 1
            self._note("escalate", now, p99, "tune")
            return
        if pol.rung < SHED and self._try_scale():
            pol.note_action(now, SCALE)
            self.escalations += 1
            self._note("escalate", now, p99, "scale")
            return
        self._engage_shed()
        pol.note_action(now, SHED)
        self.escalations += 1
        self._note("escalate", now, p99, "shed")

    def _release(self, now: float, p99: Optional[float]) -> None:
        pol = self.policy
        if pol.rung == SHED:
            self._disengage_shed()
            pol.note_action(now, SCALE)
        elif pol.rung == SCALE:
            # scale-DOWN is the autoscaler's decision (with our
            # interlock); the governor only releases its claim
            pol.note_action(now, TUNE)
        elif pol.rung == TUNE:
            self._restore_tuned()
            pol.note_action(now, IDLE)
        self.releases += 1
        self._note("release", now, p99, SLO_STATES[pol.rung])

    # -- rung 1: tune ------------------------------------------------------
    @staticmethod
    def _tier_stores(r) -> list:
        """Every TieredKeyStore a replica hosts: the single-card engine's
        (``r.engine.tier``), the mesh replica's (``r._tier``), or one per
        stateful slot of a fused chain (``r.specs[i].engine.tier``)."""
        engines = [getattr(r, "engine", None)]
        engines += [getattr(sp, "engine", None)
                    for sp in getattr(r, "specs", ()) or ()]
        stores = [e.tier for e in engines
                  if e is not None and getattr(e, "tier", None) is not None]
        if getattr(r, "_tier", None) is not None:
            stores.append(r._tier)
        return stores

    def _try_tune(self) -> bool:
        """Halve device dispatch depths and CPU-plane output batch sizes
        (recorded for restore). Returns False when there was nothing to
        tune — the ladder then falls through to SCALE."""
        touched = False
        for op in self.graph._ops:
            for r in {id(r): r for r in op.replicas}.values():
                dq = getattr(r, "dispatch", None)
                if dq is not None and dq.depth > 0:
                    self._tuned.append((dq, "depth", dq.depth))
                    dq.depth = dq.depth // 2
                    touched = True
                for tstore in self._tier_stores(r):
                    # tiering lever: shrink the hot tier toward its floor
                    # BEFORE the ladder reaches SHED — demotions free
                    # device memory at the cost of cold misses, which is
                    # still cheaper than dropping tuples
                    cur = int(tstore.target_hot_capacity)
                    nxt = max(tstore.min_hot, cur // 2)
                    if nxt < cur:
                        self._tuned.append(
                            (tstore, "target_hot_capacity", cur))
                        tstore.target_hot_capacity = nxt
                        touched = True
                em = getattr(r, "emitter", None)
                # host-plane emitters only: a device staging emitter's
                # batch sets the capacity bucket the prewarm built for
                if em is not None \
                        and type(em).__module__.endswith("runtime.emitters") \
                        and getattr(em, "output_batch_size", 0) > 1:
                    self._tuned.append((em, "output_batch_size",
                                        em.output_batch_size))
                    em.output_batch_size = max(1, em.output_batch_size // 2)
                    touched = True
        return touched

    def _restore_tuned(self) -> None:
        for obj, attr, orig in reversed(self._tuned):
            try:
                setattr(obj, attr, orig)
            except Exception:
                pass  # a replaced replica's knob is gone; harmless
        self._tuned = []

    # -- rung 2: scale -----------------------------------------------------
    def _eligible_totals(self) -> Dict[str, Dict[str, float]]:
        """Cumulative blocked-put totals for rescalable stages (the raw
        counters; ``_window_blocked`` diffs them tick-over-tick into the
        rates the SCALE rung actually ranks by)."""
        from ..scaling.repartition import repartition_refusal
        out: Dict[str, Dict[str, float]] = {}
        for s in self.graph._stages:
            if any(repartition_refusal(op) is not None for op in s.ops):
                continue
            op = s.first_op
            reps = {id(r): r for r in op.replicas}.values()
            blocked = 0.0
            for r in reps:
                ch = r.stats.input_channel
                if ch is not None:
                    blocked += getattr(ch, "blocked_put_ns", 0) / 1e3
            out[op.name] = {"parallelism": s.parallelism,
                            "blocked_put_usec": blocked}
        return out

    def _window_blocked(self, now: float) -> None:
        """Blocked-put usec/s per eligible stage over THIS window
        (tick-over-tick diff, the autoscaler's idiom): an operator with
        large historical backpressure but no current congestion must
        not outrank the live bottleneck."""
        cur = self._eligible_totals()
        prev, self._prev_blocked = self._prev_blocked, cur
        prev_t, self._prev_blocked_t = self._prev_blocked_t, now
        if prev is None or now <= prev_t:
            self._blocked_rates = {}
            return
        dt = now - prev_t
        rates: Dict[str, float] = {}
        for name, m in cur.items():
            p = prev.get(name)
            if p is None or p["parallelism"] != m["parallelism"]:
                continue  # fresh op or mid-rescale counter reset: skip
            rates[name] = max(
                0.0, m["blocked_put_usec"] - p["blocked_put_usec"]) / dt
        self._blocked_rates = rates

    def _try_scale(self) -> bool:
        g = self.graph
        if g._coordinator is None:
            return False  # rescale needs the checkpoint plane
        auto = getattr(g, "_autoscaler", None)
        max_par = auto.policy.max_parallelism if auto is not None \
            else self.policy.max_parallelism
        totals = self._eligible_totals()
        win = self._blocked_rates
        cand = []
        for name, m in totals.items():
            par = int(m["parallelism"])
            if par >= max_par:
                continue
            # windowed rate once a full tick exists; before the first
            # window the cumulative total is the only signal there is
            blocked = win[name] if name in win \
                else (0.0 if win else m["blocked_put_usec"])
            cand.append((blocked, name, par))
        if not cand:
            return False  # scale-out exhausted: the shed rung is next
        cand.sort(reverse=True)
        blocked, name, par = cand[0]
        if blocked <= 0:
            return False  # nothing backpressured: scaling would not help
        new = min(max_par, max(par + 1, par * 2))
        try:
            self._span("overload:rescale", 0.0, {"op": name, "to": new})
            g.rescale(name, new)
        except WindFlowError as e:
            self.last_error = f"scale rung: {e}"
            return False
        if auto is not None:
            # one surge, one reaction: the autoscaler must not stack its
            # own decision on the transient our rescale just caused
            auto.policy.note_action(time.monotonic())
        return True

    # -- rung 3: shed ------------------------------------------------------
    def _engage_shed(self) -> None:
        if self._gates:
            return
        replicas = list(self._source_replicas())
        if not replicas:
            raise WindFlowError("overload governor: no gateable sources")
        if self.admit_rate_tps > 0:
            # re-engage after a supervised restart/rescale (gates
            # pruned, rung still SHED): reuse the rate the AIMD loop
            # had converged to — the windowed counters rewound with the
            # replicas, so admitted_tps is zero/stale this tick and
            # deriving from it would collapse the admit rate to the
            # floor and over-shed until the slow probe recovers
            rate = max(self.policy.min_rate_tps, self.admit_rate_tps)
        else:
            # first engagement: admit rate = measured downstream
            # capacity (the admitted throughput while breached IS what
            # the graph absorbs), derated
            rate = max(self.policy.min_rate_tps,
                       self.admitted_tps * self.policy.shed_start_factor)
        self.admit_rate_tps = rate
        per = rate / len(replicas)
        for r in replicas:
            gate = AdmissionGate(
                r, self.policy.shed_policy, per,
                priority_fn=getattr(r.op, "priority_fn", None),
                shed_log=self.shed_log,
                buffer_cap=self.policy.shed_buffer,
                seed=0x5eed ^ r.idx)
            self._gates.append((r, gate))
            r._gate = gate
        self._span("shed:engage", 0.0,
                   {"rate_tps": round(rate, 1),
                    "policy": self.policy.shed_policy,
                    "sources": len(replicas)})

    def _aimd(self, factor: float) -> None:
        if not self._gates:
            return
        rate = max(self.policy.min_rate_tps, self.admit_rate_tps * factor)
        self.admit_rate_tps = rate
        per = rate / len(self._gates)
        for _, gate in self._gates:
            gate.bucket.set_rate(per)
        self._span("shed:rate", 0.0, {"rate_tps": round(rate, 1),
                                      "shed_tps": round(self.shed_tps, 1)})

    def _disengage_shed(self) -> None:
        # pass-through release: the SOURCE thread drains any buffered
        # records on its next push (or at end-of-stream) and clears the
        # gate itself — the governor never emits on a foreign thread
        for _, gate in self._gates:
            gate.released = True
        self._gates = []
        self.admit_rate_tps = 0.0
        self._span("shed:disengage")

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        shed_records = shed_bytes = 0
        for r in self._source_replicas():
            shed_records += r.stats.shed_records
            shed_bytes += r.stats.shed_bytes
        return {
            "Overload_state": self.policy.rung,
            "Overload_state_name": SLO_STATES[self.policy.rung],
            "Overload_slo_p99_usec": round(self.policy.slo_us, 1),
            "Overload_window_p99_usec": round(self.window_p99_us, 1),
            "Overload_escalations": self.escalations,
            "Overload_releases": self.releases,
            "Overload_shedding": self.shedding,
            "Overload_admit_rate_tps": round(self.admit_rate_tps, 1),
            "Overload_offered_tps": round(self.offered_tps, 1),
            "Overload_admitted_tps": round(self.admitted_tps, 1),
            "Overload_shed_tps": round(self.shed_tps, 1),
            "Overload_shed_records": shed_records,
            "Overload_shed_bytes": shed_bytes,
            "Overload_errors": self.errors,
            "Overload_last_error": self.last_error,
            "Overload_degraded_devices": self._degraded_devices(),
            "Overload_history": list(self.history),
        }
