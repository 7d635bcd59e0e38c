"""Autoscaler: the observe -> decide -> act policy loop.

The port of ``windflow_tpu/scaling/autoscaler.py``. It reads the signals
each replica already reports (``monitoring/stats.py``) and acts through
``PipeGraph.rescale``:

- ``Queue_blocked_put_usec``: producer time blocked on an operator's full
  input queue; the operator IS the bottleneck (backpressure);
- ``Queue_blocked_get_usec``: the operator's time blocked on its empty
  input queue; it is starved, a scale-down candidate.

Decisions are rates between snapshots taken every ``interval_s``,
debounced by ``hysteresis`` consecutive windows and separated by a
``cooldown_s`` after every action (a rescale resets counters and
perturbs the pipeline; deciding again off that transient would
oscillate). A scale-up multiplies the parallelism by ``factor`` (bounded
by ``max_parallelism``); a scale-down retreats one replica at a time.

The port reads no environment variable: the JAX package's
``WF_AUTOSCALE_*`` knobs are the arguments of ``AutoscalePolicy``, and
``WF_AUTOSCALE=1`` is ``PipeGraph.with_autoscaler``. The overload
governor's scale-down veto waits for the overload plane.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class AutoscalePolicy:
    """Pure decision logic over per-operator signal windows; testable
    without a running graph (feed ``observe`` synthetic rate dicts). The
    defaults are the JAX package's."""

    def __init__(self, interval_s: float = 1.0, cooldown_s: float = 5.0,
                 min_parallelism: int = 1, max_parallelism: int = 8,
                 up_blocked_put_ms: float = 50.0,
                 down_blocked_get_ms: float = 900.0,
                 hysteresis: int = 3, factor: float = 2.0) -> None:
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.min_parallelism = int(min_parallelism)
        self.max_parallelism = int(max_parallelism)
        self.up_blocked_put_ms = float(up_blocked_put_ms)
        self.down_blocked_get_ms = float(down_blocked_get_ms)
        self.hysteresis = int(hysteresis)
        self.factor = float(factor)
        self._up_streak: Dict[str, int] = {}
        self._down_streak: Dict[str, int] = {}
        self._last_action_t = 0.0

    def note_action(self, now: float) -> None:
        self._last_action_t = now
        self._up_streak.clear()
        self._down_streak.clear()

    def observe(self, rates: Dict[str, Dict[str, float]], now: float,
                shed_active: bool = False
                ) -> Optional[Tuple[str, int, str]]:
        """One decision step. ``rates`` maps eligible operator name ->
        ``{"parallelism", "blocked_put_ms_per_s", "blocked_get_ms_per_s",
        "tuples_per_s"}`` (per wall second). ``shed_active``: the overload
        governor sheds (or cools down after shedding) — scale-DOWN is
        vetoed, because a lull under admission control reads as
        starvation while the shed load is what the capacity absorbs.
        Returns ``(op, new_parallelism, reason)`` or None."""
        if now - self._last_action_t < self.cooldown_s:
            return None
        # scale UP the worst backpressured operator first: congestion
        # upstream masks everything downstream of it
        worst, worst_rate = None, 0.0
        for name, m in rates.items():
            r = m.get("blocked_put_ms_per_s", 0.0)
            if r >= self.up_blocked_put_ms:
                self._up_streak[name] = self._up_streak.get(name, 0) + 1
                if r > worst_rate:
                    worst, worst_rate = name, r
            else:
                self._up_streak[name] = 0
        if worst is not None \
                and self._up_streak[worst] >= self.hysteresis:
            par = int(rates[worst]["parallelism"])
            new = min(self.max_parallelism,
                      max(par + 1, int(par * self.factor + 0.5)))
            if new > par:
                return (worst, new,
                        f"backpressure {worst_rate:.0f}ms/s blocked-put "
                        f">= {self.up_blocked_put_ms:.0f}ms/s "
                        f"for {self._up_streak[worst]} windows")
        # scale DOWN a starved operator, never while anything is
        # backpressured (draining capacity under load oscillates) and
        # never while the overload governor sheds or cools down
        if shed_active:
            self._down_streak.clear()
            return None
        if worst is None:
            for name, m in sorted(rates.items()):
                par = int(m["parallelism"])
                starved = (m.get("blocked_get_ms_per_s", 0.0)
                           >= self.down_blocked_get_ms * max(1, par - 1)
                           and m.get("blocked_put_ms_per_s", 0.0) <= 1.0)
                if starved and par > self.min_parallelism:
                    self._down_streak[name] = \
                        self._down_streak.get(name, 0) + 1
                    if self._down_streak[name] >= self.hysteresis:
                        return (name, par - 1,
                                f"idle {m['blocked_get_ms_per_s']:.0f}"
                                "ms/s blocked-get for "
                                f"{self._down_streak[name]} windows")
                else:
                    self._down_streak[name] = 0
        return None


class Autoscaler(threading.Thread):
    """Policy thread: snapshots ``graph.get_stats()`` every interval,
    derives per-operator rates for the operators that can be rescaled,
    and acts on the policy's decision through ``graph.rescale``."""

    def __init__(self, graph, policy: Optional[AutoscalePolicy] = None
                 ) -> None:
        super().__init__(name=f"autoscaler:{graph.name}", daemon=True)
        self.graph = graph
        self.policy = policy or AutoscalePolicy()
        self.decisions: List[Dict[str, Any]] = []  # acted decisions
        self.errors = 0
        self.last_error: Optional[str] = None
        self._stop_evt = threading.Event()
        self._prev: Optional[Dict[str, Dict[str, float]]] = None
        self._prev_t = 0.0

    def stop(self) -> None:
        self._stop_evt.set()

    # -- signal extraction -----------------------------------------------
    def _eligible_ops(self) -> Dict[str, Any]:
        from .repartition import repartition_refusal
        return {s.first_op.name: s for s in self.graph._stages
                if all(repartition_refusal(op) is None for op in s.ops)}

    def _totals(self) -> Dict[str, Dict[str, float]]:
        st = self.graph.get_stats()
        eligible = self._eligible_ops()
        out: Dict[str, Dict[str, float]] = {}
        for op in st.get("Operators", []):
            name = op.get("name")
            if name not in eligible:
                continue
            reps = op.get("replicas", [])
            out[name] = {
                "parallelism": op.get("parallelism", 1),
                "blocked_put_usec": sum(r.get("Queue_blocked_put_usec", 0)
                                        for r in reps),
                "blocked_get_usec": sum(r.get("Queue_blocked_get_usec", 0)
                                        for r in reps),
                "inputs": sum(r.get("Inputs_received", 0) for r in reps),
            }
        return out

    def _rates(self, cur: Dict[str, Dict[str, float]], now: float
               ) -> Dict[str, Dict[str, float]]:
        prev, prev_t = self._prev, self._prev_t
        self._prev, self._prev_t = cur, now
        if prev is None or now <= prev_t:
            return {}
        dt = now - prev_t
        rates = {}
        for name, m in cur.items():
            p = prev.get(name)
            if p is None or p["parallelism"] != m["parallelism"]:
                continue  # fresh op or mid-rescale counter reset: skip
            rates[name] = {
                "parallelism": m["parallelism"],
                "blocked_put_ms_per_s":
                    max(0.0, m["blocked_put_usec"] - p["blocked_put_usec"])
                    / dt / 1e3,
                "blocked_get_ms_per_s":
                    max(0.0, m["blocked_get_usec"] - p["blocked_get_usec"])
                    / dt / 1e3 / max(1, int(m["parallelism"])),
                "tuples_per_s":
                    max(0.0, m["inputs"] - p["inputs"]) / dt,
            }
        return rates

    # -- loop --------------------------------------------------------------
    def run(self) -> None:
        while not self._stop_evt.wait(self.policy.interval_s):
            try:
                self._tick()
            except Exception as e:  # a bad tick must not kill the loop
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"

    def _tick(self) -> None:
        g = self.graph
        if g._ended:
            return
        now = time.monotonic()
        gov = getattr(g, "_overload_governor", None)
        shed_active = gov is not None and gov.blocks_scale_down(now)
        decision = self.policy.observe(self._rates(self._totals(), now),
                                       now, shed_active=shed_active)
        if decision is None:
            return
        op, new_par, reason = decision
        report = g.rescale(op, new_par)
        self.policy.note_action(time.monotonic())
        self.decisions.append({
            "t_unix": time.time(), "op": op,
            "from": report.get("old_parallelism"), "to": new_par,
            "reason": reason, "pause_s": report.get("pause_s"),
        })
        del self.decisions[:-64]

    def stats(self) -> Dict[str, Any]:
        return {
            "Autoscaler_decisions": len(self.decisions),
            "Autoscaler_errors": self.errors,
            "Autoscaler_last_error": self.last_error,
            "Autoscaler_history": list(self.decisions),
        }
