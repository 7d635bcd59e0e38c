"""RestartPolicy: when and how fast the supervisor restarts the graph.

The port of ``windflow_tpu/supervision/policy.py``. The policy is pure
decision logic (no threads): the supervisor asks it for the next backoff
delay and whether another restart fits the budget. Restarts count inside
a sliding window: a graph that crashes steadily burns through the budget
and escalates, while one that crashed once long ago restarts with a fresh
budget and the shortest backoff. The port reads no environment variable:
the JAX package's ``WF_SUPERVISE_*`` knobs (``from_env``) are the
constructor's arguments.
"""

from __future__ import annotations

import random
import time
from typing import List, Optional


class RestartPolicy:
    """Jittered exponential backoff and a bounded restart budget.

    ``max_restarts`` restarts are allowed per sliding ``window_s``
    window; one more failure escalates (the supervisor gives up and the
    aggregated error surfaces in ``wait_end``). The k-th restart inside
    the window waits ``backoff_s * backoff_factor**k`` seconds, capped at
    ``backoff_max_s``, scaled by a uniform jitter in ``[1 - jitter, 1]``
    so that a fleet of supervised graphs never restarts in lockstep.
    ``restart_on_stall``: a worker the graph's stall watchdog flags
    (``PipeGraph(stall_sec=...)``) counts as a failure and restarts the
    graph like a dead one (its wedged thread is abandoned).
    """

    def __init__(self, max_restarts: int = 5, window_s: float = 300.0,
                 backoff_s: float = 0.5, backoff_max_s: float = 30.0,
                 backoff_factor: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None,
                 restart_on_stall: bool = True) -> None:
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_factor = float(backoff_factor)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.restart_on_stall = bool(restart_on_stall)
        self._rng = random.Random(seed)
        self._restarts: List[float] = []  # monotonic stamps, in-window

    # -- budget ------------------------------------------------------------
    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        self._restarts = [t for t in self._restarts if t >= cutoff]

    def allow_restart(self, now: Optional[float] = None) -> bool:
        """True when one more restart fits the in-window budget."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        return len(self._restarts) < self.max_restarts

    def note_restart(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._restarts.append(now)

    @property
    def consecutive(self) -> int:
        """Restarts currently inside the window (the backoff exponent; an
        idle window resets it)."""
        self._prune(time.monotonic())
        return len(self._restarts)

    # -- backoff -----------------------------------------------------------
    def next_backoff(self, now: Optional[float] = None) -> float:
        """Jittered delay before the NEXT restart attempt (seconds)."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        k = len(self._restarts)
        base = min(self.backoff_s * (self.backoff_factor ** k),
                   self.backoff_max_s)
        lo = base * (1.0 - self.jitter)
        return lo + self._rng.random() * (base - lo)
