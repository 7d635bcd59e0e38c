"""Admission control at the source boundary: token bucket + shed policy.

The port's copy of ``windflow_tpu/overload/admission.py``. The gate sits inside ``SourceReplica.ship``/``ship_columns`` — BEFORE the
tuple is stamped into the emitter, before any checkpoint barrier and
before the exactly-once plane ever sees it. A shed record therefore
never enters a channel, a snapshot or a sink transaction: delivery
guarantees hold byte-identically over the ADMITTED record set, and every
shed is accounted (``Shed_records``/``Shed_bytes`` on the source
replica's stats, plus the optional JSONL audit log in
``GovernorPolicy(shed_dir=...)``, the JAX package's ``WF_SHED_DIR``).

Policies (``GovernorPolicy(shed_policy=...)``):

- ``drop_newest``     — no tokens => the INCOMING record sheds (no
  reordering, zero buffering; the classic tail-drop);
- ``drop_oldest``     — a small admission buffer absorbs bursts; on
  overflow the OLDEST buffered record sheds (freshness-biased — right
  for feeds where stale data is worthless);
- ``probabilistic``   — every record admits with probability
  ``admit_rate / offered_rate`` (EWMA-estimated), spreading the shed
  uniformly over time instead of in bursts;
- ``key_priority``    — like drop_oldest, but overflow evicts the
  LOWEST-priority buffered record (``with_priority(fn)`` on the source
  builder), so Zipf-head keys survive a shed.

The gate is installed/removed by the ``OverloadGovernor`` at runtime;
sources pay one ``is None`` check per push while it is absent.
"""

from __future__ import annotations

import random
import sys
import time
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from ..basic import WindFlowError
from ..supervision.errors import DeadLetterQueue, _safe_repr

SHED_POLICIES = ("drop_newest", "drop_oldest", "probabilistic",
                 "key_priority")


def parse_shed_policy(spec: str) -> str:
    """A policy name; unknown values refuse loudly — a typo silently
    falling back to tail-drop would shed the wrong records."""
    s = (spec or "").strip().lower()
    if s not in SHED_POLICIES:
        raise WindFlowError(
            f"unknown shed policy {spec!r} (choose from {SHED_POLICIES})")
    return s


class TokenBucket:
    """Classic token bucket over ``time.monotonic``: ``rate`` tokens/s
    refill up to ``burst``. Single-threaded per gate (the source
    replica's own thread takes; the governor's rate updates are a plain
    float store)."""

    __slots__ = ("rate", "burst", "_tokens", "_t_last")

    def __init__(self, rate: float, burst: Optional[float] = None) -> None:
        self.rate = max(0.0, float(rate))
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate * 0.05)  # ~50 ms of slack by default
        self._tokens = self.burst
        self._t_last = time.monotonic()

    def set_rate(self, rate: float, burst: Optional[float] = None) -> None:
        self.rate = max(0.0, float(rate))
        if burst is not None:
            self.burst = float(burst)
        elif self.rate > 0:
            self.burst = max(1.0, self.rate * 0.05)

    def _refill(self) -> None:
        now = time.monotonic()
        dt = now - self._t_last
        if dt > 0:
            self._t_last = now
            self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def take_up_to(self, n: int) -> int:
        """Grant as many of ``n`` whole tokens as are available (the
        columnar-push path: admit a prefix of the batch)."""
        self._refill()
        grant = min(int(n), int(self._tokens))
        if grant > 0:
            self._tokens -= grant
        return grant

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


class ShedLog(DeadLetterQueue):
    """The shed audit log: same bounded-ring + JSONL-stream machinery as
    the dead-letter queue (one ``<graph>.shed.jsonl`` file under its
    ``dir``), with a shed-record schema — what was dropped,
    where, why — so a downstream job can re-drive or bill shed traffic.

    Record schema::

        {"operator": str, "replica": int, "payload": repr, "ts": int,
         "reason": "drop_newest"|..., "wall_time": float}
    """

    _suffix = ".shed.jsonl"

    def shed(self, operator: str, replica: int, payload: Any, ts: int,
             reason: str) -> None:
        self.put_raw({
            "operator": operator,
            "replica": int(replica),
            "payload": _safe_repr(payload),
            "ts": int(ts),
            "reason": reason,
            "wall_time": time.time(),
        })


def _approx_bytes(payload: Any) -> int:
    """Cheap shed-volume estimate (``Shed_bytes`` is a capacity-planning
    signal, not an exact wire size)."""
    try:
        return sys.getsizeof(payload)
    except TypeError:  # pragma: no cover - exotic payloads
        return 64


class AdmissionGate:
    """Per-source-replica admission controller (see module doc).

    ``offer(payload, ts, wm)`` returns ``(payload, ts, wm)`` triples to
    emit NOW (possibly buffered predecessors, possibly empty); shed
    records are accounted on the replica's stats and streamed to the
    shed log before the call returns. The gate never blocks and never
    reorders admitted records (priority only decides what gets
    EVICTED). The watermark rides each record: a buffered record must
    emit with the watermark current when it was ACCEPTED — emitting it
    under whatever the stream advanced to while it waited would land it
    past downstream window closures the gate never chose to shed it
    into."""

    def __init__(self, replica, policy: str, rate_tps: float,
                 priority_fn: Optional[Callable[[Any], Any]] = None,
                 shed_log: Optional[ShedLog] = None,
                 buffer_cap: int = 64, seed: int = 0x5eed) -> None:
        self.replica = replica
        self.policy = parse_shed_policy(policy)
        if self.policy == "key_priority" and priority_fn is None:
            raise WindFlowError(
                "key_priority shedding needs with_priority(fn) on the "
                "source builder (records have no priority otherwise)")
        self.bucket = TokenBucket(rate_tps)
        self.priority_fn = priority_fn
        self.shed_log = shed_log
        self.buffer_cap = max(1, int(buffer_cap))
        self._pending: deque = deque()  # (payload, ts, wm) awaiting tokens
        # recovery: the governor flips ``released`` (pass-through mode —
        # everything admits, buffered records first) and the SOURCE
        # thread clears its own ``_gate`` reference on the next push;
        # the governor never emits on a foreign thread
        self.released = False
        self._rng = random.Random(seed)
        # offered-rate EWMA for the probabilistic policy (records/s,
        # updated per offer from inter-arrival gaps)
        self._offered_ewma = 0.0
        self._t_prev = time.monotonic()

    # -- accounting --------------------------------------------------------
    def _account(self, payload: Any, ts: int, reason: str) -> None:
        st = self.replica.stats
        st.note_shed(1, _approx_bytes(payload))
        if self.shed_log is not None:
            self.shed_log.shed(self.replica.op.name, self.replica.idx,
                               payload, ts, reason)

    # -- row path ----------------------------------------------------------
    def offer(self, payload: Any, ts: int, wm: int = 0
              ) -> List[Tuple[Any, int, int]]:
        if self.released:  # pass-through: buffered first, then incoming
            out = self.drain_pending()
            out.append((payload, ts, wm))
            return out
        pol = self.policy
        if pol == "probabilistic":
            now = time.monotonic()
            gap = now - self._t_prev
            self._t_prev = now
            inst = 1.0 / gap if gap > 1e-6 else 1e6
            self._offered_ewma += 0.05 * (inst - self._offered_ewma)
            p_admit = 1.0 if self._offered_ewma <= 0 else min(
                1.0, self.bucket.rate / self._offered_ewma)
            if self._rng.random() < p_admit:
                return [(payload, ts, wm)]
            self._account(payload, ts, "probabilistic")
            return []
        if pol == "drop_newest":
            if self.bucket.try_take():
                return [(payload, ts, wm)]
            self._account(payload, ts, "drop_newest")
            return []
        # buffered policies: drop_oldest / key_priority
        self._pending.append((payload, ts, wm))
        out: List[Tuple[Any, int, int]] = []
        while self._pending and self.bucket.try_take():
            out.append(self._pending.popleft())
        while len(self._pending) > self.buffer_cap:
            if pol == "drop_oldest":
                victim = self._pending.popleft()
            else:  # key_priority: evict the lowest-priority entry
                fn = self.priority_fn
                vi = min(range(len(self._pending)),
                         key=lambda i: fn(self._pending[i][0]))
                victim = self._pending[vi]
                del self._pending[vi]
            self._account(victim[0], victim[1], pol)
        return out

    # -- columnar fast path ------------------------------------------------
    def offer_columns(self, cols, ts_arr):
        """Admit a prefix of the column batch per available tokens (the
        per-row policies would defeat the no-per-tuple-Python contract
        of ``push_columns``); the shed suffix is accounted in one step.
        Returns ``(cols, ts_arr, n_admitted)`` — slices when partial."""
        n = len(ts_arr)
        grant = self.bucket.take_up_to(n)
        if grant >= n:
            return cols, ts_arr, n
        n_shed = n - grant
        st = self.replica.stats
        nbytes = sum(int(v[grant:].nbytes) for v in cols.values())
        st.note_shed(n_shed, nbytes)
        if self.shed_log is not None:
            self.shed_log.shed(
                self.replica.op.name, self.replica.idx,
                f"<column batch suffix: {n_shed} rows>",
                int(ts_arr[grant]) if n_shed else 0, "columns_tail")
        if grant == 0:
            return cols, ts_arr, 0
        return ({k: v[:grant] for k, v in cols.items()},
                ts_arr[:grant], grant)

    # -- lifecycle ---------------------------------------------------------
    def drain_pending(self) -> List[Tuple[Any, int, int]]:
        """Disengage: everything still buffered is ADMITTED (it was
        accepted into the gate, only awaiting tokens — shedding it on
        recovery would drop records the overload no longer forces)."""
        out = list(self._pending)
        self._pending.clear()
        return out

    def snapshot_pending(self) -> List[Tuple[Any, int, int]]:
        """The buffered records, for the source replica's checkpoint
        snapshot. They were pushed (the source cursor is past them) but
        not emitted and not shed — a restore that dropped them would
        break offered == admitted + shed. The source re-emits the
        snapshot's copy after restore; the live gate keeps its buffer."""
        return list(self._pending)

    @property
    def pending(self) -> int:
        return len(self._pending)
