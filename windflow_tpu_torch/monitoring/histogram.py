"""Fixed-bucket log2 latency histogram (HDR-style).

Copy of ``windflow_tpu/monitoring/histogram.py`` (same buckets, so the
two packages' histograms merge and compare bucket for bucket).

The reference's observability stops at EWMA service times
(``wf/stats_record.hpp``); distribution-level latency needs a histogram
that is (a) O(1) to record with no allocation on the hot path, (b)
single-writer lock-free — each replica owns its own instance and only
its worker thread records, while the monitoring thread reads a possibly
slightly-stale snapshot (the GIL makes the int reads safe), and (c)
mergeable across replicas so per-operator percentiles exist.

Bucket layout (HDR idea, base 2): values are microseconds rounded down
to int. The first ``2**SUB_BITS`` values get exact unit buckets; above
that each power-of-two octave is split into ``2**SUB_BITS`` linear
sub-buckets, so the relative bucket width is bounded by
``1 / 2**SUB_BITS`` (25% at SUB_BITS=2) at every magnitude. The top
bucket absorbs overflow (> ~2^39 µs ≈ 6 days).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

SUB_BITS = 2
_SUB = 1 << SUB_BITS  # sub-buckets per octave
_MAX_EXP = 36  # octaves above the linear range
N_BUCKETS = (_MAX_EXP + 1) * _SUB  # 148 (last bucket = overflow)


def bucket_index(us: int) -> int:
    """Bucket of a non-negative integer microsecond value."""
    if us < _SUB:
        return us if us >= 0 else 0
    e = us.bit_length() - 1 - SUB_BITS
    if e >= _MAX_EXP:
        return N_BUCKETS - 1
    return ((e + 1) << SUB_BITS) | ((us >> e) & (_SUB - 1))


def bucket_bounds(idx: int) -> tuple:
    """[lo, hi) microsecond range covered by bucket ``idx``."""
    if idx < _SUB:
        return idx, idx + 1
    e = (idx >> SUB_BITS) - 1
    sub = idx & (_SUB - 1)
    lo = (_SUB + sub) << e
    if idx == N_BUCKETS - 1:
        return lo, float("inf")
    return lo, lo + (1 << e)


class LatencyHistogram:
    """Log2 HDR-style histogram over microsecond latencies."""

    __slots__ = ("counts", "count", "sum_us", "max_us")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.sum_us = 0.0
        self.max_us = 0.0

    # -- hot path (single writer) ------------------------------------------
    def record(self, us: float) -> None:
        if us < 0:
            us = 0.0
        self.counts[bucket_index(int(us))] += 1
        self.count += 1
        self.sum_us += us
        if us > self.max_us:
            self.max_us = us

    def record_many(self, us_arr) -> None:
        """Vectorized ``record`` for batched engines (FFAT GPU/mesh late
        masks): one bucket computation over a numpy array instead of a
        Python loop per row. Bucket math mirrors ``bucket_index`` —
        ``frexp`` gives bit_length for the octave (exact for the int64
        microsecond range, which sits far below float64's 2^53)."""
        import numpy as np
        us = np.maximum(np.asarray(us_arr).astype(np.int64, copy=False), 0)
        n = int(us.size)
        if n == 0:
            return
        e = np.frexp(us.astype(np.float64))[1] - 1 - SUB_BITS
        e_safe = np.maximum(e, 0)
        idx = ((e_safe + 1) << SUB_BITS) | ((us >> e_safe) & (_SUB - 1))
        idx = np.where(us < _SUB, us, idx)
        idx = np.where(e >= _MAX_EXP, N_BUCKETS - 1, idx)
        binned = np.bincount(idx, minlength=N_BUCKETS)
        c = self.counts
        for i in np.flatnonzero(binned):
            c[i] += int(binned[i])
        self.count += n
        self.sum_us += float(us.sum())
        m = float(us.max())
        if m > self.max_us:
            self.max_us = m

    # -- reading -----------------------------------------------------------
    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile (nearest-rank
        over bucket counts); exact max for q at/above the last sample."""
        n = self.count
        if n == 0:
            return 0.0
        rank = max(1, int(q * n + 0.9999999999))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                lo, hi = bucket_bounds(i)
                if hi == float("inf") or hi > self.max_us:
                    return float(self.max_us)
                return float(hi)
        return float(self.max_us)

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p90(self) -> float:
        return self.percentile(0.90)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    # -- merge / transport --------------------------------------------------
    def merge_from(self, other: "LatencyHistogram") -> None:
        oc = other.counts
        c = self.counts
        for i in range(N_BUCKETS):
            if oc[i]:
                c[i] += oc[i]
        self.count += other.count
        self.sum_us += other.sum_us
        if other.max_us > self.max_us:
            self.max_us = other.max_us

    @classmethod
    def merged(cls, parts: Iterable["LatencyHistogram"]) -> "LatencyHistogram":
        out = cls()
        for p in parts:
            out.merge_from(p)
        return out

    def to_sparse(self) -> Dict[str, object]:
        """Wire form for stats reports: only occupied buckets travel."""
        return {
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
            "count": self.count,
            "sum_us": round(self.sum_us, 1),
            "max_us": round(self.max_us, 1),
        }

    @classmethod
    def from_sparse(cls, d: Optional[dict]) -> "LatencyHistogram":
        h = cls()
        if not d:
            return h
        for k, c in (d.get("counts") or {}).items():
            try:
                i, c = int(k), int(c)
            except (TypeError, ValueError):
                continue  # reports arrive over an untrusted port
            if 0 <= i < N_BUCKETS and c > 0:
                h.counts[i] += c
        h.count = max(0, int(d.get("count", 0) or 0))
        try:
            h.sum_us = float(d.get("sum_us", 0.0) or 0.0)
            h.max_us = float(d.get("max_us", 0.0) or 0.0)
        except (TypeError, ValueError):
            pass
        return h

    def cumulative_buckets(self) -> List[tuple]:
        """Prometheus-shape ``(le_bound_usec, cumulative_count)`` pairs,
        occupied prefix only (+inf handled by the caller via count)."""
        out = []
        acc = 0
        top = 0
        for i, c in enumerate(self.counts):
            if c:
                top = i
        for i in range(top + 1):
            acc += self.counts[i]
            lo, hi = bucket_bounds(i)
            if self.counts[i]:
                out.append((hi, acc))
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<LatencyHistogram n={self.count} p50={self.p50:.0f}us "
                f"p99={self.p99:.0f}us max={self.max_us:.0f}us>")
