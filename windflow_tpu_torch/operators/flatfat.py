"""FlatFAT: a flat fixed-size aggregation tree over a circular buffer
(Tangwongsan et al., VLDB'15; reference ``wf/flatfat.hpp:54-348``).

The port's copy of ``windflow_tpu/operators/flatfat.py``, the host tree of
``Ffat_Windows``: O(log n) insert and evict of sliding-window elements
with an associative, not necessarily commutative, Python combine. The
tree is an array of 2*capacity slots (capacity a power of two): leaves in
[capacity, 2*capacity), internal nodes above, ``None`` the identity. A
range query walks the iterative segment-tree decomposition with separate
left and right accumulators, so results combine in logical (insertion)
order (the reference keeps prefix/suffix arrays for the same purpose,
``flatfat.hpp:85-132``). The device twin is the forest of
``gpu/ffat_gpu.py``, rebuilt by the CUDA kernel in ``kernels/``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class FlatFAT:
    def __init__(self, capacity: int, combine: Callable[[Any, Any], Any]) -> None:
        self.capacity = next_pow2(max(2, capacity))
        self.combine = combine
        self.tree: List[Optional[Any]] = [None] * (2 * self.capacity)
        self.head = 0  # physical slot of the logical first element
        self.size = 0

    # -- updates -----------------------------------------------------------
    def _update_path(self, pos: int) -> None:
        i = (self.capacity + pos) >> 1
        while i >= 1:
            l, r = self.tree[2 * i], self.tree[2 * i + 1]
            if l is None:
                self.tree[i] = r
            elif r is None:
                self.tree[i] = l
            else:
                self.tree[i] = self.combine(l, r)
            i >>= 1

    def push(self, value: Any) -> None:
        """Append at the logical tail."""
        if self.size >= self.capacity:
            raise OverflowError("FlatFAT full")
        pos = (self.head + self.size) % self.capacity
        self.tree[self.capacity + pos] = value
        self.size += 1
        self._update_path(pos)

    def pop(self, k: int = 1) -> None:
        """Evict k elements from the logical head."""
        k = min(k, self.size)
        for _ in range(k):
            self.tree[self.capacity + self.head] = None
            self._update_path(self.head)
            self.head = (self.head + 1) % self.capacity
            self.size -= 1

    # -- queries -----------------------------------------------------------
    def _acc(self, a: Optional[Any], b: Optional[Any]) -> Optional[Any]:
        if a is None:
            return b
        if b is None:
            return a
        return self.combine(a, b)

    def _query_linear(self, lo: int, hi: int) -> Optional[Any]:
        """Ordered combine of physical leaf range [lo, hi)."""
        left: Optional[Any] = None
        right: Optional[Any] = None
        l = self.capacity + lo
        r = self.capacity + hi
        while l < r:
            if l & 1:
                left = self._acc(left, self.tree[l])
                l += 1
            if r & 1:
                r -= 1
                right = self._acc(self.tree[r], right)
            l >>= 1
            r >>= 1
        return self._acc(left, right)

    def query_logical(self, start: int, length: int) -> Optional[Any]:
        """Ordered combine of ``length`` elements beginning at logical offset
        ``start`` from the head (wrapping the circular buffer)."""
        if length <= 0 or self.size == 0:
            return None
        length = min(length, self.size - start)
        lo = (self.head + start) % self.capacity
        if lo + length <= self.capacity:
            return self._query_linear(lo, lo + length)
        first = self._query_linear(lo, self.capacity)
        second = self._query_linear(0, (lo + length) % self.capacity)
        return self._acc(first, second)

    def query_all(self) -> Optional[Any]:
        return self.query_logical(0, self.size)
