"""Key -> dense slot mapping shared by keyed device operators.

Every keyed device operator (FFAT forest, stateful map/filter scans,
keyed reduce metadata) needs the same hot operation: map a batch of keys
to dense slot ids, creating slots for unseen keys. The generic path is a
dict; the hot path for small non-negative int keys is a direct numpy
lookup table — O(n) with no per-tuple Python and no sort (the reference
keeps per-batch key maps rebuilt with device sort/unique kernels,
``keyby_emitter_gpu.hpp:518-583``; here keys are host metadata)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np


def structured_unique(keys_arr: np.ndarray, n: int):
    """``(uniq, inverse)`` for a structured (composite-key) column, or
    None when a field numpy cannot sort (object dtype) — callers then
    walk the rows as ``.tolist()`` tuples. The SINGLE definition of the
    structured dedup used by every slot-mapping path: slot identity must
    never diverge between them for the same stream."""
    try:
        return np.unique(keys_arr[:n], return_inverse=True)
    except TypeError:
        return None


def distinct_batch_keys(keys, keys_arr: np.ndarray, n: int):
    """The batch's DISTINCT keys in the same canonical hashed form each
    ``slots_of`` path registers them (python ints for int columns, tuples
    for structured rows) — the tiered store plans promotions against
    these before the vectorized slot resolution runs, so every form
    mismatch would split one stream key into two slots."""
    if not n:
        return []
    if keys_arr.ndim == 1:
        if keys_arr.dtype.kind in "iu":
            return [int(k) for k in np.unique(keys_arr[:n])]
        if keys_arr.dtype.kind == "V" and keys_arr.dtype.names:
            uu = structured_unique(keys_arr, n)
            if uu is not None:
                return [u.item() for u in uu[0]]
            return list(dict.fromkeys(keys_arr[:n].tolist()))
    it = iter(keys)
    return list(dict.fromkeys(next(it) for _ in range(n)))


class KeySlotMap:
    LUT_MAX = 1 << 22  # 16 MiB int32 ceiling for the direct table

    def __init__(self, on_new: Optional[Callable[[Any, int], None]] = None
                 ) -> None:
        self.slot_of_key: Dict[Any, int] = {}
        self._on_new = on_new  # called as on_new(key, slot) for each new key
        self._lut = None

    def __len__(self) -> int:
        return len(self.slot_of_key)

    def slot(self, key) -> int:
        s = self.slot_of_key.get(key)
        if s is None:
            s = len(self.slot_of_key)
            if self._on_new is not None:
                # on_new may refuse the key (capacity); it must run BEFORE
                # registration so a raise leaves no stale entry that a
                # caught-and-retried batch would silently reuse with an
                # out-of-range slot
                self._on_new(key, s)
            self.slot_of_key[key] = s
        return s

    # -- tiered-store slot reuse (windflow_tpu.state.tiered) ---------------
    # The tiered key store recycles slots of demoted keys, so slot ids are
    # assigned by the TIER plan, not by insertion order; these two keep the
    # dict and the int LUT consistent under out-of-order assignment.
    def assign(self, key, slot: int) -> None:
        """Register ``key`` at an explicit ``slot`` (tier promote)."""
        self.slot_of_key[key] = slot
        lut = self._lut
        if lut is not None and isinstance(key, (int, np.integer)) \
                and 0 <= key < len(lut):
            lut[key] = slot

    def evict(self, key) -> None:
        """Forget ``key`` (tier demote); its slot is the caller's to
        recycle. The LUT entry must clear too — a stale hit would route
        the key to a slot now owned by someone else."""
        self.slot_of_key.pop(key, None)
        lut = self._lut
        if lut is not None and isinstance(key, (int, np.integer)) \
                and 0 <= key < len(lut):
            lut[key] = -1

    def slots_of(self, keys, keys_arr: np.ndarray, n: int) -> np.ndarray:
        """Vectorized mapping of a whole batch; int result of length n
        (int32 on the LUT fast path — valid for indexing and promoted by
        numpy in mixed arithmetic; avoids a 16k-copy per batch). The int
        fast paths require a 1-D int array — tuple-of-int keys become a
        2-D array and must take the generic per-key path."""
        if keys_arr.ndim != 1:
            return np.fromiter((self.slot(k) for k in keys),
                               dtype=np.int64, count=n)
        if keys_arr.dtype.kind in "iu" and n:
            kmin = int(keys_arr.min())
            kmax = int(keys_arr.max())
            if 0 <= kmin and kmax < self.LUT_MAX:
                lut = self._lut
                if lut is None or kmax >= len(lut):
                    size = min(self.LUT_MAX,
                               1 << max(10, (kmax + 1).bit_length()))
                    new = np.full(size, -1, dtype=np.int32)
                    if lut is not None:
                        new[:len(lut)] = lut
                    lut = self._lut = new
                slots = lut[keys_arr]
                miss = slots < 0
                if miss.any():
                    for k in np.unique(keys_arr[miss]):
                        lut[k] = self.slot(int(k))
                    slots = lut[keys_arr]
                return slots
        if keys_arr.dtype.kind in "iu":
            uniq, inverse = np.unique(keys_arr, return_inverse=True)
            slot_map = np.fromiter((self.slot(int(k)) for k in uniq),
                                   dtype=np.int64, count=len(uniq))
            return slot_map[inverse]
        if keys_arr.dtype.kind == "V" and keys_arr.dtype.names:
            # structured (composite-key) columns: O(n log n) C sort +
            # one Python slot() per DISTINCT key. Registered as plain
            # tuples (np.void rows are unhashable and must equal the
            # tuples the per-row path extracts for the same key).
            uu = structured_unique(keys_arr, n)
            if uu is None:  # an object field: per-row over tuples
                return np.fromiter(
                    (self.slot(k) for k in keys_arr[:n].tolist()),
                    dtype=np.int64, count=n)
            uniq, inverse = uu
            slot_map = np.fromiter((self.slot(u.item()) for u in uniq),
                                   dtype=np.int64, count=len(uniq))
            return slot_map[inverse]
        return np.fromiter((self.slot(k) for k in keys),
                           dtype=np.int64, count=n)


def stable_group_argsort(vals: np.ndarray, n_groups: int) -> np.ndarray:
    """Stable argsort of small non-negative group ids. numpy's stable
    sort takes a RADIX path for <=16-bit ints only (~12x the comparison
    sort; int32/int64 both fall back to timsort, measured), so the cast
    pays off exactly when the ids fit int16."""
    if n_groups < 2**15 - 1:
        return np.argsort(vals.astype(np.int16), kind="stable")
    return np.argsort(vals, kind="stable")


def group_positions(slots: np.ndarray, n_groups: int):
    """(order, within): stable group-sort order of ``slots`` and each
    element's arrival rank WITHIN its group (the run-length grouping idiom
    shared by the grid scan and CB leaf numbering)."""
    n = len(slots)
    order = stable_group_argsort(slots, n_groups)
    ss = slots[order]
    seg_start = np.r_[True, ss[1:] != ss[:-1]] if n else np.zeros(0, bool)
    first_of = np.nonzero(seg_start)[0]
    grp = np.cumsum(seg_start) - 1
    within = np.empty(n, dtype=np.int64)
    within[order] = np.arange(n) - first_of[grp]
    return order, within
