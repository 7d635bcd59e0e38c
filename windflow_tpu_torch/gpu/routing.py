"""Keyby routing of the device plane: the destination of a key, per row
and vectorized over a key column, with one answer for both forms.

Copy of the key-routing helpers of ``windflow_tpu/tpu/emitters_tpu.py``
(composite multi-field keys are not ported). Every keyed edge into or
between device operators routes with these: the CPU -> device staging
emitter (rows and column blocks) and the device -> device re-shard, so a
key reaches the same replica whichever way its tuples travel.
"""

from __future__ import annotations

import datetime as _dt
from itertools import islice
from typing import Optional, Sequence, Union

import numpy as np

_HASH_MODULUS = (1 << 61) - 1  # CPython hash(n) == n iff 0 <= n < 2^61-1
_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_M64 = 0xFFFFFFFFFFFFFFFF


def _column_hashes(col: np.ndarray, n: int) -> Optional[np.ndarray]:
    """Per-row uint64 hash lanes for a key (or key-element) column, or
    None when the dtype has no vectorized representation (object columns
    take the per-row path). int/uint/bool hash as their two's-complement
    uint64 value, floats as their float64 bit pattern, str/bytes ('U'/'S')
    as zero-skipping FNV-1a over codepoint/byte lanes (invariant to the
    dtype's zero padding — the same key must route identically when two
    batches of one stream infer different fixed widths), and structured
    (void) rows as an ordered FNV fold over their fields. Each case
    matches its scalar twin in ``_scalar_elem_hash`` EXACTLY: a source
    may mix push() and push_columns() on one stream, and a key's tuples
    must all reach the same replica. NOT CPython-hash-compatible, which
    is fine: keyby routing needs a deterministic, balanced key->dest map
    per edge, not a globally blessed hash (the reference's
    ``keyby_emitter.hpp:210-228`` likewise only needs std::hash
    determinism). Cost is O(n * key_width) vectorized numpy passes.
    (Tried and rejected: np.unique + one hash per distinct key — the
    C string sort alone costs more than these passes.)"""
    kind = col.dtype.kind
    if kind in "iub":
        return col[:n].astype(np.uint64)
    if kind == "f":
        # EQUALITY-COMPATIBLE float hash: keys equal under Python/dict
        # equality must route identically (CPython guarantees
        # hash(1) == hash(1.0) and hash(0.0) == hash(-0.0), and the
        # KeySlotMap dict unifies them), so integral floats hash as
        # their int value (which also normalizes -0.0 to 0) and only
        # non-integral values use their float64 bit pattern. |v| >= 2^63
        # stays on the bit pattern (int64-representable bound, matching
        # _scalar_elem_hash; an int key equal to such a float is the one
        # remaining — astronomically rare — split).
        f64 = col[:n].astype(np.float64)
        with np.errstate(invalid="ignore"):
            integral = (f64 == np.floor(f64)) & (np.abs(f64) < 2.0**63)
        iv = np.where(integral, f64, 0).astype(np.int64).astype(np.uint64)
        return np.where(integral, iv, f64.view(np.uint64))
    if kind in "Mm":
        # datetime64/timedelta64: hash the int64 of the SAME unit the
        # value materializes to on the row path (.item(), and the
        # scalar twin's np.datetime64(date)->'D' / (datetime)->'us' /
        # np.timedelta64(timedelta)->'us' conversions) — date-valued
        # units normalize to days, time-valued to microseconds, and
        # units .item() leaves as raw ints (ns and finer; 'Y'/'M'
        # timedeltas) hash raw. Without this, an 'M8[s]' column and its
        # own rows would route one key to two replicas. Values the row
        # path does NOT materialize as date/datetime/timedelta — NaT
        # (.item() -> None), unit-conversion overflow, instants beyond
        # the datetime range (.item() -> raw int in the SOURCE unit) —
        # push the whole batch to the per-row path instead, which
        # hashes the .item()ed tuples consistently with push() rows.
        unit = np.datetime_data(col.dtype)[0]
        # native byte order first (like the 'U'/'S' branch): a '>M8'
        # column would hash byte-swapped on the raw-view path below
        c = col[:n].astype(col.dtype.newbyteorder("="), copy=False)
        if np.isnat(c).any():
            return None
        canon = lo = hi = None
        if kind == "M":
            if unit in ("Y", "M", "W", "D"):
                canon, lo, hi = "M8[D]", -719162, 2932896  # date range
            elif unit in ("h", "m", "s", "ms", "us"):
                canon = "M8[us]"                     # datetime range, us
                lo, hi = -62135596800000000, 253402300799999999
        elif unit in ("W", "D", "h", "m", "s", "ms", "us"):
            canon = "m8[us]"  # every in-int64 us value is a timedelta
        if canon is None:
            return c.view(np.int64).astype(np.uint64)
        c2 = c.astype(canon)
        i64 = c2.view(np.int64)
        ok = c2.astype(c.dtype) == c  # False on conversion overflow
        if lo is not None:
            ok &= (i64 >= lo) & (i64 <= hi)
        if not ok.all():
            return None
        return i64.astype(np.uint64)
    if kind in "SU":
        lane = np.uint32 if kind == "U" else np.uint8
        # normalize to native byte order first: a '>U4' column
        # (frombuffer/parquet) viewed as uint32 lanes would hash
        # byte-swapped codepoints and split a key across replicas
        c = col[:n].astype(col.dtype.newbyteorder("="), copy=False)
        b = np.ascontiguousarray(c).view(lane).reshape(n, -1)
        h = np.full(n, _FNV_OFFSET, np.uint64)
        prime = np.uint64(_FNV_PRIME)
        for j in range(b.shape[1]):
            bj = b[:, j].astype(np.uint64)
            h = np.where(bj != 0, (h ^ bj) * prime, h)
        return h
    if kind == "V" and col.dtype.names:
        h = np.full(n, _FNV_OFFSET, np.uint64)
        prime = np.uint64(_FNV_PRIME)
        for name in col.dtype.names:
            sub = col[name]
            if sub.dtype.kind == "V":
                # nested structs materialize as nested TUPLES on the row
                # path, where _scalar_elem_hash has no fold — route
                # per-row (hash of the .item()ed tuple) on both sides
                return None
            eh = _column_hashes(sub, n)
            if eh is None:
                return None
            h = (h ^ eh) * prime
        return h
    return None


def _vector_key_dests(kcol: np.ndarray, n: int,
                      num_dests: int) -> Optional[np.ndarray]:
    """Hash-free (no per-row Python) keyby destinations for a TOP-LEVEL
    key column; None when the dtype needs the per-row path. Only
    str/bytes and structured (composite) columns qualify: top-level
    int/float keys route via CPython ``hash()`` on the per-row paths
    (identity for the common non-negative case, handled by the caller),
    and a uint64-wrap here would disagree with ``hash()`` for negative
    keys. As composite ELEMENTS ints hash by value on every path, so
    the 'V' fold stays consistent."""
    if kcol.dtype.kind not in "SUV":
        return None
    if n == 0:
        return np.zeros(0, np.int64)
    h = _column_hashes(kcol, n)
    if h is None:
        return None
    return (h % np.uint64(num_dests)).astype(np.int64)


def _scalar_fnv(lanes) -> int:
    """Scalar twin of the 'S'/'U' branch of ``_column_hashes`` (zero
    lanes skipped): per-row str/bytes keys must route identically to
    their columnar form."""
    h = _FNV_OFFSET
    for v in lanes:
        if v:
            h = ((h ^ v) * _FNV_PRIME) & _M64
    return h


def _scalar_elem_hash(v) -> Optional[int]:
    """Scalar twin of ``_column_hashes`` for one composite-key element;
    None for element types with no columnar representation (the whole
    key then falls back to CPython hash on every path)."""
    if isinstance(v, (np.datetime64, np.timedelta64)):
        # BEFORE the int branch: np.timedelta64 subclasses np.integer
        # (int() on it raises). Normalize units exactly like the
        # kind-'M'/'m' branch of _column_hashes so non-canonical-unit
        # scalars route with their columnar forms.
        unit = np.datetime_data(v.dtype)[0]
        if isinstance(v, np.datetime64):
            if unit in ("Y", "M", "W", "D"):
                v = v.astype("M8[D]")
            elif unit in ("h", "m", "s", "ms", "us"):
                v = v.astype("M8[us]")
        elif unit in ("W", "D", "h", "m", "s", "ms", "us"):
            v = v.astype("m8[us]")
        return int(v.view(np.int64)) & _M64
    if isinstance(v, (bool, np.bool_, int, np.integer)):
        return int(v) & _M64
    if isinstance(v, (float, np.floating)):
        f = float(v)
        # integral floats hash as their int value (dict equality unifies
        # 1 and 1.0, and -0.0 with 0) — the exact twin of the kind-'f'
        # branch in _column_hashes
        if f.is_integer() and abs(f) < 2.0**63:  # False for nan/inf
            return int(f) & _M64
        return int(np.float64(f).view(np.uint64))
    if isinstance(v, str):
        return _scalar_fnv(map(ord, v))
    if isinstance(v, bytes):
        return _scalar_fnv(v)
    if isinstance(v, _dt.date):       # datetime.datetime is a date too
        return int(np.datetime64(v).view(np.int64)) & _M64
    if isinstance(v, _dt.timedelta):
        return int(np.timedelta64(v).view(np.int64)) & _M64
    return None


def _dest_of_key(key, num_dests: int) -> int:
    """Per-row keyby destination, consistent with the vectorized columnar
    routing: FNV over codepoints for str (matching numpy 'U' columns) or
    bytes ('S' columns), an ordered FNV fold over elements for tuples /
    structured rows (matching stacked-column composite keys), CPython
    hash for everything else (ints route as identity either way)."""
    if isinstance(key, str):
        return _scalar_fnv(map(ord, key)) % num_dests
    if isinstance(key, bytes):
        return _scalar_fnv(key) % num_dests
    if isinstance(key, np.void) and key.dtype.names:
        key = key.item()  # structured row -> plain tuple
    if isinstance(key, tuple):
        h = _FNV_OFFSET
        for v in key:
            eh = _scalar_elem_hash(v)
            if eh is None:
                break
            h = ((h ^ eh) * _FNV_PRIME) & _M64
        else:
            return h % num_dests
    return hash(key) % num_dests


def _int_keys_hashable_as_identity(kcol: np.ndarray, n: int) -> bool:
    """True when ``kcol % num_dests`` routes exactly like the per-tuple
    ``hash(key) % num_dests`` of the CPU/TPU keyby emitters (keys must be
    non-negative ints below the Mersenne hash modulus)."""
    if kcol.dtype.kind == "u":
        return n == 0 or int(kcol.max()) < _HASH_MODULUS
    if kcol.dtype.kind == "i":
        return n == 0 or (int(kcol.min()) >= 0
                          and int(kcol.max()) < _HASH_MODULUS)
    return False


def key_dests(keys: Union[np.ndarray, Sequence], n: int,
              num_dests: int) -> np.ndarray:
    """Destinations of the first ``n`` keys: ``key % num_dests`` for
    non-negative int columns, the FNV fold for str/bytes columns, per row
    (``_dest_of_key``) for everything else."""
    if isinstance(keys, np.ndarray):
        if _int_keys_hashable_as_identity(keys[:n], n):
            return keys[:n].astype(np.int64) % num_dests
        dests = _vector_key_dests(keys, n, num_dests)
        if dests is not None:
            return dests
    return np.fromiter((_dest_of_key(k, num_dests)
                        for k in islice(keys, n)), dtype=np.int64, count=n)
