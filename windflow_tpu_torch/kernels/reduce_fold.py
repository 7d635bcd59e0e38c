"""Wrappers of the reduce operators' folds (``reduce_fold.cuh``) and their
plain versions.

- ``keyed_fold`` (K7): one fold per slot. The rows, gathered by an int32
  ``order`` whose slots ``skeys`` ascend (a slot at or past ``n_slots`` is
  the sentinel: its row is skipped), fold run by run in that order with
  ``combine(earlier, later)``; ``valid`` (optional) makes each row an
  Option, as the fused keyed terminator scans: an invalid side passes the
  other through, and a slot whose rows are all invalid comes out invalid.
  Returns ``(out, out_valid)``, ``out_rows`` rows: slot s's fold and
  whether it holds a valid row; a row with no run is invalid, its
  computed fields zero. The plain version ``keyed_fold_ref`` is the
  Hillis-Steele scan of ``gpu/scan.py`` and the tail gather the keyed
  ``Reduce_GPU`` ran before the kernel, scattered into the slots.
- ``tree_reduce`` (K6): the whole batch to one row under ``valid``, the
  JAX package's ``masked_tree_reduce`` (``tree_reduce_ref``, the plain
  version: halving passes over the rows padded to a power of two). Returns
  ``(out, out_valid)`` of one row; the row is garbage when no row is
  valid (callers skip empty batches).

A field the combine does not return takes the value of the last valid row
of the run (K6: of the row the halving tree's selects keep, the later
side of a pair where both are valid). On a card such a field never
enters the kernel: the combine is traced once per column signature
(``combine_trace.trace_reduce``: the computed fields' planes, any other
column passing through, of any dtype or shape), the kernel returns the
source row of each output, and the wrapper gathers each pass-through
column once (at a slot with no run, a pass-through column holds the
batch's row 0 there, the plain version zeros). A computed field outside
the traced language raises ``WindFlowError`` naming the operation: call
``prepare`` at the first prep on a card. A ``fieldwise(...)`` combine of
at most 8 int32 / float32 fields runs in the fieldwise library; every
other combine in the traced variant's library, which also holds K1-K4.

A tensor on the CPU goes through the plain version; on a CUDA card the
wrapper checks its arguments and launches the kernel on PyTorch's current
stream, or raises: nothing falls back. K7's tiles find their carry
through K2+K3's scratch per device and stream (``ffat_step.
ingest_scratch``), K6's last blocks their partials through a scratch of
its own (``tree_scratch``). ``REDUCE_LAUNCHES`` counts the calls that
launched either kernel, ``VARIANT_LAUNCHES`` the same by (kernel, variant
tag), kernel ``"keyed_fold"`` or ``"tree_reduce"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..basic import WindFlowError
from ..gpu.scan import masked_segmented_scan, rowwise
from . import ffat_step as fs
from . import forest_rebuild as fr
from .combine_codegen import kernel_source
from .combine_trace import trace_reduce

REDUCE_LAUNCHES = 0
VARIANT_LAUNCHES: Dict[Tuple[str, str], int] = {}
_count_lock = threading.Lock()

INT32_MAX = 2**31 - 1
TREE_THREADS = 256  # reduce_fold.cuh: WF_TREE_THREADS
TREE_SMEM = 32768   # reduce_fold.cuh: WF_TREE_SMEM, a block's staged rows
# K6's scratch per (device index, stream): [counters (zeroed when made;
# the kernel leaves them zero), partials]
_TREE: Dict[Tuple[Optional[int], int], list] = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def keyed_fold_ref(combine: Callable, fields: Dict[str, torch.Tensor],
                   order: torch.Tensor, skeys: torch.Tensor, n_slots: int,
                   valid: Optional[torch.Tensor] = None,
                   out_rows: Optional[int] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain K7: the rows gathered by ``order``, the inclusive segmented
    scan of each run of equal ``skeys`` (with ``valid`` as an Option),
    each run's tail below ``n_slots`` scattered to its slot of an
    ``out_rows``-row buffer of zeros."""
    rows = n_slots if out_rows is None else out_rows
    o = order.long()
    sk = skeys.long()
    dev = sk.device
    out, out_valid = empty_fold(fields, rows, dev)
    if sk.numel() == 0:
        return out, out_valid
    one = torch.ones(1, dtype=torch.bool, device=dev)
    scanned, vscan = masked_segmented_scan(
        combine, {k: v[o] for k, v in fields.items()},
        torch.cat([~one, sk[1:] == sk[:-1]]),
        None if valid is None else valid[o])
    tails = (torch.cat([sk[1:] != sk[:-1], one]) & (sk < n_slots)) \
        .nonzero().squeeze(1)
    slot = sk[tails]
    for k, v in scanned.items():
        out[k][slot] = v[tails]
    out_valid[slot] = True if vscan is None else vscan[tails]
    return out, out_valid


def empty_fold(fields: Dict[str, torch.Tensor], rows: int,
               dev: torch.device
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``rows`` output rows of zeros, every one invalid: what either fold
    gives where no row reaches it (K7's slots with no run, K6 over no
    rows)."""
    return ({k: torch.zeros((rows,) + v.shape[1:], dtype=v.dtype,
                            device=dev) for k, v in fields.items()},
            torch.zeros(rows, dtype=torch.bool, device=dev))


def tree_reduce_ref(combine: Callable, fields: Dict[str, torch.Tensor],
                    valid: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain K6 (``windflow_tpu/tpu/ops_tpu.py:280`` masked_tree_reduce):
    the rows padded with invalid zero rows to a power of two, then halving
    passes, position i with i + half, the earlier side left, under
    ``where(va & vb, merged, where(va, a, b))``; a field the combine does
    not return passes through from the later half."""
    n = next(iter(fields.values())).shape[0]
    # pad to a power of two so the halving never drops an odd tail (an
    # upstream Ffat_Windows_GPU emits batches of num_win_per_batch rows)
    m = 1 << max(0, n - 1).bit_length()
    if m != n:
        fields = {k: torch.cat([v, v.new_zeros((m - n,) + v.shape[1:])])
                  for k, v in fields.items()}
        valid = torch.cat([valid, valid.new_zeros(m - n)])
    cur, vcur = fields, valid
    length = m
    while length > 1:
        half = length // 2
        a = {k: v[:half] for k, v in cur.items()}
        b = {k: v[half:] for k, v in cur.items()}
        va, vb = vcur[:half], vcur[half:]
        merged = combine(a, b)
        both = va & vb
        cur = {k: torch.where(rowwise(both, b[k]), merged.get(k, b[k]),
                              torch.where(rowwise(va, b[k]), a[k], b[k]))
               for k in cur}
        vcur = va | vb
        length = half
    return {k: v[:1] for k, v in cur.items()}, vcur[:1]


# ---------------------------------------------------------------------------
# the combine's library
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FoldVariant:
    """The library a reduce combine runs in over one column signature:
    ``variant`` (K1's, ``forest_rebuild.Variant``: the fieldwise library
    or the traced combine's), the columns that are its ``planes`` and the
    columns ``passed`` through by source row."""
    variant: fr.Variant
    planes: Tuple[str, ...]
    passed: Tuple[str, ...]

    @property
    def tag(self) -> str:
        return self.variant.tag


def _signature(fields: Dict[str, torch.Tensor]) -> tuple:
    return tuple((f, t.dtype, tuple(t.shape[1:])) for f, t in fields.items())


def fold_variant(combine: Callable,
                 fields: Dict[str, torch.Tensor]) -> FoldVariant:
    """The combine's ``FoldVariant`` over columns like ``fields``: traced
    once per column signature, cached on the combine. Raises
    ``WindFlowError`` for a computed field the kernels cannot take."""
    key = _signature(fields)
    cache = getattr(combine, "_wf_reduce_variants", None)
    if cache is not None and key in cache:
        return cache[key]
    cols = {f: (dt, trail) if trail else dt for f, dt, trail in key}
    if hasattr(combine, "op_code"):
        planes = tuple(f for f in fields if f in combine.ops)
        missing = [f for f in combine.ops if f not in fields]
        if missing:
            raise WindFlowError(f"reduce: combine has ops for fields "
                                f"{missing} the batch does not carry")
        kinds = {f: cols[f] for f in planes}
        if len(planes) <= fr.MAX_FIELDS and all(
                dt in fr._WORD_DTYPES for dt in kinds.values()):
            fv = FoldVariant(fr.Variant(fr.FIELDWISE), planes, tuple(
                f for f in fields if f not in planes))
            return _cache(combine, key, fv)
    ir = trace_reduce(combine, cols)
    if len(ir.fields) > fr.GEN_MAX_FIELDS:
        raise WindFlowError(f"reduce: at most {fr.GEN_MAX_FIELDS} computed "
                            f"fields, got {len(ir.fields)}")
    text = kernel_source(ir)
    v = fr.Variant(hashlib.sha256(text.encode()).hexdigest()[:12], ir, text)
    return _cache(combine, key, FoldVariant(v, ir.fields, ir.passed))


def _cache(combine: Callable, key: tuple, fv: FoldVariant) -> FoldVariant:
    try:
        cache = getattr(combine, "_wf_reduce_variants", None)
        if cache is None:
            cache = combine._wf_reduce_variants = {}
        cache[key] = fv
    except (AttributeError, TypeError):
        pass  # an object without attributes is traced on every call
    return fv


def prepare(combine: Callable, fields: Dict[str, torch.Tensor],
            rows: int = 0) -> Optional[FoldVariant]:
    """On a card: trace the combine over columns like ``fields`` and load
    its library (raising ``WindFlowError`` for a combine the kernels
    cannot take), and with ``rows`` reserve K7's and K6's scratch for
    batches of that many rows on the current stream, so a replica's first
    batch finds both. Nothing on the CPU (None)."""
    dev = next(iter(fields.values())).device
    if dev.type != "cuda":
        return None
    fv = fold_variant(combine, fields)
    fv.variant.load()
    if rows > 0:
        fs.reserve_ingest_scratch(dev, rows)
        nf = len(fv.planes) + 2
        counters, parts = tree_words(rows, nf)
        tree_scratch(dev, fs._current_stream(dev), counters, parts)
    return fv


# ---------------------------------------------------------------------------
# K6's launch plan and scratch
# ---------------------------------------------------------------------------
def tree_rows_max(nf: int) -> int:
    """Rows a K6 block stages, at most, at ``nf`` words a row (the
    planes, the source row and the validity): a power of two within
    TREE_SMEM (``reduce_fold.cuh``: tree_rows_max)."""
    r = 1
    while 2 * r * nf * 4 <= TREE_SMEM:
        r *= 2
    return r


def tree_plan(n: int, nf: int) -> Tuple[int, int, int]:
    """``(log2 P, log2 L, log2 Lu)`` of K6 over ``n`` rows: P level-1
    blocks of L rows (P * L the power of two the rows pad to), later
    levels' blocks of at most Lu partials. A block takes at least 1,024
    rows (four a thread) and a 256th of the rows."""
    m = 1 << max(0, n - 1).bit_length()
    lmax = tree_rows_max(nf)
    L = min(m, lmax, max(4 * TREE_THREADS, m >> 8))
    return (m // L).bit_length() - 1, L.bit_length() - 1, \
        lmax.bit_length() - 1


def tree_words(n: int, nf: int) -> Tuple[int, int]:
    """Words of K6's scratch over ``n`` rows of ``nf`` words: the
    counters (a class of each level after the first) and the partials
    (``nf`` words a class of each level but the last)."""
    log2P, _, log2Lu = tree_plan(n, nf)
    c, counters, parts = 1 << log2P, 0, 0
    while c > 1:
        parts += c * nf
        c //= min(c, 1 << log2Lu)
        counters += c
    return counters, parts


def tree_scratch(dev: torch.device, stream: int, counters: int, parts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's scratch on ``dev`` for ``stream``: ``(counters, partials)``
    int32 buffers of at least the given words. One pair per device and
    stream: launches on one stream run in order, and each leaves its
    counters zero, so the counters are zeroed only when made (a power of
    two of words); the partials are never read before a launch writes
    them, so they grow with no fill."""
    key = (dev.index, stream)
    with _count_lock:
        ent = _TREE.get(key)
        if ent is None:
            ent = _TREE[key] = [torch.zeros(0, dtype=torch.int32,
                                            device=dev),
                                torch.empty(0, dtype=torch.int32,
                                            device=dev)]
        if ent[0].numel() < max(counters, 1):
            ent[0] = torch.zeros(fs._pow2(counters), dtype=torch.int32,
                                 device=dev)
        if ent[1].numel() < max(parts, 1):
            ent[1] = torch.empty(fs._pow2(parts), dtype=torch.int32,
                                 device=dev)
        return ent[0], ent[1]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_wf_reduce_bound", False):
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pvp, pci = ctypes.POINTER(vp), ctypes.POINTER(ci)
    lib.wf_keyed_fold.argtypes = [pvp, pci, ci, vp, vp, ci, vp, ci, ci, pvp,
                                  vp, vp, ci, vp, ci, vp, ci, ctypes.c_uint,
                                  vp]
    lib.wf_keyed_fold.restype = ci
    lib.wf_tree_reduce.argtypes = [pvp, pci, ci, vp, ci, ci, ci, ci, pvp, vp,
                                   vp, vp, ci, vp, ci, vp]
    lib.wf_tree_reduce.restype = ci
    lib.wf_error_string.argtypes = [ci]
    lib.wf_error_string.restype = ctypes.c_char_p
    lib._wf_reduce_bound = True


def _need(what: str, t: torch.Tensor, dtypes, n: int,
          dev: torch.device) -> None:
    if t.dtype not in dtypes or t.dim() != 1 or t.numel() != n \
            or not t.is_contiguous() or t.device != dev:
        raise WindFlowError(
            f"reduce_fold: {what} must be a contiguous 1-D "
            f"{'/'.join(str(d).replace('torch.', '') for d in dtypes)} "
            f"tensor of {n} elements on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _check_columns(fields: Dict[str, torch.Tensor], n: int,
                   dev: torch.device) -> None:
    if not fields:
        raise WindFlowError("reduce_fold: the batch has no columns")
    if n > INT32_MAX - 1:
        raise WindFlowError(f"reduce_fold: {n} rows overflow the int32 "
                            "row index")
    for f, t in fields.items():
        if t.dim() < 1 or t.shape[0] != n or t.device != dev:
            raise WindFlowError(
                f"reduce_fold: column {f!r} must hold {n} rows on {dev}, "
                f"got {tuple(t.shape)} on {t.device}")


def _planes(fv: FoldVariant, fields: Dict[str, torch.Tensor], n: int,
            dev: torch.device) -> Dict[str, torch.Tensor]:
    planes = {f: fields[f] for f in fv.planes}
    for f, t in planes.items():
        _need(f"column {f!r}", t, fr.PLANE_DTYPES, n, dev)
    return planes


def _finish(fields: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
            src: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The output columns in the batch's order: the kernel's planes, and
    each pass-through column gathered once by the source rows."""
    return {f: out[f] if f in out else t.index_select(0, src)
            for f, t in fields.items()}


def _count(kernel: str, tag: str) -> None:
    global REDUCE_LAUNCHES
    with _count_lock:
        REDUCE_LAUNCHES += 1
        VARIANT_LAUNCHES[kernel, tag] = \
            VARIANT_LAUNCHES.get((kernel, tag), 0) + 1


def launch_keyed_fold(lib: ctypes.CDLL, fv: FoldVariant, combine: Callable,
                      fields: Dict[str, torch.Tensor], order: torch.Tensor,
                      skeys: torch.Tensor, n_slots: int,
                      valid: Optional[torch.Tensor], out_rows: int,
                      stream: int
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K7's launch on checked arguments (``keyed_fold``), on ``stream``
    of the tensors' device, with K2+K3's scratch for that stream."""
    dev, n = order.device, order.numel()
    planes = {f: fields[f] for f in fv.planes}
    status, rows, seq = fs.ingest_scratch(dev, stream, n, len(planes) + 2)
    out = {f: torch.empty(out_rows, dtype=t.dtype, device=dev)
           for f, t in planes.items()}
    out_valid = torch.empty(out_rows, dtype=torch.bool, device=dev)
    src = torch.empty(out_rows, dtype=torch.int32, device=dev)
    _bind(lib)
    err = lib.wf_keyed_fold(
        fs._ptrs(planes.values()), fs._kinds(fv.variant, combine, planes),
        len(planes), None if valid is None else valid.data_ptr(),
        skeys.data_ptr(), skeys.element_size(), order.data_ptr(), n,
        n_slots, fs._ptrs(out.values()), out_valid.data_ptr(),
        src.data_ptr(), out_rows, status.data_ptr(), status.numel(),
        rows.data_ptr(), rows.numel(), seq, stream)
    fs._raise_on(lib, err, "keyed fold")
    return _finish(fields, out, src), out_valid


def keyed_fold(combine: Callable, fields: Dict[str, torch.Tensor],
               order: torch.Tensor, skeys: torch.Tensor, n_slots: int,
               valid: Optional[torch.Tensor] = None,
               out_rows: Optional[int] = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K7 (see the module docstring): ``(out, out_valid)`` of ``out_rows``
    rows (default ``n_slots``) from the columns ``fields`` (one row each
    per entry of ``order``), the int32 ``order``, the ascending int16 /
    int32 slots ``skeys`` and the optional bool ``valid``."""
    dev = order.device
    n = order.numel()
    rows = n_slots if out_rows is None else out_rows
    _need("order", order, (torch.int32,), n, dev)
    _need("skeys", skeys, fs.COMP_DTYPES, n, dev)
    if valid is not None:
        _need("valid", valid, (torch.bool,), n, dev)
    if not 0 <= n_slots <= rows or n_slots > INT32_MAX - 1 \
            or rows > INT32_MAX - 1:
        raise WindFlowError(f"keyed_fold: {n_slots} slots into {rows} "
                            "output rows (slots + 1 and rows within int32)")
    _check_columns(fields, n, dev)
    if dev.type == "cpu":
        return keyed_fold_ref(combine, fields, order, skeys, n_slots, valid,
                              rows)
    fs._cuda_or_raise("keyed_fold", dev)
    fv = fold_variant(combine, fields)
    _planes(fv, fields, n, dev)
    if n_slots > torch.iinfo(skeys.dtype).max:
        raise WindFlowError(f"keyed_fold: the sentinel {n_slots} does not "
                            f"fit {skeys.dtype}")
    if n == 0 or rows == 0:  # no row to fold: nothing to launch
        return empty_fold(fields, rows, dev)
    lib = fv.variant.load()
    with torch.cuda.device(dev):
        res = launch_keyed_fold(lib, fv, combine, fields, order, skeys,
                                n_slots, valid, rows,
                                fs._current_stream(dev))
    _count("keyed_fold", fv.tag)
    return res


def launch_tree_reduce(lib: ctypes.CDLL, fv: FoldVariant, combine: Callable,
                       fields: Dict[str, torch.Tensor], valid: torch.Tensor,
                       stream: int
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K6's launch on checked arguments (``tree_reduce``), on ``stream``
    of the tensors' device, with its scratch for that stream."""
    dev, n = valid.device, valid.numel()
    planes = {f: fields[f] for f in fv.planes}
    nf = len(planes) + 2
    log2P, log2L, log2Lu = tree_plan(n, nf)
    counters, parts = tree_scratch(dev, stream, *tree_words(n, nf))
    out = {f: torch.empty(1, dtype=t.dtype, device=dev)
           for f, t in planes.items()}
    out_valid = torch.empty(1, dtype=torch.bool, device=dev)
    src = torch.empty(1, dtype=torch.int32, device=dev)
    _bind(lib)
    err = lib.wf_tree_reduce(
        fs._ptrs(planes.values()), fs._kinds(fv.variant, combine, planes),
        len(planes), valid.data_ptr(), n, log2P, log2L, log2Lu,
        fs._ptrs(out.values()), out_valid.data_ptr(), src.data_ptr(),
        counters.data_ptr(), counters.numel(), parts.data_ptr(),
        parts.numel(), stream)
    fs._raise_on(lib, err, "tree reduce")
    return _finish(fields, out, src), out_valid


def tree_reduce(combine: Callable, fields: Dict[str, torch.Tensor],
                valid: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K6 (see the module docstring): ``(out, out_valid)``, one row, of
    the columns ``fields`` under the bool ``valid`` (one per row)."""
    dev = valid.device
    n = valid.numel()
    _need("valid", valid, (torch.bool,), n, dev)
    _check_columns(fields, n, dev)
    if dev.type == "cpu":
        return tree_reduce_ref(combine, fields, valid)
    fs._cuda_or_raise("tree_reduce", dev)
    fv = fold_variant(combine, fields)
    _planes(fv, fields, n, dev)
    if n == 0:  # no row to fold: nothing to launch
        return empty_fold(fields, 1, dev)
    lib = fv.variant.load()
    with torch.cuda.device(dev):
        res = launch_tree_reduce(lib, fv, combine, fields, valid,
                                 fs._current_stream(dev))
    _count("tree_reduce", fv.tag)
    return res
