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
  computed fields zero. On a card the kernel also takes each slot's first
  sorted row, ``starts`` (int32, ``n_slots + 1``: ``run_starts``, or the
  host's ``gpu/ops_gpu.py`` ``slot_starts``, shipped with the order), and,
  where the caller knows it, the longest run (``max_run``: below
  ``BLOCK_ROWS`` no chunk block is launched). The plain version
  ``keyed_fold_ref`` is the Hillis-Steele scan of ``gpu/scan.py`` and the
  tail gather the keyed ``Reduce_GPU`` ran before the kernel, scattered
  into the slots.
- ``tree_reduce`` (K6): the whole batch to one row under ``valid``, or
  with ``size`` the first ``size`` rows (no mask tensor), the JAX
  package's ``masked_tree_reduce`` (``tree_reduce_ref``, the plain
  version: halving passes over the rows padded to a power of two).
  Returns ``(out, out_valid)`` of one row; the row is garbage when no row
  is valid (callers skip empty batches).

A field the combine does not return takes the value of the last valid row
of the run (K6: of the row the halving tree's selects keep, the later
side of a pair where both are valid). On a card such a field never
enters the kernel's fold: the combine is traced once per column signature
(``combine_trace.trace_reduce``: the computed fields' planes, any other
column passing through, of any dtype or shape), the kernel returns the
source row of each output and gathers there the 1-D int32 / float32
pass-through columns (up to ``MAX_GATHER``; zero at a slot with no run,
as in the plain version), and the wrapper gathers any other pass-through
column once with ``index_select`` (row 0 at a slot with no run). A
computed field outside the traced language raises ``WindFlowError``
naming the operation: call ``prepare`` at the first prep on a card. A
``fieldwise(...)`` combine of at most 8 int32 / float32 fields runs in the
fieldwise library; every other combine in the traced variant's library,
which also holds K1-K4.

A tensor on the CPU goes through the plain version; on a CUDA card the
wrapper checks its arguments and launches the kernel on PyTorch's current
stream, or raises: nothing falls back. A call allocates one buffer for
its outputs. The last block of a long run (K7) or of a tree stage (K6)
finds the others' partials through a scratch per device and stream
(``fold_scratch``), whose counters each launch leaves zero.
``REDUCE_LAUNCHES`` counts the calls that launched either kernel,
``VARIANT_LAUNCHES`` the same by (kernel, variant tag), kernel
``"keyed_fold"`` or ``"tree_reduce"``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

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
#: rows, slots and output rows stay below this: the kernels' thread index
#: (a row past the last, a block of threads on) stays within int32
ROW_LIMIT = 2**31 - 256
#: rows K6 takes, at most (the power of two it pads to is an int32)
TREE_ROW_LIMIT = 2**30
FOLD_THREADS = 128  # reduce_fold.cuh: WF_FOLD_THREADS, both kernels' blocks
WARP_ROWS = 32      # reduce_fold.cuh: WF_FOLD_WARP_ROWS, K7's warp regime
MAX_GATHER = 8      # reduce_fold.cuh: WF_MAX_GATHER
#: K7: a run of this many rows or more is folded by the chunk blocks (the
#: warp regime below it); the chunk blocks take CHUNK_ROWS sorted rows
#: each (a power of two, at most BLOCK_ROWS). From the regimes' sweep on
#: an H100 (scripts/bench_torch_reduce.py; PERF.md): the warp
#: regime took 0.0045 ms at runs of 768 rows and 0.0055 at 1,024, the
#: chunk blocks 0.0052-0.0053 at any length, 256-row chunks the best or
#: tied from 256 rows up
BLOCK_ROWS = 1024
CHUNK_ROWS = 256
_GATHERED = (torch.int32, torch.float32)
# the names of the source rows and the validity in a Call's buffer layout
_SRC, _VALID = "\0src", "\0valid"
# the scratch per (device index, stream): [counters (zeroed when made;
# each launch leaves them zero), partials]
_SCRATCH: Dict[Tuple[Optional[int], int], list] = {}


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
    cannot take), and with ``rows`` reserve the scratch for batches of
    that many rows (and at most that many slots) on the current stream,
    so a replica's first batch finds it. Nothing on the CPU (None)."""
    dev = next(iter(fields.values())).device
    if dev.type != "cuda":
        return None
    call = _call_plan(combine, fields)
    if rows > 0:
        fold_scratch(dev, _stream(dev), *scratch_words(rows, call.nf))
    return call.fv


# ---------------------------------------------------------------------------
# the launch geometry and the scratch
# ---------------------------------------------------------------------------
def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def tree_rows(nf: int) -> int:
    """Rows a K6 thread folds in registers at the first stage, at ``nf``
    words a row (the planes, the source row and the validity;
    ``reduce_fold.cuh``: tree_rows)."""
    return 4 if nf <= 6 else 2 if nf <= 12 else 1


def tree_parts(nf: int) -> int:
    """Partials a K6 thread folds in registers at a later stage
    (``reduce_fold.cuh``: tree_parts)."""
    return (32 if nf <= 3 else 16 if nf <= 6 else 8 if nf <= 12
            else 4 if nf <= 24 else 2)


def tree_stages(n: int, nf: int) -> Tuple[int, ...]:
    """K6's stages over ``n`` rows of ``nf`` words: the blocks of each,
    the first stage's the launch's grid, the last 1. The rows pad to a
    power of two m; the first stage's blocks take FOLD_THREADS *
    tree_rows rows each (one block where m is no more), a later stage's
    the 32 partials a block of the stage before publishes, FOLD_THREADS *
    tree_parts a block."""
    m = _pow2_at_least(n)
    per = FOLD_THREADS * tree_rows(nf)
    stages = [m // per if m > per else 1]
    while stages[-1] > 1:
        q = 32 * stages[-1]
        per = FOLD_THREADS * tree_parts(nf)
        stages.append(q // per if q > per else 1)
    return tuple(stages)


@functools.lru_cache(maxsize=256)
def tree_words(n: int, nf: int) -> Tuple[int, int]:
    """Words of K6's scratch over ``n`` rows of ``nf`` words: the
    counters (a block of each stage after the first) and the partials
    (``nf`` planes of 32 a block of each stage but the last)."""
    stages = tree_stages(n, nf)
    return sum(stages[1:]), sum(nf * 32 * b for b in stages[:-1])


def chunk_blocks(n: int, max_run: Optional[int],
                 block_rows: int = BLOCK_ROWS,
                 chunk_rows: int = CHUNK_ROWS) -> int:
    """K7's chunk blocks over ``n`` sorted rows: one a chunk of
    ``chunk_rows``, none where the longest run (``max_run``, None where
    the caller does not know it) is shorter than ``block_rows``."""
    if max_run is not None and max_run < block_rows:
        return 0
    return -(-n // chunk_rows)


def scratch_words(n: int, nf: int) -> Tuple[int, int]:
    """Words of the scratch that covers K6 over ``n`` rows and K7 over
    ``n`` rows in at most ``n`` slots with chunk blocks, at ``nf`` words a
    row: ``(counters, partials)``; K7's counters are a word a slot, its
    partials two of ``nf`` words a chunk."""
    tc, tp = tree_words(n, nf)
    return max(tc, n), max(tp, 2 * nf * -(-n // CHUNK_ROWS))


def fold_scratch(dev: torch.device, stream: int, counters: int, parts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scratch of K6 and K7 on ``dev`` for ``stream``: ``(counters,
    partials)`` int32 buffers of at least the given words. One pair per
    device and stream: launches on one stream run in order, and each
    leaves its counters zero, so the counters are zeroed only when made
    (a power of two of words); the partials are never read before a
    launch writes them, so they grow with no fill."""
    key = (dev.index, stream)
    with _count_lock:
        ent = _SCRATCH.get(key)
        if ent is None:
            ent = _SCRATCH[key] = [torch.zeros(0, dtype=torch.int32,
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


def run_starts(skeys: torch.Tensor, n_slots: int,
               slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each slot's first sorted row, and the live rows' end, on the
    device of the ascending ``skeys``: int32, ``n_slots + 1``, one
    ``searchsorted`` (``slots``: ``0..n_slots`` of ``skeys``' dtype, which
    a caller may keep)."""
    if slots is None:
        slots = torch.arange(n_slots + 1, dtype=skeys.dtype,
                             device=skeys.device)
    return torch.searchsorted(skeys, slots, out_int32=True)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> None:
    """Each kernel's C entry takes its pointers and its ints packed in
    two arrays, then the fieldwise op codes (``reduce_fold.cuh``:
    keyed_fold_call, tree_reduce_call)."""
    if getattr(lib, "_wf_reduce_bound", False):
        return
    pvp, pci = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for fn in (lib.wf_keyed_fold, lib.wf_tree_reduce):
        fn.argtypes = [pvp, pci, pci]
        fn.restype = ctypes.c_int
    lib.wf_error_string.argtypes = [ctypes.c_int]
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
    if n >= ROW_LIMIT:
        raise WindFlowError(f"reduce_fold: {n} rows overflow the int32 "
                            "row index")
    for f, t in fields.items():
        if t.dim() < 1 or t.shape[0] != n or t.device != dev:
            raise WindFlowError(
                f"reduce_fold: column {f!r} must hold {n} rows on {dev}, "
                f"got {tuple(t.shape)} on {t.device}")


@dataclass(frozen=True)
class Call:
    """What a launch needs of a combine over one column signature, made
    once (``_call_plan``): its ``FoldVariant`` and loaded library, the
    fieldwise op codes, the columns that are planes, those the kernel
    gathers and those ``index_select`` gathers, and the output buffer's
    layout (the 4-byte planes, the source row and the gathered columns,
    then the bool planes and the validity)."""
    fv: FoldVariant
    lib: ctypes.CDLL
    kinds: Optional[ctypes.Array]
    planes: Tuple[str, ...]
    gathered: Tuple[str, ...]
    selected: Tuple[str, ...]
    words: Tuple[Tuple[str, torch.dtype], ...]
    flags: Tuple[str, ...]

    @property
    def nf(self) -> int:
        """Words a row of the kernels' fold: the planes, the source row
        and the validity."""
        return len(self.planes) + 2


def make_call(combine: Callable, fields: Dict[str, torch.Tensor],
              lib: ctypes.CDLL) -> Call:
    """The combine's ``Call`` over columns like ``fields`` with its
    library ``lib`` (``fold_variant(...).variant.load()``, or a host build
    of its source)."""
    fv = fold_variant(combine, fields)
    _bind(lib)
    planes = {f: fields[f] for f in fv.planes}
    gathered = tuple(f for f in fv.passed if fields[f].dim() == 1
                     and fields[f].dtype in _GATHERED)[:MAX_GATHER]
    words = tuple((f, t.dtype) for f, t in planes.items()
                  if t.dtype is not torch.bool)
    return Call(fv, lib, fs._kinds(fv.variant, combine, planes), fv.planes,
                gathered, tuple(f for f in fv.passed if f not in gathered),
                words + ((_SRC, torch.int32),)
                + tuple((f, fields[f].dtype) for f in gathered),
                tuple(f for f, t in planes.items() if t.dtype is torch.bool)
                + (_VALID,))


def _call_plan(combine: Callable, fields: Dict[str, torch.Tensor]) -> Call:
    """``make_call`` with the variant's own library: traced and loaded
    once per column signature, cached on the combine."""
    key = _signature(fields)
    cache = getattr(combine, "_wf_reduce_calls", None)
    if cache is not None and key in cache:
        return cache[key]
    call = make_call(combine, fields,
                     fold_variant(combine, fields).variant.load())
    try:
        if cache is None:
            cache = combine._wf_reduce_calls = {}
        cache[key] = call
    except (AttributeError, TypeError):
        pass  # an object without attributes is planned on every call
    return call


def _outputs(call: Call, rows: int, dev: torch.device):
    """One allocation carved into the kernel's outputs: ``(columns by
    name, validity, source rows)``: an int32 row each 4-byte output, then
    rows enough for the bool outputs (``rows`` bytes each)."""
    n4, n1 = len(call.words), len(call.flags)
    buf = torch.empty((n4 + (n1 + 3) // 4, rows), dtype=torch.int32,
                      device=dev)
    w = buf.unbind(0)
    flags = ((w[n4].view(torch.bool)[:rows],) if n1 == 1 else
             buf[n4:].view(torch.bool).view(-1)[:n1 * rows]
             .view(n1, rows).unbind(0))
    out = {f: t if dt is torch.int32 else t.view(dt)
           for (f, dt), t in zip(call.words, w)}
    out.update(zip(call.flags, flags))
    return out, out.pop(_VALID), out.pop(_SRC)


def _finish(fields: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor],
            src: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The output columns in the batch's order: the kernel's (its planes
    and the columns it gathered), and each other column gathered once by
    the source rows."""
    return {f: out[f] if f in out else t.index_select(0, src)
            for f, t in fields.items()}


def _count(kernel: str, tag: str) -> None:
    global REDUCE_LAUNCHES
    with _count_lock:
        REDUCE_LAUNCHES += 1
        VARIANT_LAUNCHES[kernel, tag] = \
            VARIANT_LAUNCHES.get((kernel, tag), 0) + 1


def _packed(call: Call, fields: Dict[str, torch.Tensor],
            out: Dict[str, torch.Tensor], tail: Sequence[Optional[int]]
            ) -> ctypes.Array:
    """A launch's pointers as its C entry takes them: the planes, their
    outputs, the gathered columns and their outputs, then ``tail``."""
    ptrs = ([fields[f].data_ptr() for f in call.planes]
            + [out[f].data_ptr() for f in call.planes]
            + [fields[f].data_ptr() for f in call.gathered]
            + [out[f].data_ptr() for f in call.gathered] + list(tail))
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _stream(dev: torch.device) -> int:
    """The raw current stream of ``dev``, the current card: PyTorch's CUDA
    builds bind ``_cuda_getCurrentRawStream``, which skips the Stream
    object ``torch.cuda.current_stream`` builds (13 of a call's 61 us of
    host time on an H100's host, PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if dev.index is None else dev.index)


def _on_device(dev: torch.device, fn):
    """``fn()`` with ``dev`` the current card (a launch goes to the
    current card's stream)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn()
    with torch.cuda.device(dev):
        return fn()


def launch_keyed_fold(call: Call, fields: Dict[str, torch.Tensor],
                      order: torch.Tensor, skeys: torch.Tensor,
                      starts: torch.Tensor, n_slots: int,
                      valid: Optional[torch.Tensor], out_rows: int,
                      blocks: int, stream: int,
                      block_rows: int = BLOCK_ROWS,
                      chunk_rows: int = CHUNK_ROWS
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K7's launch on checked arguments (``keyed_fold``), on ``stream``
    of the tensors' device, with ``blocks`` chunk blocks
    (``chunk_blocks``) of ``chunk_rows`` rows for the runs of
    ``block_rows`` or more, and the scratch for that stream."""
    dev, n = order.device, order.numel()
    out, out_valid, src = _outputs(call, out_rows, dev)
    counters = parts = None
    if blocks:
        counters, parts = fold_scratch(
            dev, stream, n_slots, 2 * call.nf * blocks)
    err = call.lib.wf_keyed_fold(
        _packed(call, fields, out, (
            None if valid is None else valid.data_ptr(), skeys.data_ptr(),
            order.data_ptr(), starts.data_ptr(), out_valid.data_ptr(),
            src.data_ptr(), None if counters is None else counters.data_ptr(),
            None if parts is None else parts.data_ptr(), stream)),
        (ctypes.c_int * 11)(
            len(call.planes), len(call.gathered), skeys.element_size(), n,
            n_slots, out_rows, block_rows, chunk_rows.bit_length() - 1,
            blocks, 0 if counters is None else counters.numel(),
            0 if parts is None else parts.numel()), call.kinds)
    fs._raise_on(call.lib, err, "keyed fold")
    return _finish(fields, out, src), out_valid


def keyed_fold(combine: Callable, fields: Dict[str, torch.Tensor],
               order: torch.Tensor, skeys: torch.Tensor, n_slots: int,
               valid: Optional[torch.Tensor] = None,
               out_rows: Optional[int] = None,
               starts: Optional[torch.Tensor] = None,
               max_run: Optional[int] = None
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K7 (see the module docstring): ``(out, out_valid)`` of ``out_rows``
    rows (default ``n_slots``) from the columns ``fields`` (one row each
    per entry of ``order``), the int32 ``order``, the ascending int16 /
    int32 slots ``skeys``, the optional bool ``valid``, and on a card the
    int32 ``starts`` (``n_slots + 1``; made with ``run_starts`` where
    None) and the longest run ``max_run`` where known."""
    dev = order.device
    n = order.numel()
    rows = n_slots if out_rows is None else out_rows
    _need("order", order, (torch.int32,), n, dev)
    _need("skeys", skeys, fs.COMP_DTYPES, n, dev)
    if valid is not None:
        _need("valid", valid, (torch.bool,), n, dev)
    if not 0 <= n_slots <= rows or rows >= ROW_LIMIT:
        raise WindFlowError(f"keyed_fold: {n_slots} slots into {rows} "
                            "output rows (slots and rows within int32)")
    _check_columns(fields, n, dev)
    if dev.type == "cpu":
        return keyed_fold_ref(combine, fields, order, skeys, n_slots, valid,
                              rows)
    fs._cuda_or_raise("keyed_fold", dev)
    call = _call_plan(combine, fields)
    for f in call.planes + call.gathered:
        _need(f"column {f!r}", fields[f], fr.PLANE_DTYPES, n, dev)
    if n_slots > torch.iinfo(skeys.dtype).max:
        raise WindFlowError(f"keyed_fold: the sentinel {n_slots} does not "
                            f"fit {skeys.dtype}")
    if n == 0 or rows == 0:  # no row to fold: nothing to launch
        return empty_fold(fields, rows, dev)
    if starts is None:
        starts = run_starts(skeys, n_slots)
    _need("starts", starts, (torch.int32,), n_slots + 1, dev)
    blocks = chunk_blocks(n, max_run)

    def go():
        return launch_keyed_fold(call, fields, order, skeys, starts,
                                 n_slots, valid, rows, blocks, _stream(dev))

    res = _on_device(dev, go)
    _count("keyed_fold", call.fv.tag)
    return res


def launch_tree_reduce(call: Call, fields: Dict[str, torch.Tensor],
                       valid: Optional[torch.Tensor], size: int, stream: int
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K6's launch on checked arguments (``tree_reduce``), on ``stream``
    of the tensors' device, with the scratch for that stream."""
    first = fields[next(iter(fields))]
    dev, n = first.device, first.shape[0]
    out, out_valid, src = _outputs(call, 1, dev)
    counters, parts = fold_scratch(dev, stream, *tree_words(n, call.nf))
    err = call.lib.wf_tree_reduce(
        _packed(call, fields, out, (
            None if valid is None else valid.data_ptr(), out_valid.data_ptr(),
            src.data_ptr(), counters.data_ptr(), parts.data_ptr(), stream)),
        (ctypes.c_int * 6)(len(call.planes), len(call.gathered), n, size,
                           counters.numel(), parts.numel()), call.kinds)
    fs._raise_on(call.lib, err, "tree reduce")
    return _finish(fields, out, src), out_valid


def tree_reduce(combine: Callable, fields: Dict[str, torch.Tensor],
                valid: Optional[torch.Tensor] = None,
                size: Optional[int] = None
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """K6 (see the module docstring): ``(out, out_valid)``, one row, of
    the columns ``fields`` under the bool ``valid`` (one per row), or,
    with ``size`` instead, of their first ``size`` rows."""
    if (valid is None) == (size is None):
        raise WindFlowError("tree_reduce: give the valid mask or the size, "
                            "one of them")
    if valid is not None:
        dev, n = valid.device, valid.numel()
        _need("valid", valid, (torch.bool,), n, dev)
    else:
        if not fields:
            raise WindFlowError("reduce_fold: the batch has no columns")
        first = next(iter(fields.values()))
        dev, n = first.device, first.shape[0]
    if size is not None and not 0 <= size <= n:
        raise WindFlowError(f"tree_reduce: size {size} of {n} rows")
    _check_columns(fields, n, dev)
    if dev.type == "cpu":
        if valid is None:
            valid = torch.arange(n, device=dev) < size
        return tree_reduce_ref(combine, fields, valid)
    fs._cuda_or_raise("tree_reduce", dev)
    if n > TREE_ROW_LIMIT:
        raise WindFlowError(f"tree_reduce: {n} rows, more than "
                            f"{TREE_ROW_LIMIT}")
    call = _call_plan(combine, fields)
    for f in call.planes + call.gathered:
        _need(f"column {f!r}", fields[f], fr.PLANE_DTYPES, n, dev)
    if n == 0 or size == 0:  # no row to fold: nothing to launch
        return empty_fold(fields, 1, dev)
    res = _on_device(dev, lambda: launch_tree_reduce(
        call, fields, valid, n if size is None else size, _stream(dev)))
    _count("tree_reduce", call.fv.tag)
    return res
