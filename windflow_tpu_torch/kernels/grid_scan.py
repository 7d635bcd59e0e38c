"""Wrapper of the keyed grid scan's kernel (K8, ``grid_scan.cuh``) and its
plain version.

A stateful ``Map_GPU`` / ``Filter_GPU`` step ``func(row, state) -> (row |
keep, state)`` runs over a batch's rows key by key, in arrival order,
against a table of per-key state (one ``(T_cap + 1,)`` tensor per state
leaf, the last row scratch) and a ``dirty`` bitmap beside it, both updated
in place. The batch comes as ``KeyRows``: the rows grouped by the key's
batch-local slot (``order``, arrival order within a key, then the rows no
key walks), the ``starts`` of each key's run, and each key's table row
(``touched``).

- ``grid_walk(step, fields, valid, rows, table, dirty)`` runs it. On a
  CUDA card it launches the kernel, with the step traced
  (``combine_trace.trace_step``) once per row and state dtypes, emitted as
  C++ (``combine_codegen.step_kernel_source``) and built into a library
  of its own (``build.load_generated``), on PyTorch's current stream, or
  raises: nothing falls back. On the CPU it runs the plain version.
- The kernel walks a key in one of two regimes of the same launch: a
  thread a key, or, for a key of ``HEAVY_ROWS`` rows or more, a block
  that stages the key's rows through shared memory while one thread
  walks them. ``KeyRows.heavy`` lists those keys: ``heavy_keys``
  builds it from the host's counts, longest first; ``heavy_keys_device``
  from a card's counts with two elementwise ops and no host sync (every
  key at its own index, -1 for a lighter one).
- ``grid_scan_core`` is the plain version (the JAX package's
  ``_grid_scan_core``, ``ops_tpu.py:212-277``, as torch ops): rows
  scatter to a (KB x M) grid and M steps apply ``torch.func.vmap(func)``
  to all KB keys at once. ``grid_of`` gives its grid from the rows; the
  grid's cells are int32, so it refuses a batch whose ``KB * M`` leaves
  no scratch cell inside int32 (the kernel indexes rows, not cells, and
  takes such a batch).

``LAUNCHES`` counts the calls that launched the kernel,
``VARIANT_LAUNCHES`` the same per traced step (its tag). Outputs on rows
``valid`` excludes carry no meaning (the kernel writes zeros, the plain
version the key's first cell, as JAX does): compare the rows ``valid``
admits, the table rows ``[0, T_cap)`` and ``dirty[:T_cap]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..basic import WindFlowError
from ..gpu.schema import canonical
from ..pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .build import load_generated
from .combine_codegen import step_kernel_source, step_out_dtypes, step_reads
from .combine_trace import StepIR, trace_step

LAUNCHES = 0  # calls that launched the kernel (replica threads share it)
VARIANT_LAUNCHES: Dict[str, int] = {}
_count_lock = threading.Lock()

INT32_MAX = 2**31 - 1
#: most row columns read, output columns and state leaves of a step (the
#: kernel's parameter block holds a pointer for each)
MAX_COLUMNS = 64
#: a key with this many rows or more takes the kernel's block regime: from
#: a sweep on an H100 (run lengths 8-1,024 at 65,536 rows,
#: ``scripts/bench_torch_k8.py``), the thread regime is faster at 16 rows
#: a key, the two within 10% at 24, the block regime 1.7x faster at 32
HEAVY_ROWS = 32
#: the block regime's ring of tiles in shared memory, at most. A launch's
#: dynamic shared memory goes to every block of it, the thread regime's
#: too: 12 KB keeps 16 blocks of 128 threads an SM (228 KB less 1 KB a
#: block), the most the SM's 2,048 threads hold
RING_BYTES = 12 * 1024
#: most rows of a ring tile
MAX_TILE_ROWS = 2048
#: most block-regime blocks where the host only bounds the heavy keys (the
#: mesh's list in key order): two an SM of an H100; each strides over it
MAX_HEAVY_BLOCKS = 264


class KeyRows(NamedTuple):
    """A batch's rows grouped by key, the layout the kernel walks.
    ``order`` (int32, one entry per row of the columns): each key's rows
    in arrival order, key after key, then the rows no key walks (padding,
    or on the mesh the invalid lanes); ``starts`` (int32, KB + 1): key
    k's rows are ``order[starts[k]:starts[k + 1]]``; ``touched`` (int32,
    KB): key k's table row; ``n_touched`` keys are real (the rest of the
    KB are padding with empty runs); ``M``: the plain version's grid
    depth (a power of two, at least the most rows of one key), or None
    where the caller does not count it (the plain version then takes it
    from ``starts``; the kernel never reads it); ``walked``:
    ``starts[n_touched]`` when the host knows it, else None; ``heavy``
    (int32): the keys whose run is ``heavy_rows`` or longer, which the
    kernel's block regime walks (longest first from the host; from a
    card, every key's entry, -1 for a lighter key), or None where no key
    is heavy;
    ``heavy_blocks``: the block-regime blocks to launch (one an entry, or
    fewer, striding over the list); ``heavy_rows``: the threshold the list
    was built at, which the wrapper passes to the kernel. The host's
    ``grid_meta`` fills the same tuple with numpy arrays."""
    order: torch.Tensor
    starts: torch.Tensor
    touched: torch.Tensor
    n_touched: int
    M: Optional[int]
    walked: Optional[int] = None
    heavy: Optional[torch.Tensor] = None
    heavy_blocks: int = 0
    heavy_rows: Optional[int] = None


def heavy_keys(counts: np.ndarray, heavy_rows: int) -> np.ndarray:
    """The keys (indices of ``counts``, each key's rows) whose run is
    ``heavy_rows`` or longer: int32, longest first, ties by key."""
    keys = np.flatnonzero(counts >= heavy_rows)
    return keys[np.argsort(-counts[keys], kind="stable")].astype(np.int32)


def heavy_keys_device(counts: torch.Tensor, heavy_rows: int,
                      keys: torch.Tensor) -> torch.Tensor:
    """The heavy list on the counts' device with no host sync, in two
    elementwise ops: entry k is key k (``keys``, int32 ``0..K-1``) where
    its run is ``heavy_rows`` or longer, else -1. Blocks striding over it
    skip the -1 entries; none is compacted or sorted, which would take a
    sort's dozen launches a step."""
    return torch.where(counts >= heavy_rows, keys, -1)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------
def _bwhere(ok: torch.Tensor, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    """``new`` where ``ok`` else ``old``, in ``old``'s dtype (a state leaf
    keeps its table dtype whatever the user function computed)."""
    shaped = ok.reshape(ok.shape + (1,) * (new.dim() - ok.dim()))
    return torch.where(shaped, new, old).to(old.dtype)


def grid_scan_core(func: Callable, filter_mode: bool, M: int, KB: int
                   ) -> Callable:
    """The keyed grid scan (K8; the JAX package's ``_grid_scan_core``,
    ``ops_tpu.py:212-277``) as plain torch ops. Rows scatter to a (KB x M)
    grid of (batch-local key slot, per-key position); M steps each apply
    ``torch.func.vmap(func)`` to all KB keys at once, and a key's state
    changes only where its step holds a row; the outputs gather back to
    arrival order. Returns ``core(fields, valid, grid_idx, touched,
    touched_mask, table, dirty) -> out``: the per-row output columns (map
    mode) or the keep mask ANDed with ``valid`` (filter mode).

    ``table`` (a pytree of ``(T_cap + 1,)`` tensors) and ``dirty`` (a
    ``(T_cap + 1,)`` bool bitmap) are updated IN PLACE: the touched rows
    get their new state and their dirty bit. The last row of each is a
    scratch row, the target of what JAX drops with ``mode="drop"``: the
    padding lanes of the KB axis (they read slot 0 and write the scratch
    row, never slot 0), as the grid's scratch cell ``KB*M`` takes the
    invalid rows. Rows ``valid`` excludes (padding, or dropped by a fused
    filter earlier in the chain) skip the grid and leave their key's state
    untouched; their slots are still scattered back and marked dirty, as
    the JAX bitmap is (conservative). The caller runs this in commit
    order: the table is read when the core runs."""
    KM = KB * M
    vfunc = torch.func.vmap(func)

    def core(fields, valid, grid_idx, touched, touched_mask, table, dirty):
        leaves, spec = tree_flatten(table)
        t_cap = leaves[0].shape[0] - 1
        tsafe = torch.where(touched_mask, touched, 0)
        state = tree_unflatten(spec, [lf[tsafe] for lf in leaves])  # copies
        safe = torch.where(valid, grid_idx, KM)
        cols = {}
        for f, v in fields.items():
            g = v.new_zeros((KM + 1,) + v.shape[1:])
            g[safe] = v
            # (M, KB): step j reads row j, one cell per key
            cols[f] = g[:KM].view((KB, M) + v.shape[1:]).transpose(0, 1)
        gm = torch.zeros(KM + 1, dtype=torch.bool, device=grid_idx.device)
        gm[safe] = True
        gmask = gm[:KM].view(KB, M).t()
        outs = []
        for j in range(M):
            out, new = vfunc({f: c[j] for f, c in cols.items()}, state)
            if not filter_mode and not isinstance(out, dict):
                raise WindFlowError("stateful Map_GPU function must return "
                                    "(dict of columns, state)")
            ok = gmask[j]
            state = tree_map(lambda o, nw: _bwhere(ok, nw, o), state, new)
            outs.append(out)
        tscatter = torch.where(touched_mask, touched, t_cap)
        for lf, nw in zip(leaves, tree_leaves(state)):
            lf[tscatter] = nw
        dirty[tscatter] = True
        # gather outputs back to arrival positions: stacked (M, KB), row
        # (slot, within) sits at within * KB + slot
        slot = torch.div(grid_idx, M, rounding_mode="floor")
        within = torch.where(valid, grid_idx % M, 0)
        row_flat = within * KB + torch.clamp(slot, max=KB - 1)
        if filter_mode:
            keep = torch.stack(outs).reshape(-1)[row_flat]
            return keep.to(torch.bool) & valid
        stacked = {f: torch.stack([o[f] for o in outs]) for f in outs[0]}
        return {f: canonical(o.reshape((M * KB,) + o.shape[2:])[row_flat])
                for f, o in stacked.items()}

    return core


def grid_of(rows: KeyRows, n_rows: int
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(grid_idx, touched_mask, M)`` of the plain version from ``rows``:
    key k's j-th row sits at cell ``k * M + j``; a row no key walks at 0
    (the plain version never reads its cell). ``M`` is ``rows.M``, or the
    power of two at or above the most rows of one key. The cells are
    int32: a grid whose ``KB * M`` leaves no scratch cell inside int32
    raises ``WindFlowError`` before anything is allocated (the JAX
    package's int32 ``grid_idx`` wraps there)."""
    dev = rows.order.device
    starts = rows.starts.to(torch.int64)
    KB = rows.touched.shape[0]
    counts = starts[1:] - starts[:-1]
    M = rows.M
    if M is None:
        most = int(counts.max()) if KB else 0
        M = 1 << max(0, most - 1).bit_length()
    if KB * M + 1 > INT32_MAX:
        raise WindFlowError(
            f"grid_scan: the plain version's grid is KB={KB} keys x M={M} "
            f"positions = {KB * M} cells, beyond int32 cell indices; use "
            "smaller batches (M is the most rows of one key)")
    n_walk = int(starts[-1])
    key = torch.repeat_interleave(torch.arange(KB, device=dev), counts,
                                  output_size=n_walk)
    within = torch.arange(n_walk, device=dev) - starts[key]
    grid_idx = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    grid_idx[rows.order[:n_walk].to(torch.int64)] = (
        key * M + within).to(torch.int32)
    tmask = torch.arange(KB, device=dev) < rows.n_touched
    return grid_idx, tmask, M


# ---------------------------------------------------------------------------
# the traced step and its library
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StepVariant:
    """K8's library for one traced step: ``tag`` a digest of the
    generated source ``text``; ``reads`` the row columns the kernel reads,
    ``out_dtypes`` its output columns' dtypes."""
    ir: StepIR
    tag: str
    text: str
    reads: Tuple[str, ...]
    out_dtypes: Tuple[torch.dtype, ...]

    @property
    def library(self) -> str:
        """Its ``build.BUILD_INFO`` name."""
        return f"grid_scan-{self.tag}"

    def load(self) -> ctypes.CDLL:
        return load_generated(self.tag, self.text, kind="grid_scan")


def step_variant(func: Callable, filter_mode: bool,
                 fields: Dict[str, torch.Tensor], table) -> StepVariant:
    """Trace ``func`` over columns like ``fields`` and a state like
    ``table``'s leaves, and emit its library's source. Raises
    ``WindFlowError`` for a step the kernel cannot take."""
    ir = trace_step(func, {f: (t.dtype, tuple(t.shape[1:]))
                           for f, t in fields.items()}, table, filter_mode)
    reads, outs = tuple(step_reads(ir)), tuple(step_out_dtypes(ir))
    if max(len(reads), len(outs), len(ir.state)) > MAX_COLUMNS:
        raise WindFlowError(
            f"step: the kernel takes at most {MAX_COLUMNS} row columns "
            f"read, output columns and state leaves, got {len(reads)}, "
            f"{len(outs)} and {len(ir.state)}")
    text = step_kernel_source(ir)
    return StepVariant(ir, hashlib.sha256(text.encode()).hexdigest()[:12],
                       text, reads, outs)


class GridStep:
    """A stateful step as K8 runs it: ``func`` and its mode, and its
    traced variants, one per (row, state) dtypes (traced at first use)."""

    def __init__(self, func: Callable, filter_mode: bool) -> None:
        self.func = func
        self.filter_mode = filter_mode
        self._variants: Dict[tuple, StepVariant] = {}

    def variant(self, fields: Dict[str, torch.Tensor], table) -> StepVariant:
        key = (tuple((f, t.dtype, tuple(t.shape[1:]))
                     for f, t in fields.items()),
               tuple(lf.dtype for lf in tree_leaves(table)))
        v = self._variants.get(key)
        if v is None:
            v = self._variants[key] = step_variant(
                self.func, self.filter_mode, fields, table)
        return v


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_wf_bound", False):
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(vp)
    lib.wf_grid_scan.argtypes = [pp, ci, pp, ci, pp, ci, vp, vp, vp, vp, vp,
                                 vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.wf_grid_scan.restype = ci
    lib.wf_ring_bytes.argtypes = [ci]
    lib.wf_ring_bytes.restype = ctypes.c_longlong
    lib.wf_error_string.argtypes = [ci]
    lib.wf_error_string.restype = ctypes.c_char_p
    lib._wf_bound = True


def _check(v: StepVariant, fields, valid, rows: KeyRows, table, dirty):
    """Raise ``WindFlowError`` for arguments the kernel does not take."""
    dev = valid.device
    n_rows = valid.shape[0]
    leaves = tree_leaves(table)
    if n_rows > INT32_MAX or rows.touched.shape[0] + 1 > INT32_MAX \
            or leaves[0].shape[0] > INT32_MAX:
        raise WindFlowError("grid_scan: rows, keys and table rows are "
                            "indexed in int32")

    def need(what, t, dtype, n):
        if t.device != dev or t.dtype is not dtype or t.dim() != 1 \
                or not t.is_contiguous() or (n is not None
                                             and t.shape[0] != n):
            raise WindFlowError(
                f"grid_scan: {what} must be a contiguous ({n},) {dtype} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")

    need("valid", valid, torch.bool, n_rows)
    need("order", rows.order, torch.int32, n_rows)
    need("touched", rows.touched, torch.int32, None)
    need("starts", rows.starts, torch.int32, rows.touched.shape[0] + 1)
    if not 0 <= rows.n_touched <= rows.touched.shape[0]:
        raise WindFlowError(f"grid_scan: {rows.n_touched} touched keys of "
                            f"{rows.touched.shape[0]}")
    if rows.heavy is not None:
        need("heavy", rows.heavy, torch.int32, None)
        if rows.heavy_rows is None or rows.heavy_rows < 1 \
                or rows.heavy_blocks < 0:
            raise WindFlowError(
                f"grid_scan: a heavy list needs its threshold (got "
                f"{rows.heavy_rows}) and its blocks (got "
                f"{rows.heavy_blocks})")
    t_rows = leaves[0].shape[0]
    for lf, dt in zip(leaves, v.ir.state):
        need("a table leaf", lf, dt, t_rows)
    need("dirty", dirty, torch.bool, t_rows)
    for f in v.reads:
        if fields[f].device != dev or fields[f].shape[0] != n_rows:
            raise WindFlowError(f"grid_scan: column {f!r} must hold "
                                f"{n_rows} rows on {dev}")


def launch_threads(rows: KeyRows, n_rows: int) -> int:
    """The thread regime's threads: one a touched key, and enough for the
    rows no key walks (all the rows when the host does not know how
    many)."""
    walked = rows.walked if rows.walked is not None else 0
    return max(rows.n_touched, n_rows - walked)


def tile_rows(lib: ctypes.CDLL) -> int:
    """The block regime's tile of a step's library: the most rows, a power
    of two up to ``MAX_TILE_ROWS``, whose ring fits ``RING_BYTES`` (the
    library sizes a row: its order index, valid byte and read columns)."""
    t = getattr(lib, "_wf_tile_rows", None)
    if t is None:
        _bind(lib)
        t = MAX_TILE_ROWS
        while t > 1 and lib.wf_ring_bytes(t) > RING_BYTES:
            t //= 2
        lib._wf_tile_rows = t
    return t


def _out_columns(v: StepVariant, fields, computed: list):
    """A map step's output columns in the step's order: the computed ones,
    and each pass-through as its input column in the plain version's
    dtype (``canonical``: the input tensor itself, not a copy, when its
    dtype is already int32, float32 or bool)."""
    ir = v.ir
    made = {f: o for (f, _), o in zip(ir.outputs, computed)}
    passed = dict(ir.passed)
    return {f: canonical(fields[passed[f]]) if f in passed else made[f]
            for f in ir.names}


def output_like(v: StepVariant, fields: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """One row of zeros like each column ``v``'s step emits over columns
    like ``fields``: what the next sub-op of a fused chain sees (a filter
    step passes the columns it was given on)."""
    if v.ir.filter_mode:
        return fields
    dev = next(iter(fields.values())).device
    return _out_columns(v, {f: t[:1] for f, t in fields.items()},
                        [torch.zeros(1, dtype=dt, device=dev)
                         for dt in v.out_dtypes])


def run_walk(lib: ctypes.CDLL, v: StepVariant, fields, valid,
             rows: KeyRows, table, dirty, stream: int,
             tile: Optional[int] = None):
    """One launch of ``v``'s kernel from ``lib`` on ``stream``: the output
    columns (map mode; a pass-through is its input column, ALIASED where
    its dtype is already canonical, as a stateless map's ``{**row}``
    aliases) or the keep mask (filter mode). The table and ``dirty``
    update in place. The thread regime walks every key when
    ``rows.heavy`` is None; else the block regime walks the listed keys
    at ``rows.heavy_rows``, a ring tile of ``tile`` rows (default
    ``tile_rows(lib)``)."""
    _bind(lib)
    _check(v, fields, valid, rows, table, dirty)
    n_rows = valid.shape[0]
    dev = valid.device
    cols = [fields[f].contiguous() for f in v.reads]
    outs = [torch.empty(n_rows, dtype=dt, device=dev) for dt in v.out_dtypes]
    leaves = tree_leaves(table)

    def ptrs(ts):
        return (ctypes.c_void_p * max(1, len(ts)))(
            *[t.data_ptr() for t in ts])

    heavy = rows.heavy
    if heavy is None or not heavy.shape[0] or not rows.heavy_blocks:
        heavy, n_heavy, blocks, hr = None, 0, 0, INT32_MAX
    else:
        n_heavy, blocks, hr = heavy.shape[0], rows.heavy_blocks, \
            rows.heavy_rows
        heavy = heavy.data_ptr()
    err = lib.wf_grid_scan(ptrs(cols), len(cols), ptrs(outs), len(outs),
                           ptrs(leaves), len(leaves), dirty.data_ptr(),
                           valid.data_ptr(), rows.order.data_ptr(),
                           rows.starts.data_ptr(), rows.touched.data_ptr(),
                           heavy, rows.n_touched, n_rows,
                           launch_threads(rows, n_rows), n_heavy, blocks, hr,
                           tile if tile is not None else tile_rows(lib),
                           stream)
    if err != 0:
        raise RuntimeError("grid_scan kernel launch failed: "
                           + lib.wf_error_string(err).decode())
    if v.ir.filter_mode:
        return outs[0]
    return _out_columns(v, fields, outs)


def grid_walk(step: GridStep, fields: Dict[str, torch.Tensor],
              valid: torch.Tensor, rows: KeyRows, table, dirty):
    """One batch's keyed scan: the output columns (map mode) or the keep
    mask ANDed with ``valid`` (filter mode); ``table`` and ``dirty`` are
    updated in place. The kernel on a CUDA card, the plain version on the
    CPU."""
    dev = valid.device
    if dev.type == "cpu":
        grid_idx, tmask, M = grid_of(rows, valid.shape[0])
        core = grid_scan_core(step.func, step.filter_mode, M,
                              rows.touched.shape[0])
        return core(fields, valid, grid_idx, rows.touched, tmask, table,
                    dirty)
    if dev.type != "cuda":
        raise WindFlowError(f"grid_scan: no kernel for device {dev}")
    global LAUNCHES
    v = step.variant(fields, table)
    lib = v.load()
    with torch.cuda.device(dev):
        out = run_walk(lib, v, fields, valid, rows, table, dirty,
                       torch.cuda.current_stream(dev).cuda_stream)
    if launch_threads(rows, valid.shape[0]) or rows.heavy_blocks:
        with _count_lock:
            LAUNCHES += 1
            VARIANT_LAUNCHES[v.tag] = VARIANT_LAUNCHES.get(v.tag, 0) + 1
    return out
