"""Wrappers of the FFAT step's kernels (``ffat_step.cuh``) and their plain
versions.

- ``ingest_fold`` (K2+K3): the segmented fold of a batch's rows by their
  packed composite key (slot * F + leaf; the sentinel, the forest's rows
  times F, for late and padding rows), given as the stable sort's
  ``order`` and sorted keys (``sort_rows``), merged into the forest's
  leaves. The plain version ``ingest_fold_ref`` is the Hillis-Steele scan
  of ``gpu/scan.py``, the tail gather, the combine and the ``index_put_``
  the FFAT replica ran before the kernel. The kernel's tiles find their
  carry through a scratch per device and stream: status words tagged
  with a sequence number per launch, so no launch clears them, in a
  buffer of their own beside the tiles' published rows
  (``ingest_scratch``; ``reserve_ingest_scratch`` makes it before a
  stream's first batch).
- ``fire_query`` (K4): the window query of every fire lane, then the
  eviction of the fire step's leaves and the key column; the plain
  version ``fire_query_ref`` is ``window_query`` (the ``LOGQ``-step tree
  walk), the eviction scatter and the key gather.

A tensor on the CPU goes through the plain version; on a CUDA card the
wrapper checks its arguments and launches the kernel on PyTorch's current
stream, or raises: nothing falls back. The kernels take every combine K1
takes, from the same library: ``forest_rebuild.variant`` (the fieldwise
library, or the traced combine's own, which also holds these kernels).
``INGEST_LAUNCHES`` / ``QUERY_LAUNCHES`` count the calls that launched a
kernel, ``INGEST_VARIANT_LAUNCHES`` / ``QUERY_VARIANT_LAUNCHES`` the same
by variant tag.

The fire arguments travel as one int32 buffer (``fire_pack``): the
``(5, W)`` fire pack (slot, start, len, wid, mask), the ``(3, E)`` evict
pack (slot, leaf, mask) and the ``(2, B + 1)`` lane bounds of the query
kernel's blocks (``fire_blocks``, ``QUERY_LANES`` windows a block, eight
lanes a window): each block owns whole chunks, one chunk per slot, so it
evicts its slots' leaves after its own queries.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..basic import WindFlowError
from . import forest_rebuild as fr
from ..gpu.scan import segmented_scan

INGEST_LAUNCHES = 0
QUERY_LAUNCHES = 0
INGEST_VARIANT_LAUNCHES: Dict[str, int] = {}
QUERY_VARIANT_LAUNCHES: Dict[str, int] = {}
_count_lock = threading.Lock()

QUERY_LANES = 32  # ffat_step.cuh: WF_QUERY_WINDOWS, fire lanes a block
INGEST_THREADS = 128  # ffat_step.cuh: WF_INGEST_THREADS, the least rows a tile
COMP_DTYPES = (torch.int16, torch.int32)
KEY_BYTES = (1, 2, 4, 8)
# K2+K3's scratch per (device index, stream): [status buffer, rows buffer,
# last sequence number] (ingest_scratch); the kernel tags its status words
# with the number, 1 to 2^30 - 1
_SCRATCH: Dict[Tuple[Optional[int], int], list] = {}
SEQ_LIMIT = 1 << 30


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def comb_valid(combine: Callable, va, a, vb, b):
    """Ordered combine with validity: an invalid side passes the other
    through (None-as-identity, like the CPU FlatFAT); ``a`` is the earlier
    side."""
    both = va & vb
    merged = combine(a, b)
    return va | vb, {k: torch.where(both, merged[k],
                                    torch.where(va, a[k], b[k]))
                     for k in a}


def _range_query(combine: Callable, flat, vflat, base, lo, length, F: int):
    """Ordered combine of physical leaf range [lo, lo+length) of the tree
    rows at flat offsets ``base``: iterative segment-tree walk, left/right
    accumulators keep combine order."""
    nn = 2 * F
    W = base.shape[0]
    zero = {k: torch.zeros(W, dtype=b.dtype, device=base.device)
            for k, b in flat.items()}
    off = torch.zeros(W, dtype=torch.bool, device=base.device)
    lv, la, rv, ra = off, zero, off, zero
    l, r = lo + F, lo + length + F
    for _ in range(nn.bit_length()):
        take_l = ((l & 1) == 1) & (l < r)
        il = base + l.clamp(0, nn - 1)
        lv, la = comb_valid(combine, lv, la, vflat[il] & take_l,
                            {k: b[il] for k, b in flat.items()})
        l = torch.where(take_l, l + 1, l)
        take_r = ((r & 1) == 1) & (l < r)
        ir = base + (r - 1).clamp(0, nn - 1)
        rv, ra = comb_valid(combine, vflat[ir] & take_r,
                            {k: b[ir] for k, b in flat.items()}, rv, ra)
        r = torch.where(take_r, r - 1, r)
        l, r = l >> 1, r >> 1
    return comb_valid(combine, lv, la, rv, ra)


def window_query(combine: Callable, flat: Dict[str, torch.Tensor],
                 vflat: torch.Tensor, base, start, length, F: int):
    """``(valid, values)``: the ordered combine of ring range ``[start,
    start + length)`` (physical leaves, wrapping past F: at most two
    ranges) of each tree row at flat offset ``base`` of the flat forest
    planes ``flat`` / ``vflat``."""
    len1 = torch.minimum(length, F - start)
    v1, r1 = _range_query(combine, flat, vflat, base, start, len1, F)
    v2, r2 = _range_query(combine, flat, vflat, base,
                          torch.zeros_like(start), length - len1, F)
    return comb_valid(combine, v1, r1, v2, r2)


def ingest_fold_ref(combine: Callable, vals: Dict[str, torch.Tensor],
                    comp: torch.Tensor, order: torch.Tensor,
                    flat: Dict[str, torch.Tensor], vflat: torch.Tensor,
                    F: int) -> None:
    """Plain K2+K3, in place: the rows sorted by ``comp[order]``, the
    inclusive segmented scan of each run of equal keys below the sentinel
    (the forest's rows times F) with ``combine``, and each run's tail
    merged into its leaf ``(key // F) * 2F + F + key % F``
    (``combine(leaf, tail)`` where the leaf is valid, else the tail) and
    marked valid."""
    _fold_sorted(combine, vals, order, comp[order.long()], flat, vflat, F)


def _fold_sorted(combine: Callable, vals: Dict[str, torch.Tensor],
                 order: torch.Tensor, skeys: torch.Tensor,
                 flat: Dict[str, torch.Tensor], vflat: torch.Tensor,
                 F: int) -> None:
    """``ingest_fold_ref`` on the sorted keys ``skeys`` (``comp[order]``)."""
    o = order.long()
    sc = skeys.to(torch.int32)
    if sc.numel() == 0:
        return
    dev = sc.device
    same_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                           sc[1:] == sc[:-1]])
    is_end = torch.cat([sc[1:] != sc[:-1],
                        torch.ones(1, dtype=torch.bool, device=dev)]) \
        & (sc < vflat.numel() // 2)
    scanned = segmented_scan(combine, {k: vals[k][o] for k in flat},
                             same_prev)
    tails = is_end.nonzero().squeeze(1)
    st = sc[tails].long()
    idx = (st // F) * (2 * F) + F + st % F
    tail = {k: v[tails] for k, v in scanned.items()}
    lv = vflat[idx]
    merged = combine({k: b[idx] for k, b in flat.items()}, tail)
    new = {k: torch.where(lv, merged[k], tail[k]) for k in flat}
    for k, b in flat.items():
        b[idx] = new[k].to(b.dtype)
    vflat[idx] = True


def fire_query_ref(combine: Callable, flat: Dict[str, torch.Tensor],
                   vflat: torch.Tensor, F: int, f_pack: torch.Tensor,
                   e_pack: Optional[torch.Tensor] = None,
                   ktable: Optional[torch.Tensor] = None):
    """Plain K4: ``(values, valid & mask, key column or None)`` of every
    fire lane, then the evicted leaves' validity cleared in place."""
    slots, starts, lens, _wids, mask_i = f_pack
    mask = mask_i != 0
    qv, qr = window_query(combine, flat, vflat, slots * (2 * F), starts,
                          lens, F)
    qv = qv & mask
    if e_pack is not None and e_pack.shape[1]:
        e_slots, e_leaves, e_mask = e_pack
        sel = e_mask != 0
        vflat[(e_slots.long() * (2 * F) + F + e_leaves)[sel]] = False
    key = None
    if ktable is not None:
        key = torch.where(mask, ktable[slots.long()],
                          torch.zeros((), dtype=ktable.dtype,
                                      device=ktable.device))
    return qr, qv, key


# ---------------------------------------------------------------------------
# the fire arguments
# ---------------------------------------------------------------------------
def fire_blocks(c_k: np.ndarray, ne: np.ndarray, n_out: int, W: int,
                lanes: int = QUERY_LANES) -> np.ndarray:
    """``(2, B + 1)`` int32: block b of the query kernel takes fire lanes
    ``[r0[b], r0[b+1])`` and evict lanes ``[r1[b], r1[b+1])``. Chunk c (a
    slot's ``c_k[c]`` windows and ``ne[c]`` evicted leaves, laid out chunk
    by chunk) belongs to the block its first fire lane falls in, so a
    block holds whole chunks; the padding lanes ``[n_out, W)`` follow in
    blocks of their own, with no eviction."""
    fk = np.concatenate([[0], np.cumsum(c_k)]).astype(np.int64)
    fe = np.concatenate([[0], np.cumsum(ne)]).astype(np.int64)
    b0 = -(-n_out // lanes)
    cb = np.searchsorted(fk[:-1] // lanes, np.arange(b0 + 1), side="left")
    pad = np.minimum(n_out + lanes * np.arange(1, -(-(W - n_out) // lanes)
                                               + 1), W)
    return np.stack([np.concatenate([fk[cb], pad]),
                     np.concatenate([fe[cb], np.full(len(pad), fe[-1])])]
                    ).astype(np.int32)


def fire_pack(f_pack: np.ndarray, e_pack: np.ndarray, c_k: np.ndarray,
              ne: np.ndarray, n_out: int) -> np.ndarray:
    """The fire step's arguments as one int32 buffer (one copy to the
    card): the fire pack, the evict pack, then ``fire_blocks``."""
    return np.concatenate([f_pack.ravel(), e_pack.ravel(),
                           fire_blocks(c_k, ne, n_out, f_pack.shape[1])
                           .ravel()])


def lane_blocks(W: int, device: torch.device) -> torch.Tensor:
    """``fire_blocks`` of ``W`` fire lanes with no eviction (one chunk a
    lane), on ``device``."""
    one = np.ones(W, dtype=np.int64)
    return torch.from_numpy(fire_blocks(one, one * 0, W, W)).to(device)


def split_fire_pack(t: torch.Tensor, W: int, E: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(f_pack, e_pack, blocks)`` views of a ``fire_pack`` buffer."""
    return (t[:5 * W].view(5, W), t[5 * W:5 * W + 3 * E].view(3, E),
            t[5 * W + 3 * E:].view(2, -1))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def sort_rows(comp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, sorted keys)`` of the packed composites ``comp``: the
    stable sort's int32 order and its values, what ``ingest_fold`` takes
    (one sort, one cast)."""
    s = torch.sort(comp, stable=True)
    return s.indices.to(torch.int32), s.values


def ingest_scratch_words(n: int, n_fields: int) -> Tuple[int, int]:
    """int32 words of K2+K3's scratch for ``n`` rows of ``n_fields``
    planes: ``(status, rows)``, the tile ticket and a status word a tile,
    then a tile's aggregate and inclusive prefix (a word a field each). A
    tile holds at least INGEST_THREADS rows (``ffat_step.cuh``:
    ingest_items rows a thread), so neither is less than the kernel checks
    for. The status words depend on ``n`` alone."""
    tiles = -(-n // INGEST_THREADS)
    return 1 + tiles, 2 * tiles * n_fields


def _pow2(words: int) -> int:
    return 1 << max(words - 1, 1).bit_length()


def _scratch_entry(dev: torch.device, stream: int, n: int) -> list:
    """The (device, stream)'s entry, its status buffer covering ``n``
    rows: made zeroed (a power of two of words) when there is none, when
    it is too small or when the numbers run out. Under ``_count_lock``."""
    key, words = (dev.index, stream), ingest_scratch_words(n, 0)[0]
    ent = _SCRATCH.get(key)
    if ent is None or ent[0].numel() < words or ent[2] + 1 >= SEQ_LIMIT:
        rows = ent[1] if ent is not None else \
            torch.empty(0, dtype=torch.int32, device=dev)
        ent = _SCRATCH[key] = [torch.zeros(_pow2(words), dtype=torch.int32,
                                           device=dev), rows, 0]
    return ent


def ingest_scratch(dev: torch.device, stream: int, n: int, n_fields: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K2+K3's scratch on ``dev`` for a launch over ``n`` rows of
    ``n_fields`` planes on ``stream``: ``(status, rows, sequence
    number)``. One pair of buffers per device and stream: launches on one
    stream run in order, and a new number each launch leaves the status
    words of earlier launches stale without a clear. The status buffer
    holds status words only, at places that depend on the tile alone,
    so a value can never read as a status; it is zeroed once, when made.
    The rows' buffer is never read before the launch writes it, so it is
    grown with no fill."""
    words = ingest_scratch_words(n, n_fields)[1]
    with _count_lock:
        ent = _scratch_entry(dev, stream, n)
        if ent[1].numel() < words:
            ent[1] = torch.empty(_pow2(words), dtype=torch.int32, device=dev)
        ent[2] += 1
        return ent[0], ent[1], ent[2]


def reserve_ingest_scratch(dev: torch.device, n: int) -> None:
    """Make K2+K3's status buffer for batches of up to ``n`` rows on
    ``dev``'s current stream now, so its one zero fill lands before the
    stream's first batch (a replica's prewarm, a mesh's init). Nothing on
    the CPU, whose plain version needs none."""
    if dev.type != "cuda" or n < 1:
        return
    stream = _current_stream(dev)
    with _count_lock:
        _scratch_entry(dev, stream, n)


def _current_stream(dev: torch.device) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_wf_ffat_bound", False):
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pvp, pci = ctypes.POINTER(vp), ctypes.POINTER(ci)
    lib.wf_ffat_ingest.argtypes = [pvp, pvp, pci, ci, vp, vp, ci, vp, ci,
                                   ci, ci, vp, ci, vp, ci, ctypes.c_uint, vp]
    lib.wf_ffat_ingest.restype = ci
    lib.wf_ffat_query.argtypes = [pvp, pci, ci, vp, ci, ci, vp, ci, vp, ci,
                                  vp, ci, pvp, vp, vp, vp, ci, vp]
    lib.wf_ffat_query.restype = ci
    lib.wf_error_string.argtypes = [ci]
    lib.wf_error_string.restype = ctypes.c_char_p
    lib._wf_ffat_bound = True


def _flat_1d(what: str, t: torch.Tensor, dtypes, n: int,
             device: torch.device) -> None:
    if t.dtype not in dtypes or t.dim() != 1 or t.numel() != n \
            or not t.is_contiguous() or t.device != device:
        raise WindFlowError(
            f"ffat_step: {what} must be a contiguous 1-D "
            f"{'/'.join(str(d).replace('torch.', '') for d in dtypes)} "
            f"tensor of {n} elements on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def check_planes(flat: Dict[str, torch.Tensor], vflat: torch.Tensor,
                 combine: Callable, F: int) -> fr.Variant:
    """The flat forest's variant, or ``WindFlowError`` for planes the
    kernels do not take (the int32 index guard included)."""
    n = vflat.numel()
    _flat_1d("vflat", vflat, (torch.bool,), n, vflat.device)
    if F < 2 or F & (F - 1):
        raise WindFlowError(f"ffat_step: F = {F} is not a power of two")
    if n < 2 * F or n % (2 * F):
        raise WindFlowError(f"ffat_step: {n} nodes are not rows of 2F = "
                            f"{2 * F}")
    if n >= 2**31 - 1:
        raise WindFlowError(f"ffat_step: {n} nodes overflow the int32 "
                            "index plane")
    if not flat:
        raise WindFlowError("ffat_step: the forest has no fields")
    for nm, t in flat.items():
        _flat_1d(f"plane {nm!r}", t, fr.PLANE_DTYPES, n, vflat.device)
    return fr.variant(combine, {nm: t.dtype for nm, t in flat.items()})


def _kinds(v: fr.Variant, combine: Callable, flat: Dict[str, torch.Tensor]):
    """The fieldwise library's op codes (None for a traced variant)."""
    if v.tag != fr.FIELDWISE:
        return None
    return (ctypes.c_int * len(flat))(
        *[combine.op_code(nm) + 3 * fr._WORD_DTYPES[t.dtype]
          for nm, t in flat.items()])


def _ptrs(ts) -> ctypes.Array:
    ts = list(ts)
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.wf_error_string(err).decode())


def _cuda_or_raise(what: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise WindFlowError(f"{what}: no kernel for device {dev}")


def ingest_fold(combine: Callable, vals: Dict[str, torch.Tensor],
                sorted_rows: Tuple[torch.Tensor, torch.Tensor],
                flat: Dict[str, torch.Tensor], vflat: torch.Tensor,
                F: int) -> None:
    """K2+K3 in place (see the module docstring): the rows' lifted
    ``vals`` (unsorted, the planes' dtypes) and ``sorted_rows``, the
    stable sort of their packed keys (``sort_rows``: the int32 order and
    the sorted int16 or int32 keys), folded into the flat forest ``flat``
    / ``vflat`` of rows of 2F nodes."""
    dev = vflat.device
    order, sorted_keys = sorted_rows
    n = order.numel()
    _flat_1d("order", order, (torch.int32,), n, dev)
    _flat_1d("sorted_keys", sorted_keys, COMP_DTYPES, n, dev)
    if dev.type == "cpu":
        _fold_sorted(combine, vals, order, sorted_keys, flat, vflat, F)
        return
    global INGEST_LAUNCHES
    _cuda_or_raise("ingest_fold", dev)
    v = check_planes(flat, vflat, combine, F)
    if set(vals) != set(flat):
        raise WindFlowError(f"ingest_fold: value columns {sorted(vals)} "
                            f"are not the planes {sorted(flat)}")
    for nm, t in flat.items():
        _flat_1d(f"value column {nm!r}", vals[nm], (t.dtype,), n, dev)
    sentinel = vflat.numel() // 2  # rows * F
    if sentinel > torch.iinfo(sorted_keys.dtype).max:
        raise WindFlowError(f"ingest_fold: the sentinel {sentinel} does "
                            f"not fit {sorted_keys.dtype}")
    if n == 0:
        return
    lib = v.load()
    _bind(lib)
    stream = _current_stream(dev)
    status, rows, seq = ingest_scratch(dev, stream, n, len(flat))
    with torch.cuda.device(dev):
        err = lib.wf_ffat_ingest(
            _ptrs(flat.values()), _ptrs(vals[nm] for nm in flat),
            _kinds(v, combine, flat), len(flat), vflat.data_ptr(),
            sorted_keys.data_ptr(), sorted_keys.element_size(),
            order.data_ptr(), n, F, sentinel, status.data_ptr(),
            status.numel(), rows.data_ptr(), rows.numel(), seq, stream)
    _raise_on(lib, err, "ffat ingest")
    with _count_lock:
        INGEST_LAUNCHES += 1
        INGEST_VARIANT_LAUNCHES[v.tag] = \
            INGEST_VARIANT_LAUNCHES.get(v.tag, 0) + 1


def _check_pack(what: str, t: torch.Tensor, rows: int,
                dev: torch.device) -> int:
    if t.dtype is not torch.int32 or t.dim() != 2 or t.shape[0] != rows \
            or not t.is_contiguous() or t.device != dev:
        raise WindFlowError(f"fire_query: {what} must be a contiguous "
                            f"({rows}, n) int32 tensor on {dev}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.shape[1]


def fire_query(combine: Callable, flat: Dict[str, torch.Tensor],
               vflat: torch.Tensor, F: int, f_pack: torch.Tensor,
               e_pack: Optional[torch.Tensor] = None,
               blocks: Optional[torch.Tensor] = None,
               ktable: Optional[torch.Tensor] = None):
    """K4: ``(values, valid & mask, key column or None)`` of each lane of
    the ``(5, W)`` fire pack over the flat forest, then the ``(3, E)``
    evict pack's leaves cleared (in place). ``blocks``: ``fire_blocks``
    of the packs (``lane_blocks`` with no evict pack), needed on a card
    (the plain version ignores it). ``ktable``: the per-slot key
    table."""
    if vflat.device.type == "cpu":
        return fire_query_ref(combine, flat, vflat, F, f_pack, e_pack,
                              ktable)
    global QUERY_LAUNCHES
    _cuda_or_raise("fire_query", vflat.device)
    dev = vflat.device
    W = _check_pack("the fire pack", f_pack, 5, dev)
    if W == 0:  # a mesh group that holds no key rows
        return ({nm: t.new_empty(0) for nm, t in flat.items()},
                torch.empty(0, dtype=torch.bool, device=dev),
                None if ktable is None else ktable.new_empty(0))
    v = check_planes(flat, vflat, combine, F)
    E = 0 if e_pack is None else _check_pack("the evict pack", e_pack, 3,
                                             dev)
    if blocks is None:
        raise WindFlowError("fire_query: the kernel needs the block bounds "
                            "(fire_blocks)")
    B = _check_pack("the block bounds", blocks, 2, dev) - 1
    if B < 1:
        raise WindFlowError("fire_query: no block bounds")
    if ktable is not None:
        if ktable.dim() != 1 or not ktable.is_contiguous() \
                or ktable.device != dev \
                or ktable.element_size() not in KEY_BYTES:
            raise WindFlowError("fire_query: the key table must be a "
                                f"contiguous 1-D tensor on {dev}")
    qr = {nm: torch.empty(W, dtype=t.dtype, device=dev)
          for nm, t in flat.items()}
    qv = torch.empty(W, dtype=torch.bool, device=dev)
    key = None if ktable is None else torch.empty(W, dtype=ktable.dtype,
                                                  device=dev)
    lib = v.load()
    _bind(lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wf_ffat_query(
            _ptrs(flat.values()), _kinds(v, combine, flat), len(flat),
            vflat.data_ptr(), vflat.numel() // (2 * F), F, f_pack.data_ptr(),
            W, None if E == 0 else e_pack.data_ptr(), E,
            blocks.data_ptr(), B,
            _ptrs(qr.values()), qv.data_ptr(),
            None if ktable is None else ktable.data_ptr(),
            None if key is None else key.data_ptr(),
            0 if ktable is None else ktable.element_size(), stream)
    _raise_on(lib, err, "ffat query")
    with _count_lock:
        QUERY_LAUNCHES += 1
        QUERY_VARIANT_LAUNCHES[v.tag] = \
            QUERY_VARIANT_LAUNCHES.get(v.tag, 0) + 1
    return qr, qv, key
