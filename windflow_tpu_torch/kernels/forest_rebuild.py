"""Wrapper of the FlatFAT forest-rebuild kernel (K1, ``forest_rebuild.cuh``).

``forest_rebuild(trees, tvalid, combine)`` recomputes the internal levels
of every key row in place and returns ``(trees, tvalid)``. A forest on the
CPU goes through the plain version (``reference.forest_rebuild_ref``),
which calls any torch combine; a forest on a CUDA card launches the
kernel, on PyTorch's current stream, or raises.

The kernel takes what the Pallas kernel takes: any combine that can be
traced (``combine_trace``), over int32, float32 and bool planes, with any
field count up to ``GEN_MAX_FIELDS``. A ``fieldwise(...)`` combine of at
most 8 int32 / float32 fields runs in the fieldwise library
(``forest_rebuild.cu``, per-field op codes); every other combine is traced
once per plane dtypes (cached on the combine object), emitted as C++
(``combine_codegen``) and built into a library of its own
(``build.load_generated``). ``LAUNCHES`` counts the calls that launched
a kernel, ``VARIANT_LAUNCHES`` the same per variant (``"fieldwise"`` or
a traced variant's tag).

``launch_plan`` decides how the kernel runs, as a list of passes (one
launch each); ``forest_rebuild.cuh`` describes the three regimes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..basic import WindFlowError
from .build import load_generated, load_library
from .combine_codegen import kernel_source
from .combine_trace import CombineIR, trace_combine
from .reference import forest_rebuild_ref

MAX_FIELDS = 8        # fields of the fieldwise library
GEN_MAX_FIELDS = 64   # fields of a traced variant (its kernel parameters)
FIELDWISE = "fieldwise"
LAUNCHES = 0  # calls that launched the kernel (replica threads share it)
VARIANT_LAUNCHES: Dict[str, int] = {}
_count_lock = threading.Lock()

_WORD_DTYPES = {torch.int32: 0, torch.float32: 1}
PLANE_DTYPES = (torch.int32, torch.float32, torch.bool)

# the kernel's launch geometry (forest_rebuild.cu: WF_*)
WARP_THREADS = 128
CTA_STEP = 128          # nodes of a level one warp folds in the cta regime
SMEM_MAX = 232448       # H100: 227 KB of shared memory per block
SMEM_DEFAULT = 49152
CHUNK_LEAVES = 1024     # nodes of a level per block in the chunk regime
# largest row (leaves) folded by the warp regime; rows above it go to the
# cta regime, which measured faster at F 1,024 on the H100 (PERF.md)
WARP_MAX_F = 512
# leaf bytes per cta tile (one stage of the ring): 12 KB measured best of
# 8-48 KB at F 1,024 and 2,048 on the H100 (scripts/bench_torch_k1.py)
CTA_TILE_BYTES = 12288
#: nodes per lane in the warp regime -> most fields it takes (registers)
WARP_E_FIELDS = {4: 8, 8: 8, 16: 4}
CTA_MAX_FIELDS = 8  # the cta regime's fold keeps 4 nodes a field per lane
REGIMES = {"warp": 0, "cta": 1, "chunk": 2}


@dataclass(frozen=True)
class Pass:
    """One launch. ``regime`` "warp": lane groups of F / E lanes fold whole
    rows, E nodes per lane. "cta": persistent blocks fold tiles of ``rows``
    whole rows in shared memory, in ``steps`` of (W, S, E): chunks of S
    nodes of level W, E per lane. "chunk": blocks of ``rows`` chunks of S
    nodes of level W, folded level by level. ``smem``: dynamic shared
    memory in bytes."""
    regime: str
    W: int
    S: int
    E: int
    rows: int
    smem: int
    steps: Tuple[Tuple[int, int, int], ...] = ()


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def cta_steps(F: int) -> Tuple[Tuple[int, int, int], ...]:
    steps, W = [], F
    while W > 1:
        S = min(W, CTA_STEP)
        steps.append((W, S, 4 if S >= 4 else 1))
        W //= S
    return tuple(steps)


@functools.lru_cache(maxsize=256)
def launch_plan(K: int, F: int, n_fields: int, aligned: bool = True,
                warp_max_f: int = WARP_MAX_F,
                bool_planes: int = 0) -> Tuple[Pass, ...]:
    """The passes that rebuild a (K, 2F) forest of ``n_fields`` fields,
    ``bool_planes`` of them bool (one byte a node; the other planes are
    32-bit). ``aligned``: every plane starts on 16 bytes (the vector
    regimes' loads and stores need it). The warp and cta regimes take
    32-bit planes only, within their register limits; the chunk regime
    takes every forest."""
    nb = 4 * (n_fields - bool_planes) + bool_planes + 1  # bytes per node
    vector = aligned and bool_planes == 0
    if vector and 4 <= F <= warp_max_f:
        E = max(4, F // 32)
        if WARP_E_FIELDS.get(E, 0) >= n_fields:
            return (Pass("warp", F, F, E, 32 * E // F,
                         WARP_THREADS * E * nb),)
    if vector and F >= 16 and n_fields <= CTA_MAX_FIELDS:
        R = max(1, _pow2_floor(max(1, CTA_TILE_BYTES // (F * nb))))
        R = min(R, 1 << (K - 1).bit_length())
        smem = 3 * R * F * nb + 16
        if smem <= SMEM_MAX:
            return (Pass("cta", F, F, 4, R, smem, cta_steps(F)),)
    s_max = _pow2_floor(SMEM_MAX // (2 * nb))  # a chunk's heap of 2S nodes
    passes, W = [], F
    while W > 1:
        S = min(W, s_max)
        cpb = max(1, CHUNK_LEAVES // S)
        while cpb > 1 and cpb * 2 * S * nb > SMEM_DEFAULT:
            cpb >>= 1
        passes.append(Pass("chunk", W, S, 0, cpb, cpb * 2 * S * nb))
        W //= S
    return tuple(passes)


@dataclass(frozen=True)
class Variant:
    """The library a forest's combine runs in: ``tag`` is ``FIELDWISE``
    or a digest of the generated source ``text`` of the traced ``ir``."""
    tag: str
    ir: Optional[CombineIR] = None
    text: Optional[str] = None

    @property
    def library(self) -> str:
        """Its ``build.BUILD_INFO`` name."""
        return "forest_rebuild" if self.tag == FIELDWISE \
            else f"forest_rebuild-{self.tag}"

    def load(self) -> ctypes.CDLL:
        if self.tag == FIELDWISE:
            return load_library("forest_rebuild")
        return load_generated(self.tag, self.text)


def variant(combine: Callable, dtypes: Dict[str, torch.dtype]) -> Variant:
    """The K1 variant of ``combine`` over planes of ``dtypes`` (field ->
    dtype, in the planes' order): traced once, cached on the combine.
    Raises ``WindFlowError`` for a combine the kernel cannot take."""
    key = tuple(dtypes.items())
    cache = getattr(combine, "_wf_k1_variants", None)
    if cache is not None and key in cache:
        return cache[key]
    if len(dtypes) > GEN_MAX_FIELDS:
        raise WindFlowError(f"forest_rebuild: at most {GEN_MAX_FIELDS} "
                            f"fields, got {len(dtypes)}")
    if hasattr(combine, "op_code") and len(dtypes) <= MAX_FIELDS \
            and all(dt in _WORD_DTYPES for dt in dtypes.values()):
        missing = [f for f in dtypes if f not in combine.ops]
        if missing:
            raise WindFlowError(f"forest_rebuild: combine has no op for "
                                f"fields {missing}")
        v = Variant(FIELDWISE)
    else:
        ir = trace_combine(combine, dtypes)
        text = kernel_source(ir)
        v = Variant(hashlib.sha256(text.encode()).hexdigest()[:12], ir, text)
    try:
        if cache is None:
            cache = combine._wf_k1_variants = {}
        cache[key] = v
    except (AttributeError, TypeError):
        pass  # an object without attributes is traced on every call
    return v


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_wf_bound", False):
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wf_rebuild_pass.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ci),
                                    ci, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                    vp]
    lib.wf_rebuild_pass.restype = ci
    lib.wf_error_string.argtypes = [ci]
    lib.wf_error_string.restype = ctypes.c_char_p
    lib._wf_bound = True


def check_forest(trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
                 combine: Callable) -> Variant:
    """The forest's variant, or ``WindFlowError`` for a forest the kernel
    does not take."""
    if tvalid.dtype is not torch.bool or tvalid.dim() != 2 \
            or not tvalid.is_contiguous():
        raise WindFlowError("forest_rebuild: tvalid must be a contiguous "
                            "(K_cap, 2F) bool tensor")
    K, NN = tvalid.shape
    F = NN // 2
    if K < 1:
        raise WindFlowError("forest_rebuild: the forest has no rows")
    if F < 2 or F & (F - 1) or NN != 2 * F:
        raise WindFlowError(f"forest_rebuild: row length {NN} is not 2F "
                            "with F a power of two")
    if K * NN >= 2**31 - 1:
        raise WindFlowError("forest_rebuild: K_cap*2F overflows the int32 "
                            "index plane")
    if not trees:
        raise WindFlowError("forest_rebuild: the forest has no fields")
    for nm, t in trees.items():
        if t.dtype not in PLANE_DTYPES or t.shape != tvalid.shape \
                or t.device != tvalid.device or not t.is_contiguous():
            raise WindFlowError(
                f"forest_rebuild: field {nm!r} must be a contiguous int32, "
                f"float32 or bool tensor shaped like tvalid on "
                f"{tvalid.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    return variant(combine, {nm: t.dtype for nm, t in trees.items()})


def run_plan(lib: ctypes.CDLL, plan: Tuple[Pass, ...],
             trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
             combine: Optional[Callable], stream: int) -> None:
    """Launch every pass of ``plan`` on ``stream``. ``combine``: the
    ``fieldwise(...)`` combine whose op codes the fieldwise library reads;
    None for a traced variant (its combine is compiled in)."""
    _bind(lib)
    names = list(trees)
    n = len(names)
    K, NN = tvalid.shape
    ptrs = (ctypes.c_void_p * n)(*[trees[nm].data_ptr() for nm in names])
    kinds = None if combine is None else (ctypes.c_int * n)(
        *[combine.op_code(nm) + 3 * _WORD_DTYPES[trees[nm].dtype]
          for nm in names])
    for ps in plan:
        err = lib.wf_rebuild_pass(ptrs, kinds, n, tvalid.data_ptr(), K,
                                  NN // 2, REGIMES[ps.regime], ps.W, ps.S,
                                  ps.E, ps.rows, ps.smem, stream)
        if err != 0:
            raise RuntimeError("forest_rebuild kernel launch failed: "
                               + lib.wf_error_string(err).decode())


def forest_plan(trees: Dict[str, torch.Tensor],
                tvalid: torch.Tensor) -> Tuple[Pass, ...]:
    """The launch plan of this forest (its shape, planes and alignment)."""
    K, NN = tvalid.shape
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (tvalid, *trees.values()))
    n_bool = sum(t.dtype is torch.bool for t in trees.values())
    return launch_plan(K, NN // 2, len(trees), aligned, bool_planes=n_bool)


def forest_rebuild(trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
                   combine: Callable) -> Tuple[Dict[str, torch.Tensor],
                                               torch.Tensor]:
    if tvalid.device.type == "cpu":
        return forest_rebuild_ref(trees, tvalid, combine)
    global LAUNCHES
    if tvalid.device.type != "cuda":
        raise WindFlowError(f"forest_rebuild: no kernel for device "
                            f"{tvalid.device}")
    v = check_forest(trees, tvalid, combine)
    plan = forest_plan(trees, tvalid)
    lib = v.load()
    with torch.cuda.device(tvalid.device):
        stream = torch.cuda.current_stream(tvalid.device).cuda_stream
        run_plan(lib, plan, trees, tvalid,
                 combine if v.tag == FIELDWISE else None, stream)
    with _count_lock:
        LAUNCHES += 1
        VARIANT_LAUNCHES[v.tag] = VARIANT_LAUNCHES.get(v.tag, 0) + 1
    return trees, tvalid
