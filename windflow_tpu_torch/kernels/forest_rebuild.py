"""Wrapper of the FlatFAT forest-rebuild kernel (``forest_rebuild.cu``).

``forest_rebuild(trees, tvalid, combine)`` recomputes the internal levels
of every key row in place and returns ``(trees, tvalid)``. A forest on the
CPU goes through the plain version (``reference.forest_rebuild_ref``); a
forest on a CUDA card launches the kernel, on PyTorch's current stream, or
raises. ``LAUNCHES`` counts the calls that launched it.

``launch_plan`` decides how the kernel runs, as a list of passes (one
launch each); ``forest_rebuild.cu`` describes the three regimes.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..basic import WindFlowError
from .build import load_library
from .reference import forest_rebuild_ref

MAX_FIELDS = 8
LAUNCHES = 0  # calls that launched the kernel (replica threads share it)
_count_lock = threading.Lock()

_DTYPES = {torch.int32: 0, torch.float32: 1}

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
                warp_max_f: int = WARP_MAX_F) -> Tuple[Pass, ...]:
    """The passes that rebuild a (K, 2F) forest of ``n_fields`` fields.
    ``aligned``: every plane starts on 16 bytes (the vector regimes'
    loads and stores need it)."""
    nb = 4 * n_fields + 1  # bytes per node
    if aligned and 4 <= F <= warp_max_f:
        E = max(4, F // 32)
        if WARP_E_FIELDS.get(E, 0) >= n_fields:
            return (Pass("warp", F, F, E, 32 * E // F,
                         WARP_THREADS * E * nb),)
    if aligned and F >= 16:
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
                 combine: Callable) -> None:
    """Raise ``WindFlowError`` for a forest the kernel does not take."""
    if not hasattr(combine, "op_code"):
        raise WindFlowError(
            "forest_rebuild: the CUDA kernel folds fieldwise(...) combines "
            "only; an arbitrary callable runs on device='cpu'")
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
    if not 1 <= len(trees) <= MAX_FIELDS:
        raise WindFlowError(f"forest_rebuild: 1..{MAX_FIELDS} fields, got "
                            f"{len(trees)}")
    for nm, t in trees.items():
        if t.dtype not in _DTYPES or t.shape != tvalid.shape \
                or t.device != tvalid.device or not t.is_contiguous():
            raise WindFlowError(
                f"forest_rebuild: field {nm!r} must be a contiguous int32 or "
                f"float32 tensor shaped like tvalid on {tvalid.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if nm not in getattr(combine, "ops", {}):
            raise WindFlowError(f"forest_rebuild: combine has no op for "
                                f"field {nm!r}")


def run_plan(lib: ctypes.CDLL, plan: Tuple[Pass, ...],
             trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
             combine: Callable, stream: int) -> None:
    """Launch every pass of ``plan`` on ``stream``."""
    _bind(lib)
    names = list(trees)
    n = len(names)
    K, NN = tvalid.shape
    ptrs = (ctypes.c_void_p * n)(*[trees[nm].data_ptr() for nm in names])
    kinds = (ctypes.c_int * n)(*[combine.op_code(nm)
                                 + 3 * _DTYPES[trees[nm].dtype]
                                 for nm in names])
    for ps in plan:
        err = lib.wf_rebuild_pass(ptrs, kinds, n, tvalid.data_ptr(), K,
                                  NN // 2, REGIMES[ps.regime], ps.W, ps.S,
                                  ps.E, ps.rows, ps.smem, stream)
        if err != 0:
            raise RuntimeError("forest_rebuild kernel launch failed: "
                               + lib.wf_error_string(err).decode())


def forest_rebuild(trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
                   combine: Callable) -> Tuple[Dict[str, torch.Tensor],
                                               torch.Tensor]:
    if tvalid.device.type == "cpu":
        return forest_rebuild_ref(trees, tvalid, combine)
    global LAUNCHES
    if tvalid.device.type != "cuda":
        raise WindFlowError(f"forest_rebuild: no kernel for device "
                            f"{tvalid.device}")
    check_forest(trees, tvalid, combine)
    K, NN = tvalid.shape
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (tvalid, *trees.values()))
    plan = launch_plan(K, NN // 2, len(trees), aligned)
    lib = load_library("forest_rebuild")
    with torch.cuda.device(tvalid.device):
        stream = torch.cuda.current_stream(tvalid.device).cuda_stream
        run_plan(lib, plan, trees, tvalid, combine, stream)
    with _count_lock:
        LAUNCHES += 1
    return trees, tvalid
