"""Wrapper of the FlatFAT forest-rebuild kernel (``forest_rebuild.cu``).

``forest_rebuild(trees, tvalid, combine)`` recomputes the internal levels
of every key row in place and returns ``(trees, tvalid)``. A forest on the
CPU goes through the plain version (``reference.forest_rebuild_ref``); a
forest on a CUDA card launches the kernel, on PyTorch's current stream, or
raises. ``LAUNCHES`` counts the calls that launched it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Tuple

import torch

from ..basic import WindFlowError
from .build import load_library
from .reference import forest_rebuild_ref

MAX_FIELDS = 8
LAUNCHES = 0  # calls that launched the kernel (replica threads share it)
_count_lock = threading.Lock()

_DTYPES = {torch.int32: 0, torch.float32: 1}


def _bind(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_wf_bound", False):
        return
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wf_forest_rebuild.argtypes = [ctypes.POINTER(vp),
                                      ctypes.POINTER(ci),
                                      ctypes.POINTER(ci), ci, vp, ci, ci, vp]
    lib.wf_forest_rebuild.restype = ci
    lib.wf_error_string.argtypes = [ci]
    lib.wf_error_string.restype = ctypes.c_char_p
    lib._wf_bound = True


def forest_rebuild(trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
                   combine: Callable) -> Tuple[Dict[str, torch.Tensor],
                                               torch.Tensor]:
    if tvalid.device.type == "cpu":
        return forest_rebuild_ref(trees, tvalid, combine)
    global LAUNCHES
    if tvalid.device.type != "cuda":
        raise WindFlowError(f"forest_rebuild: no kernel for device "
                            f"{tvalid.device}")
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
    if F < 2 or F & (F - 1) or NN != 2 * F:
        raise WindFlowError(f"forest_rebuild: row length {NN} is not 2F "
                            "with F a power of two")
    if K * NN >= 2**31 - 1:
        raise WindFlowError("forest_rebuild: K_cap*2F overflows the int32 "
                            "index plane")
    if not 1 <= len(trees) <= MAX_FIELDS:
        raise WindFlowError(f"forest_rebuild: 1..{MAX_FIELDS} fields, got "
                            f"{len(trees)}")
    names = list(trees)
    for nm in names:
        t = trees[nm]
        if t.dtype not in _DTYPES or t.shape != tvalid.shape \
                or t.device != tvalid.device or not t.is_contiguous():
            raise WindFlowError(
                f"forest_rebuild: field {nm!r} must be a contiguous int32 or "
                f"float32 tensor shaped like tvalid on {tvalid.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if nm not in getattr(combine, "ops", {}):
            raise WindFlowError(f"forest_rebuild: combine has no op for "
                                f"field {nm!r}")
    lib = load_library("forest_rebuild")
    _bind(lib)
    n = len(names)
    ptrs = (ctypes.c_void_p * n)(*[trees[nm].data_ptr() for nm in names])
    is_float = (ctypes.c_int * n)(*[_DTYPES[trees[nm].dtype] for nm in names])
    ops = (ctypes.c_int * n)(*[combine.op_code(nm) for nm in names])
    with torch.cuda.device(tvalid.device):
        stream = torch.cuda.current_stream(tvalid.device).cuda_stream
        err = lib.wf_forest_rebuild(ptrs, is_float, ops, n,
                                    tvalid.data_ptr(), K, F, stream)
    if err != 0:
        raise RuntimeError("forest_rebuild kernel launch failed: "
                           + lib.wf_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
    return trees, tvalid
