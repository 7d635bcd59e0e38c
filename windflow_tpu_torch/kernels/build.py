"""Builds the port's CUDA kernels on first use.

Each ``kernels/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``; the
wrappers pass tensor pointers (``data_ptr()``) and PyTorch's current
stream as integers. No source includes PyTorch's headers, so a build takes
seconds rather than the minutes a ``torch/extension.h`` build takes.

The library lands in ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), or in the compile cache directory that
``PipeGraph.with_compile_cache`` sets (``set_cache_dir``, process-wide),
named by a digest of the source, the headers (``kernels/*.cuh``) and the
flags, so an edited source is never served by a stale build, and a
current build there is loaded without running ``nvcc``. A traced
combine's variant of K1, and a traced stateful step's K8, is a generated
translation unit (``load_generated``), written and built there too.
Nothing is compiled when the module is imported: ``load_library`` and
``load_generated`` build on the first call that needs the card; builds
of different libraries may run in parallel threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from ..basic import WindFlowError

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_build_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# the compile cache directory (set_cache_dir); None: BUILD_DIR
_cache_dir: Optional[Path] = None
#: per library: {"seconds": build time (0.0 when reused), "log": nvcc output}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise WindFlowError("nvcc not found (set CUDA_HOME): the CUDA "
                            "kernels are built from source on first use")
    return found


def set_cache_dir(path: Optional[str]) -> None:
    """Build and load the kernel libraries in ``path`` from now on (None:
    ``build/kernels/`` again). Process-wide, as the JAX package's
    ``jax.config`` compile cache is: it holds for every graph of the
    process, and a library already loaded stays loaded."""
    global _cache_dir
    _cache_dir = None if path is None else Path(path)


def build_dir() -> Path:
    """Where libraries are built and looked up: the compile cache
    directory if one is set, else ``build/kernels/``."""
    return BUILD_DIR if _cache_dir is None else _cache_dir


def _headers() -> bytes:
    """Every header of the kernel directory (a source may include any)."""
    return b"".join(p.read_bytes() for p in sorted(KERNEL_DIR.glob("*.cuh")))


def _load(name: str, text: bytes,
          src: Optional[Path] = None) -> ctypes.CDLL:
    """Build (unless a current build exists) and load library ``name``
    from ``text`` (written next to the build when ``src`` is None). One
    build per name at a time; builds of different names run in
    parallel."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        with _lock:
            lib = _libs.get(name)
        if lib is not None:
            return lib
        digest = hashlib.sha256(text + _headers()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        where = build_dir()
        out = where / f"{name}-{digest[:16]}.so"
        info = {"seconds": 0.0, "log": ""}
        if not out.exists():
            where.mkdir(parents=True, exist_ok=True)
            if src is None:
                # another process may build the same text into a shared
                # cache directory: the source appears whole or not at all
                src = out.with_suffix(".cu")
                tmp_src = out.with_suffix(f".{os.getpid()}.cu.tmp")
                tmp_src.write_bytes(text)
                os.replace(tmp_src, src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([nvcc_path(), *NVCC_FLAGS,
                                  f"-I{KERNEL_DIR}", "-o", str(tmp),
                                  str(src)], capture_output=True, text=True)
            info["seconds"] = time.perf_counter() - t0
            info["log"] = res.stdout + res.stderr
            if res.returncode != 0:
                raise WindFlowError(f"nvcc failed on {src.name}:\n"
                                    + info["log"])
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        with _lock:
            BUILD_INFO[name] = info
            _libs[name] = lib
        return lib


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``kernels/<name>.cu``, built if no current build
    exists. Thread-safe; later calls return the loaded library (every
    launch asks: the source is read only until it is loaded)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = KERNEL_DIR / f"{name}.cu"
    return _load(name, src.read_bytes(), src)


def load_generated(tag: str, text: str,
                   kind: str = "forest_rebuild") -> ctypes.CDLL:
    """A generated translation unit (``combine_codegen``: a traced
    variant of K1, or with ``kind`` "grid_scan" a traced step of K8),
    built into ``<build_dir()>/<kind>-<tag>-<digest>.so`` (the digest
    covers the text, the headers and the flags) and loaded; its
    ``BUILD_INFO`` entry is ``<kind>-<tag>``. A failed build raises with
    the nvcc log."""
    name = f"{kind}-{tag}"
    lib = _libs.get(name)
    if lib is not None:
        return lib
    return _load(name, text.encode())
