"""Build and load the port's hand-written CUDA kernels.

The sources in ``fxtpu_torch/csrc/`` are compiled at first use with
``nvcc`` into one shared library with a plain C interface, which is loaded
with ``ctypes`` (no PyTorch headers: the build takes seconds, not
minutes).  The library lands in ``build/fxtpu_torch/`` beside the package,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the cached file.  Nothing here runs at import: a
machine without ``nvcc`` imports the port and uses its plain PyTorch
versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "fxtpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process compiled, or "" when it loaded a cached library.
build_log = ""


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME): the CUDA kernels of "
        "fxtpu_torch are built from fxtpu_torch/csrc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfxtpu_torch_{h.hexdigest()[:16]}.so"


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fxt_fx_fused.restype = I
    lib.fxt_fx_fused.argtypes = [P] * 11 + [I] * 10 + [P]
    lib.fxt_fx_fused_i8.restype = I
    lib.fxt_fx_fused_i8.argtypes = [P] * 12 + [I] * 10 + [ctypes.c_double, P]
    lib.fxt_spectrometer.restype = I
    lib.fxt_spectrometer.argtypes = ([P] * 7 + [ctypes.c_longlong]
                                     + [I] * 7 + [P])
    lib.fxt_error_string.restype = ctypes.c_char_p
    lib.fxt_error_string.argtypes = [I]
    return lib


def load_kernels():
    """The loaded kernel library, compiling it first if no library for
    the current sources exists.  Raises with nvcc's output when the
    build fails."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, _sources())]
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                    f"{build_log}")
            os.replace(tmp, path)   # atomic: concurrent builders race safely
        _lib = _declare(ctypes.CDLL(str(path)))
        return _lib


def check(lib, rc: int, what: str):
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.fxt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
