"""Build and load the port's hand-written CUDA kernels.

The sources in ``fxtpu_torch/csrc/`` are compiled at first use with
``nvcc`` (one process per source, all started together, then one link)
into one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers: the build takes seconds, not minutes).
The library lands in ``build/fxtpu_torch/`` beside the package, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached file.  Nothing here runs at import: a
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
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "fxtpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process compiled, or "" when it loaded a cached library.
build_log = ""
#: Seconds that build took (0.0 when a cached library was loaded).
build_seconds = 0.0


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


def declare(lib):
    """Set the argument types of the library's entry points (a pointer or
    a stream passed without them would be cut to 32 bits)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    D = ctypes.c_double
    signatures = {
        "fxt_fx_fused": [P] * 11 + [I] * 10 + [P],
        "fxt_fx_fused_i8": [P] * 12 + [I] * 10 + [D, P],
        "fxt_fx_ablate": [P] * 11 + [I] * 11 + [P],
        "fxt_fx_ablate_i8": [P] * 12 + [I] * 10 + [D, I, P],
        "fxt_spectrometer": [P] * 7 + [L] + [I] * 7 + [P],
        "fxt_copy_probe": [P] * 2 + [L] * 4 + [I] * 12 + [P],
        "fxt_overlap_probe": [P] * 3 + [I] * 13 + [P],
        "fxt_retile_probe": [P] * 5 + [I] * 5 + [P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = I, argtypes
    lib.fxt_error_string.restype = ctypes.c_char_p
    lib.fxt_error_string.argtypes = [I]
    return lib


def build_library(path: Path, sources) -> str:
    """Compile every source to an object file, all at once, and link them
    into the shared library ``path``; returns nvcc's output.  Raises with
    it when a step fails."""
    nvcc = nvcc_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources:
        obj = path.parent / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd)
    if failed is None:
        tmp = path.parent / f"{tag}.tmp"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            failed = (res.returncode, cmd)
        else:
            os.replace(tmp, path)   # atomic: concurrent builds race safely
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed is not None:
        raise RuntimeError(
            f"nvcc failed ({failed[0]}): {' '.join(failed[1])}\n{log}")
    return log


def load_kernels():
    """The loaded kernel library, compiling it first if no library for
    the current sources exists.  Raises with nvcc's output when the
    build fails."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            t0 = time.perf_counter()
            build_log = build_library(path, _sources())
            build_seconds = time.perf_counter() - t0
        _lib = declare(ctypes.CDLL(str(path)))
        return _lib


def check(lib, rc: int, what: str):
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.fxt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
