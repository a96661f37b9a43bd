"""Build and load the port's host data-plane library.

The C++ sources in ``fxtpu_torch/csrc/host/`` (the lock-free SPSC ring
buffer and the int8 loops of int8 ingest) are compiled at first use with
``$CXX`` (else ``g++``) and the flags of ``fxtpu``'s ``native/Makefile``
into one shared library with a plain C interface, which
:mod:`fxtpu_torch.runtime.native` loads with ``ctypes``.  The library
lands in ``build/fxtpu_torch/`` beside the CUDA kernels' (``cuda_build``),
named by a hash of the sources, the flags, the compiler's version line
and the machine: ``-march=native`` makes the file valid only on a CPU like
the one that built it, so the machine's architecture and its CPU's model
and flags are in the name.  An edited source, another compiler or another
CPU builds anew; otherwise the cached file loads.  The build needs no
``nvcc`` and no card.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

HOST_CSRC = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "fxtpu_torch"
#: ``native/Makefile``'s CXXFLAGS; the link adds ``-shared`` and LIBS.
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_lib = None
#: The compiler's output of the build this process made, or "" when it
#: loaded a cached library.
build_log = ""
#: Seconds that build took (0.0 when a cached library was loaded).
build_seconds = 0.0
#: The file this process loaded.
loaded_path: Optional[Path] = None


def compiler() -> Optional[List[str]]:
    """The compiler command: ``$CXX`` (split as a shell would) when set,
    else ``g++`` on the PATH; None when there is neither."""
    cxx = os.environ.get("CXX", "").strip()
    if cxx:
        return shlex.split(cxx)
    gxx = shutil.which("g++")
    return [gxx] if gxx else None


def compiler_version(cxx: List[str]) -> str:
    """The first line ``cxx --version`` prints (its error output when it
    fails: the build that follows reports the failure)."""
    try:
        res = subprocess.run([*cxx, "--version"], capture_output=True,
                             text=True, timeout=60)
        out = res.stdout or res.stderr
    except OSError as e:
        out = str(e)
    return out.strip().splitlines()[0] if out.strip() else ""


def cpu_identity() -> str:
    """The machine's architecture and its CPU's model name and flags
    (``/proc/cpuinfo``'s first entries, where the file exists)."""
    ident = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as fh:
            seen = set()
            for line in fh:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags", "Features") \
                        and key not in seen:
                    seen.add(key)
                    ident.append(value.strip())
    except OSError:
        pass
    return "\n".join(ident)


def sources(src_dir: Path = HOST_CSRC) -> List[Path]:
    return sorted(Path(src_dir).glob("*.cpp"))


def library_path(cxx: List[str], src_dir: Path = HOST_CSRC,
                 build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256()
    for src in sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(compiler_version(cxx).encode())
    h.update(cpu_identity().encode())
    return (Path(build_dir) if build_dir is not None else BUILD_DIR) / (
        f"libfxtpu_host_{h.hexdigest()[:16]}.so")


def build_library(path: Path, srcs, cxx: List[str]) -> str:
    """Compile ``srcs`` into the shared library ``path``; returns the
    compiler's output.  Raises with it when the compile fails.  The file
    is written under a name of this process and thread, then moved into
    place, so concurrent builds of one library race safely."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = path.parent / f"{path.stem}.{tag}.tmp"
    cmd = [*cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), *map(str, srcs),
           *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
    except OSError as e:
        raise RuntimeError(f"the host library's compile could not start: "
                           f"{' '.join(cmd)}\n{e}") from e
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the host library's compile failed "
                           f"({res.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return log


def load_host():
    """The loaded host library, compiled first if no library for the
    current sources, compiler and machine exists; None only when there is
    no C++ compiler.  Raises with the compiler's output when the build
    fails."""
    global _lib, build_log, build_seconds, loaded_path
    with _lock:
        if _lib is not None:
            return _lib
        cxx = compiler()
        if cxx is None:
            return None
        path = library_path(cxx)
        if not path.exists():
            t0 = time.perf_counter()
            build_log = build_library(path, sources(), cxx)
            build_seconds = time.perf_counter() - t0
        _lib = ctypes.CDLL(str(path))
        loaded_path = path
        return _lib
