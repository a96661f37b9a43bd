"""ctypes binding for the port's host data-plane library.

The library is the port's own: ``fxtpu_torch/csrc/host/`` (a copy of
``fxtpu``'s ``native/ringbuffer.cpp`` and of the int8 loops of its
``native/dataplane.cpp``), compiled at first use by
:mod:`fxtpu_torch.host_build` into ``build/fxtpu_torch/``; no ``make`` is
needed.  Bound here: the lock-free ring buffer (:class:`NativeRingBuffer`,
the same sequence/drop semantics as the Python
:class:`~fxtpu_torch.runtime.ringbuffer.RingBuffer`, with the zero-copy
producer ``reserve``/``commit``) and the int8 data-plane loops of int8
ingest (:func:`quantize_c64`, :func:`split_planes_i8`).  ``fxtpu``'s
4-bins-per-int32 packing is not, because it answered the TPU's
element-bound copies and GPU loads are byte-addressed.

:func:`native_available` builds the library on its first call and raises
with the compiler's output when the build fails.  Only a machine with no
C++ compiler gets False; there :func:`make_ring` returns the Python ring
and the loops run their numpy expressions, as ``fxtpu`` does without its
library.  The card's path never does: :func:`require_native` raises for a
CUDA device when the library is missing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from fxtpu_torch import host_build
from fxtpu_torch.runtime.ringbuffer import BufferClosed, BufferFull, RingBuffer

_lib = None


def _declare(lib):
    """Set the argument and result types of the library's entries."""
    P, I64, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.rb_create.restype = P
    lib.rb_create.argtypes = [I64, I64]
    lib.rb_destroy.argtypes = [P]
    for name in ("rb_size", "rb_drops", "rb_total_put"):
        getattr(lib, name).restype = I64
        getattr(lib, name).argtypes = [P]
    lib.rb_close.argtypes = [P]
    lib.rb_closed.restype = ctypes.c_int
    lib.rb_closed.argtypes = [P]
    lib.rb_put.restype = ctypes.c_int
    lib.rb_put.argtypes = [P, P, I64, I64, D]
    lib.rb_get.restype = ctypes.c_int
    lib.rb_get.argtypes = [P, P, ctypes.POINTER(I64), D]
    lib.rb_peek.restype = ctypes.c_int
    lib.rb_peek.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(I64), D]
    lib.rb_release.argtypes = [P]
    lib.rb_reserve.restype = ctypes.c_int
    lib.rb_reserve.argtypes = [P, ctypes.POINTER(P), D]
    lib.rb_commit.argtypes = [P, I64]
    lib.fx_quant_c64_i8.argtypes = [P, P, I64, ctypes.c_float]
    lib.fx_split_i8.argtypes = [P, P, P, I64]
    return lib


def _load():
    """The declared library, built at first use; None only without a C++
    compiler."""
    global _lib
    if _lib is None:
        lib = host_build.load_host()
        if lib is None:
            return None
        _lib = _declare(lib)
    return _lib


def native_available() -> bool:
    """True when the host library is loaded, building it first; raises
    when the build fails."""
    return _load() is not None


def _dataplane():
    """The library whose loops :func:`quantize_c64` and
    :func:`split_planes_i8` call, or None: then their numpy versions
    run."""
    return _load()


def require_native(device, what: str):
    """Raise when ``device`` is a CUDA device and the host library cannot
    be had: the card's path runs the native rings and loops, never their
    Python and numpy fallbacks."""
    if str(device).startswith("cuda") and not native_available():
        raise RuntimeError(
            f"{what} on {device} needs the port's host library, built from "
            "fxtpu_torch/csrc/host at first use, and no C++ compiler was "
            "found ($CXX or g++)")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# Host data-plane loops of int8 ingest (csrc/host/dataplane.cpp), each with
# its plain numpy version: identical results, used when there is no
# library or the input layout rules the flat loop out.

def _check_out(block: np.ndarray, out: Optional[np.ndarray]):
    if out is not None and (out.dtype != np.int8
                            or not out.flags.c_contiguous
                            or out.shape != (*block.shape, 2)):
        raise ValueError(f"out must be contiguous int8 {(*block.shape, 2)}, "
                         f"got {out.dtype} {out.shape}")


def quantize_c64_numpy(block: np.ndarray, quant_step: float,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """:func:`quantize_c64`'s plain numpy version (numpy's ufunc chain)."""
    _check_out(block, out)
    q = out if out is not None \
        else np.empty((*block.shape, 2), dtype=np.int8)
    inv = 1.0 / quant_step
    np.clip(np.rint(block.real * inv), -127, 127, out=q[..., 0],
            casting="unsafe")
    np.clip(np.rint(block.imag * inv), -127, 127, out=q[..., 1],
            casting="unsafe")
    return q


def quantize_c64(block: np.ndarray, quant_step: float,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """complex64 ``[..., n]`` -> int8 ``[..., n, 2]``, ``round(x/step)``
    (half to even) clipped to [-127, 127] (the QuantizedSource contract),
    in one native pass.  ``out`` (int8, ``block.shape + (2,)``,
    contiguous) lets the caller quantize straight into a ring slot (the
    zero-copy producer)."""
    _check_out(block, out)
    lib = _dataplane()
    if (lib is not None and block.dtype == np.complex64
            and block.flags.c_contiguous):
        if out is None:
            out = np.empty((*block.shape, 2), np.int8)
        lib.fx_quant_c64_i8(_ptr(block), _ptr(out), block.size,
                            1.0 / float(quant_step))
        return out
    return quantize_c64_numpy(block, quant_step, out)


def split_planes_i8(block: np.ndarray):
    """int8 ``[..., n, 2]`` interleaved -> (re, im) contiguous int8
    ``[..., n]`` planes."""
    lib = _dataplane()
    if lib is not None and block.dtype == np.int8 \
            and block.flags.c_contiguous:
        shape = block.shape[:-1]
        re = np.empty(shape, np.int8)
        im = np.empty(shape, np.int8)
        lib.fx_split_i8(_ptr(block), _ptr(re), _ptr(im), re.size)
        return re, im
    return split_planes_i8_numpy(block)


def split_planes_i8_numpy(block: np.ndarray):
    """:func:`split_planes_i8`'s plain numpy version."""
    return (np.ascontiguousarray(block[..., 0]),
            np.ascontiguousarray(block[..., 1]))


class NativeRingBuffer:
    """Drop-in for the Python RingBuffer (put/get/qsize/drops/close) backed
    by the lock-free C++ implementation."""

    def __init__(self, capacity: int, block_shape, dtype=np.complex64,
                 policy: str = "raise"):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "no native ring buffer: no C++ compiler ($CXX or g++) to "
                "build fxtpu_torch/csrc/host")
        if policy not in ("raise", "drop"):
            raise ValueError(f"native ring supports raise/drop, got {policy}")
        self._lib = lib
        self.capacity = int(capacity)
        self.block_shape = tuple(block_shape)
        self.dtype = np.dtype(dtype)
        self.block_bytes = int(np.prod(self.block_shape)) * self.dtype.itemsize
        self.policy = policy
        self._rb = lib.rb_create(self.capacity, self.block_bytes)
        if not self._rb:
            raise MemoryError("rb_create failed")
        self._next_seq = 0

    # -- RingBuffer-compatible surface ---------------------------------
    def qsize(self) -> int:
        return int(self._lib.rb_size(self._rb))

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.qsize() >= self.capacity

    @property
    def drops(self) -> int:
        return int(self._lib.rb_drops(self._rb))

    @property
    def total_put(self) -> int:
        return int(self._lib.rb_total_put(self._rb))

    @property
    def closed(self) -> bool:
        return bool(self._lib.rb_closed(self._rb))

    def close(self):
        self._lib.rb_close(self._rb)

    def put(self, block: np.ndarray, timeout: Optional[float] = None,
            seq: Optional[int] = None) -> int:
        if seq is None:
            seq = self._next_seq
        block = np.ascontiguousarray(block, dtype=self.dtype)
        # timeout=None waits forever, like the Python RingBuffer (and like
        # get/get_view below) — not 0.0, which would fail on the first
        # full poll
        rc = self._lib.rb_put(
            self._rb, block.ctypes.data_as(ctypes.c_void_p), block.nbytes,
            seq, 1e9 if timeout is None else float(timeout))
        if rc == -2:
            raise BufferClosed("put on closed ring buffer")
        if rc == -1:
            if self.policy == "raise":
                raise BufferFull(
                    f"native ring buffer full for {timeout} s "
                    f"({self.drops} drops so far)")
            return -1
        self._next_seq = seq + 1
        return seq

    #: The zero-copy producer (reserve/commit) is there: the Feeder gates
    #: its zero-copy loop on this, which the Python ring lacks.
    can_reserve = True

    def _slot_view(self, addr: int) -> np.ndarray:
        """The ring slot at ``addr`` as an array.  The view holds this
        ring, so the slots are not freed (``__del__``) while it lives."""
        buf = (ctypes.c_char * self.block_bytes).from_address(addr)
        buf._ring = self
        return np.frombuffer(buf, dtype=self.dtype).reshape(self.block_shape)

    def reserve(self, timeout: Optional[float] = None
                ) -> Optional[np.ndarray]:
        """Zero-copy producer slot: the returned view IS ring memory — the
        source's read (or the native quantizer) writes the block directly
        into it, deleting put()'s staging memcpy.  Publish with
        :meth:`commit`; an uncommitted reservation is simply abandoned.
        Same timeout semantics as put() (raise/drop policy, drop counted)."""
        ptr = ctypes.c_void_p()
        rc = self._lib.rb_reserve(
            self._rb, ctypes.byref(ptr),
            1e9 if timeout is None else float(timeout))
        if rc == -2:
            raise BufferClosed("reserve on closed ring buffer")
        if rc == -1:
            if self.policy == "raise":
                raise BufferFull(
                    f"native ring buffer full for {timeout} s "
                    f"({self.drops} drops so far)")
            return None
        return self._slot_view(ptr.value)

    def commit(self, seq: Optional[int] = None) -> int:
        if seq is None:
            seq = self._next_seq
        self._lib.rb_commit(self._rb, seq)
        self._next_seq = seq + 1
        return seq

    def get(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[int, np.ndarray]]:
        out = np.empty(self.block_shape, dtype=self.dtype)
        seq = ctypes.c_int64()
        rc = self._lib.rb_get(
            self._rb, out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(seq), 1e9 if timeout is None else float(timeout))
        if rc != 0:
            return None
        return int(seq.value), out

    def get_view(self, timeout: Optional[float] = None):
        """Zero-copy consumer view; call :meth:`release` when done."""
        ptr = ctypes.c_void_p()
        seq = ctypes.c_int64()
        rc = self._lib.rb_peek(self._rb, ctypes.byref(ptr), ctypes.byref(seq),
                               1e9 if timeout is None else float(timeout))
        if rc != 0:
            return None
        return int(seq.value), self._slot_view(ptr.value)

    def release(self):
        self._lib.rb_release(self._rb)

    def __del__(self):
        try:
            if getattr(self, "_rb", None):
                self._lib.rb_destroy(self._rb)
                self._rb = None
        except Exception:
            pass


def make_ring(capacity: int, block_shape, dtype=np.complex64,
              policy: str = "raise", prefer_native: bool = True):
    """The native ring where the host library is there (built at first
    use) and the policy is one it has (raise, drop), else the Python
    ring; ``prefer_native=False`` asks for the Python ring."""
    if prefer_native and native_available() and policy in ("raise", "drop"):
        return NativeRingBuffer(capacity, block_shape, dtype, policy)
    return RingBuffer(capacity, block_shape, dtype, policy)
