"""ctypes binding to the native host runtime (native/dy4_runtime.cpp).

The native layer replaces the reference's host plumbing — threadSafeQ
(src/threadSafeQ.cpp) and the stdin/stdout block loops (src/iofunc.cpp:113,
project.cpp:313-317) — with an SPSC ring buffer and dedicated I/O threads,
so the JAX dispatch loop never blocks on a pipe.  Built on demand with
``g++`` from the package's own ``native/dy4_runtime.cpp`` into
``_build/native/`` (plain C ABI; no pybind11 needed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_SRC = os.path.join(_PKG_ROOT, "native", "dy4_runtime.cpp")
_NATIVE_DIR = os.path.join(_PKG_ROOT, "_build", "native")
_CXXFLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread",
             "-shared"]

_lib: Optional[ctypes.CDLL] = None


def _library_path(build: bool) -> Optional[str]:
    """``_build/native/libdy4runtime-<hash>.so``, compiled with ``g++`` when
    it is missing and ``build`` is set (the name carries a hash of the
    source and flags, so an edit builds afresh).  None when it is not
    there and cannot be built."""
    try:
        with open(_NATIVE_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    key = hashlib.sha256(src + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_NATIVE_DIR, f"libdy4runtime-{key}.so")
    if os.path.exists(path):
        return path
    if not build:
        return None
    # build to a private name, then rename: a concurrent build never sees
    # a half-written library
    tmp = os.path.join(_NATIVE_DIR, f".libdy4runtime-{key}.{os.getpid()}.so")
    try:
        os.makedirs(_NATIVE_DIR, exist_ok=True)
        subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, _NATIVE_SRC],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return path


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = _library_path(build)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dy4_ring_create.restype = ctypes.c_void_p
    lib.dy4_ring_create.argtypes = [ctypes.c_size_t]
    lib.dy4_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.dy4_ring_push.restype = ctypes.c_size_t
    lib.dy4_ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.dy4_ring_pop.restype = ctypes.c_size_t
    lib.dy4_ring_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.dy4_ring_readable.restype = ctypes.c_size_t
    lib.dy4_ring_readable.argtypes = [ctypes.c_void_p]
    lib.dy4_ring_wait_readable.restype = ctypes.c_size_t
    lib.dy4_ring_wait_readable.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                           ctypes.c_long]
    lib.dy4_ring_set_eof.argtypes = [ctypes.c_void_p]
    lib.dy4_source_create.restype = ctypes.c_void_p
    lib.dy4_source_create.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                      ctypes.c_size_t]
    lib.dy4_source_next.restype = ctypes.c_int
    lib.dy4_source_next.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long]
    lib.dy4_source_buffered.restype = ctypes.c_size_t
    lib.dy4_source_buffered.argtypes = [ctypes.c_void_p]
    lib.dy4_source_destroy.argtypes = [ctypes.c_void_p]
    lib.dy4_sink_create.restype = ctypes.c_void_p
    lib.dy4_sink_create.argtypes = [ctypes.c_int, ctypes.c_size_t]
    lib.dy4_sink_push.restype = ctypes.c_int
    lib.dy4_sink_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t,
                                  ctypes.c_long]
    lib.dy4_sink_flush.restype = ctypes.c_int
    lib.dy4_sink_flush.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.dy4_sink_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class Ring:
    """SPSC byte ring (threadSafeQ parity, src/threadSafeQ.cpp:18-55)."""

    def __init__(self, capacity: int):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.dy4_ring_create(capacity)

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.uint8)
        return self._lib.dy4_ring_push(self._h, _u8ptr(data), data.size)

    def pop(self, n: int) -> np.ndarray:
        out = np.empty(n, np.uint8)
        got = self._lib.dy4_ring_pop(self._h, _u8ptr(out), n)
        return out[:got]

    def readable(self) -> int:
        return self._lib.dy4_ring_readable(self._h)

    def wait_readable(self, n: int, timeout_ms: int = -1) -> int:
        return self._lib.dy4_ring_wait_readable(self._h, n, timeout_ms)

    def set_eof(self) -> None:
        self._lib.dy4_ring_set_eof(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dy4_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeSource:
    """Background fd reader yielding fixed-size u8 blocks."""

    def __init__(self, fd: int, block_bytes: int, capacity_blocks: int = 8):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self.block_bytes = block_bytes
        self._h = self._lib.dy4_source_create(fd, block_bytes,
                                              capacity_blocks)

    def next_block(self, timeout_ms: int = -1) -> Optional[np.ndarray]:
        """Next full block, or None at EOF.  Raises TimeoutError."""
        out = np.empty(self.block_bytes, np.uint8)
        rc = self._lib.dy4_source_next(self._h, _u8ptr(out), timeout_ms)
        if rc == 1:
            return out
        if rc == 0:
            return None
        raise TimeoutError("source read timed out")

    def buffered(self) -> int:
        return self._lib.dy4_source_buffered(self._h)

    def __iter__(self):
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dy4_source_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeSink:
    """Background fd writer consuming byte chunks."""

    def __init__(self, fd: int, capacity_bytes: int = 1 << 22):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.dy4_sink_create(fd, capacity_bytes)

    def push(self, data: np.ndarray, timeout_ms: int = -1) -> None:
        data = np.ascontiguousarray(data).view(np.uint8).ravel()
        rc = self._lib.dy4_sink_push(self._h, _u8ptr(data), data.size,
                                     timeout_ms)
        if rc == -2:
            raise BrokenPipeError("sink downstream write failed")
        if rc != 1:
            raise TimeoutError("sink push timed out")

    def flush(self, timeout_ms: int = 10000) -> None:
        rc = self._lib.dy4_sink_flush(self._h, timeout_ms)
        if rc == -2:
            raise BrokenPipeError("sink downstream write failed")
        if rc != 1:
            raise TimeoutError("sink flush timed out")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dy4_sink_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeFrameSync:
    """Native RDS frame synchronizer (semantics of
    ``rds.decoder.FrameSynchronizer``, >1000x its throughput).

    Parameterised by the GF(2) syndrome rows and offset words from
    ``rds.coding`` so the matrix lives in exactly one place.
    """

    def __init__(self, rows: np.ndarray, offset_words: dict,
                 max_misses: int = 2):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        if not hasattr(self._lib, "_framesync_bound"):
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            i64p = ctypes.POINTER(ctypes.c_int64)
            self._lib.dy4_framesync_create.restype = ctypes.c_void_p
            self._lib.dy4_framesync_create.argtypes = [
                u16p, u16p, u8p, ctypes.c_int, ctypes.c_int]
            self._lib.dy4_framesync_push.restype = ctypes.c_int
            self._lib.dy4_framesync_push.argtypes = [
                ctypes.c_void_p, u8p, ctypes.c_size_t, u16p, i64p,
                ctypes.c_int]
            self._lib.dy4_framesync_synced.restype = ctypes.c_int
            self._lib.dy4_framesync_synced.argtypes = [ctypes.c_void_p]
            self._lib.dy4_framesync_reset.argtypes = [ctypes.c_void_p]
            self._lib.dy4_framesync_destroy.argtypes = [ctypes.c_void_p]
            self._lib.dy4_framesync_set_correct.argtypes = [
                ctypes.c_void_p, ctypes.c_int]
            self._lib.dy4_framesync_corrected.restype = ctypes.c_longlong
            self._lib.dy4_framesync_corrected.argtypes = [ctypes.c_void_p]
            self._lib._framesync_bound = True

        # row i of the parity matrix as a 10-bit int, MSB-first
        pow2 = (1 << np.arange(9, -1, -1)).astype(np.int64)
        row_vals = (np.asarray(rows, np.int64) @ pow2).astype(np.uint16)
        types = {"A": 0, "B": 1, "C": 2, "Cp": 3, "D": 4}
        off_syn = np.array([v for v in offset_words.values()], np.uint16)
        off_typ = np.array([types[k] for k in offset_words], np.uint8)
        self._rows = np.ascontiguousarray(row_vals)
        self._h = self._lib.dy4_framesync_create(
            self._rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            np.ascontiguousarray(off_syn).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint16)),
            np.ascontiguousarray(off_typ).ctypes.data_as(u8ptr_t()),
            len(off_syn), max_misses)

    def set_correct(self, on: bool) -> None:
        """Enable/disable single-burst (<=5 bit) error correction (ON
        by default; twin of decoder.FrameSynchronizer correct_bursts)."""
        self._lib.dy4_framesync_set_correct(self._h, 1 if on else 0)

    @property
    def corrected(self) -> int:
        """Blocks repaired by burst correction since creation."""
        return int(self._lib.dy4_framesync_corrected(self._h))

    def push(self, bits: np.ndarray):
        """Returns (blocks [n,4] uint16 A/B/C/D, positions [n] int64)."""
        bits = np.ascontiguousarray(bits, np.uint8)
        cap = max(16, len(bits) // 104 + 4)
        out_b = np.empty((cap, 4), np.uint16)
        out_p = np.empty(cap, np.int64)
        n = self._lib.dy4_framesync_push(
            self._h, _u8ptr(bits), bits.size,
            out_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        return out_b[:n].copy(), out_p[:n].copy()

    @property
    def synced(self) -> bool:
        return bool(self._lib.dy4_framesync_synced(self._h))

    def reset(self) -> None:
        self._lib.dy4_framesync_reset(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dy4_framesync_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def u8ptr_t():
    return ctypes.POINTER(ctypes.c_uint8)


class NativeFrameSyncBatch:
    """Batched frame synchronizer: C channels, one C call per block.

    The per-channel state machine is ``FrameSync`` (dy4_runtime.cpp); the
    batch wrapper loops channels in C++ so the Python fleet layer does no
    per-channel work.  State is exportable as one bytes blob per batch
    (fixed-size per channel) for checkpointing.
    """

    def __init__(self, rows: np.ndarray, offset_words: dict, channels: int,
                 max_misses: int = 2):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        if not hasattr(self._lib, "_fsbatch_bound"):
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            self._lib.dy4_fsbatch_create.restype = ctypes.c_void_p
            self._lib.dy4_fsbatch_create.argtypes = [
                u16p, u16p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            self._lib.dy4_fsbatch_push.restype = ctypes.c_int
            self._lib.dy4_fsbatch_push.argtypes = [
                ctypes.c_void_p, u8p, i32p, ctypes.c_size_t, u8p,
                u16p, i64p, i32p, ctypes.c_int]
            self._lib.dy4_fsbatch_state_bytes.restype = ctypes.c_size_t
            self._lib.dy4_fsbatch_state_bytes.argtypes = [ctypes.c_void_p]
            self._lib.dy4_fsbatch_export.restype = ctypes.c_int
            self._lib.dy4_fsbatch_export.argtypes = [ctypes.c_void_p, u8p]
            self._lib.dy4_fsbatch_import.restype = ctypes.c_int
            self._lib.dy4_fsbatch_import.argtypes = [ctypes.c_void_p, u8p]
            self._lib.dy4_fsbatch_synced.restype = ctypes.c_int
            self._lib.dy4_fsbatch_synced.argtypes = [ctypes.c_void_p, u8p]
            self._lib.dy4_fsbatch_destroy.argtypes = [ctypes.c_void_p]
            self._lib.dy4_fsbatch_set_correct.argtypes = [
                ctypes.c_void_p, ctypes.c_int]
            self._lib.dy4_fsbatch_corrected.restype = ctypes.c_longlong
            self._lib.dy4_fsbatch_corrected.argtypes = [ctypes.c_void_p]
            self._lib._fsbatch_bound = True

        pow2 = (1 << np.arange(9, -1, -1)).astype(np.int64)
        row_vals = np.ascontiguousarray(
            (np.asarray(rows, np.int64) @ pow2).astype(np.uint16))
        types = {"A": 0, "B": 1, "C": 2, "Cp": 3, "D": 4}
        off_syn = np.ascontiguousarray(
            np.array(list(offset_words.values()), np.uint16))
        off_typ = np.ascontiguousarray(
            np.array([types[k] for k in offset_words], np.uint8))
        self.channels = channels
        u16p = ctypes.POINTER(ctypes.c_uint16)
        self._h = self._lib.dy4_fsbatch_create(
            row_vals.ctypes.data_as(u16p), off_syn.ctypes.data_as(u16p),
            off_typ.ctypes.data_as(u8ptr_t()), len(off_syn), max_misses,
            channels)

    def set_correct(self, on: bool) -> None:
        """Enable/disable single-burst error correction on every
        channel (ON by default)."""
        self._lib.dy4_fsbatch_set_correct(self._h, 1 if on else 0)

    @property
    def corrected(self) -> int:
        """Total blocks repaired across all channels."""
        return int(self._lib.dy4_fsbatch_corrected(self._h))

    def push(self, bits: np.ndarray, lens: np.ndarray,
             reset: Optional[np.ndarray] = None):
        """``bits``: [C, stride] u8; ``lens``: [C] i32 valid bits per
        channel; ``reset``: [C] bool.  Returns
        ``(channel [n] i32, blocks [n, 4] u16, positions [n] i64)``."""
        bits = np.ascontiguousarray(bits, np.uint8)
        lens = np.ascontiguousarray(lens, np.int32)
        stride = bits.shape[1] if bits.ndim == 2 else 0
        cap = int(lens.sum()) // 104 + 2 * self.channels + 16
        out_b = np.empty((cap, 4), np.uint16)
        out_p = np.empty(cap, np.int64)
        out_c = np.empty(cap, np.int32)
        rst = None
        if reset is not None:
            rst = np.ascontiguousarray(reset, np.uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n = self._lib.dy4_fsbatch_push(
            self._h, _u8ptr(bits), lens.ctypes.data_as(i32p), stride,
            _u8ptr(rst) if rst is not None else None,
            out_b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_c.ctypes.data_as(i32p), cap)
        return out_c[:n].copy(), out_b[:n].copy(), out_p[:n].copy()

    def export_state(self) -> bytes:
        nb = self._lib.dy4_fsbatch_state_bytes(self._h)
        buf = np.empty(nb, np.uint8)
        if not self._lib.dy4_fsbatch_export(self._h, _u8ptr(buf)):
            raise RuntimeError("framesync buffer exceeded serialized bound")
        return buf.tobytes()

    def import_state(self, blob: bytes) -> None:
        buf = np.frombuffer(blob, np.uint8)
        expect = self._lib.dy4_fsbatch_state_bytes(self._h)
        if len(buf) != expect:
            raise ValueError(f"state blob {len(buf)} B != expected {expect}")
        if not self._lib.dy4_fsbatch_import(self._h, _u8ptr(buf)):
            raise ValueError("state blob rejected: corrupt buffer length")

    @property
    def synced(self) -> np.ndarray:
        out = np.empty(self.channels, np.uint8)
        self._lib.dy4_fsbatch_synced(self._h, _u8ptr(out))
        return out.astype(bool)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dy4_fsbatch_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
