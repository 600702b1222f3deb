"""ctypes bindings for the native host-runtime library (native/octnative.cpp).

The reference's data path below Qt is native C++ (aligned double buffer
octproz_devkit/src/acquisitionbuffer.cpp, streaming file reads
virtualoctsystem.cpp:226-291); this module provides the same components for
this framework's host loop.  The shared library is compiled on demand with
g++ (cached next to the source); every entry point has a numpy fallback so
the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liboctnative.so")
_lib = None
_lib_lock = threading.Lock()


def _build_library() -> bool:
    src = os.path.join(_NATIVE_DIR, "octnative.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared", "-o", _LIB_PATH, src],
            check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or (
                os.path.exists(os.path.join(_NATIVE_DIR, "octnative.cpp"))
                and os.path.getmtime(_LIB_PATH)
                < os.path.getmtime(os.path.join(_NATIVE_DIR, "octnative.cpp"))):
            if not _build_library() and not os.path.exists(_LIB_PATH):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.rb_create.restype = ctypes.c_void_p
        lib.rb_create.argtypes = [ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t]
        lib.rb_destroy.argtypes = [ctypes.c_void_p]
        lib.rb_slot_ptr.restype = ctypes.c_void_p
        lib.rb_slot_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rb_n_slots.argtypes = [ctypes.c_void_p]
        lib.rb_slot_bytes.restype = ctypes.c_size_t
        lib.rb_slot_bytes.argtypes = [ctypes.c_void_p]
        for name in ("rb_acquire_write", "rb_acquire_read"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        for name in ("rb_commit_write", "rb_release_read"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name in ("rb_produced", "rb_consumed"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p]
        lib.file_read_at.restype = ctypes.c_long
        lib.file_read_at.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.c_long, ctypes.c_void_p]
        lib.file_size.restype = ctypes.c_long
        lib.file_size.argtypes = [ctypes.c_char_p]
        lib.unpack_uint12.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        lib.pack_uint12.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


class NativeRingBuffer:
    """Aligned N-slot ring with atomic ready flags -- the AcquisitionBuffer
    analog (acquisitionbuffer.h:53-58).  Slots are zero-copy numpy views of
    128-byte-aligned native memory, so a producer (acquisition hardware
    thread, file prefetch) can fill a slot while the consumer feeds the
    previous one to the device."""

    def __init__(self, n_slots: int, slot_shape, dtype, alignment: int = 128):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable (g++ build failed)")
        self._lib = lib
        self.slot_shape = tuple(slot_shape)
        self.dtype = np.dtype(dtype)
        slot_bytes = int(np.prod(self.slot_shape)) * self.dtype.itemsize
        self._handle = lib.rb_create(n_slots, slot_bytes, alignment)
        if not self._handle:
            raise MemoryError("rb_create failed")
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self._views = []
        for i in range(n_slots):
            ptr = lib.rb_slot_ptr(self._handle, i)
            buf = (ctypes.c_uint8 * slot_bytes).from_address(ptr)
            arr = np.frombuffer(buf, dtype=self.dtype).reshape(self.slot_shape)
            self._views.append(arr)

    def acquire_write(self) -> int:
        """Next writable slot index, or -1 if the consumer is behind."""
        return self._lib.rb_acquire_write(self._handle)

    def commit_write(self, slot: int) -> None:
        self._lib.rb_commit_write(self._handle, slot)

    def acquire_read(self) -> int:
        """Next ready slot index, or -1 if none ready."""
        return self._lib.rb_acquire_read(self._handle)

    def release_read(self, slot: int) -> None:
        self._lib.rb_release_read(self._handle, slot)

    def produced(self) -> int:
        """Total slots ever committed (monotonic)."""
        return self._lib.rb_produced(self._handle)

    def consumed(self) -> int:
        """Total slots ever released (monotonic)."""
        return self._lib.rb_consumed(self._handle)

    def view(self, slot: int) -> np.ndarray:
        """Zero-copy numpy view of a slot."""
        return self._views[slot]

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._views = []
            self._lib.rb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_file_at(path: str, offset: int, nbytes: int,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Read nbytes at offset; native pread loop with numpy fallback."""
    if out is None:
        out = np.empty(nbytes, np.uint8)
    lib = load_library()
    if lib is not None:
        got = lib.file_read_at(path.encode(), offset, nbytes,
                               out.ctypes.data_as(ctypes.c_void_p))
        if got < 0:
            raise OSError(f"file_read_at failed for {path}")
        if got < nbytes:
            raise EOFError(f"{path}: wanted {nbytes} bytes at {offset}, got {got}")
        return out
    data = np.fromfile(path, dtype=np.uint8, count=nbytes, offset=offset)
    if data.size < nbytes:
        raise EOFError(f"{path}: wanted {nbytes} bytes at {offset}, got {data.size}")
    out[:] = data
    return out


def unpack_uint12(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """12-bit packed (2 samples / 3 bytes) -> uint16; native with fallback."""
    packed = np.ascontiguousarray(packed, np.uint8)
    # size check BEFORE handing the pointer to C: an undersized buffer
    # would be a silent out-of-bounds read (an odd tail needs 2 bytes,
    # native/octnative.cpp:161-164)
    needed = 3 * (n_samples // 2) + (2 if n_samples & 1 else 0)
    if packed.size < needed:
        raise ValueError(
            f"packed 12-bit buffer too small: {n_samples} samples need "
            f"{needed} bytes, have {packed.size}")
    lib = load_library()
    if lib is None:
        from .ops.convert import unpack_uint12_packed
        return unpack_uint12_packed(packed, n_samples)
    out = np.empty(n_samples, np.uint16)
    lib.unpack_uint12(packed.ctypes.data_as(ctypes.c_void_p),
                      out.ctypes.data_as(ctypes.c_void_p), n_samples)
    return out


def pack_uint12(samples: np.ndarray) -> np.ndarray:
    """uint16 12-bit samples -> packed bytes (fixture/recording helper)."""
    samples = np.ascontiguousarray(samples, np.uint16)
    n = samples.size
    out = np.zeros((n + 1) // 2 * 3, np.uint8)
    lib = load_library()
    if lib is not None:
        lib.pack_uint12(samples.ctypes.data_as(ctypes.c_void_p),
                        out.ctypes.data_as(ctypes.c_void_p), n)
        return out
    s = samples.astype(np.uint16) & 0x0FFF
    pairs = n // 2
    s0, s1 = s[0:2 * pairs:2], s[1:2 * pairs:2]
    grp = out[: pairs * 3].reshape(pairs, 3)
    grp[:, 0] = s0 & 0xFF
    grp[:, 1] = ((s0 >> 8) & 0x0F) | ((s1 & 0x0F) << 4)
    grp[:, 2] = (s1 >> 4) & 0xFF
    if n & 1:
        out[pairs * 3] = s[-1] & 0xFF
        out[pairs * 3 + 1] = (s[-1] >> 8) & 0x0F
    return out
