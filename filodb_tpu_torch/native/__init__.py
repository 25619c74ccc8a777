"""Native (C++) runtime components, loaded via ctypes.

The reference's `memory/` module is "native code written in Scala" — raw
off-heap pointer work (SURVEY §2.1, format/UnsafeUtils.scala). Here the
host-side hot loops live in real C++ compiled on demand with g++ (the
image has no pybind11; the C ABI + ctypes keeps the binding surface
trivial). Python implementations remain the behavioral oracle and the
fallback when no compiler is available.

The library is built into ``build/native/`` at the repository root (listed
in ``.gitignore``), never beside the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "nibblepack.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                          "build", "native")
_LIB_NAME = f"_nibblepack_{sys.platform}.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(lib_path: str) -> bool:
    """Compile the codec; atomic rename so concurrent builders are safe."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_nibblepack() -> Optional[ctypes.CDLL]:
    """The compiled codec, building it on first use; None when unavailable
    (callers keep the Python path)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_path = os.path.join(_BUILD_DIR, _LIB_NAME)
        fresh = (os.path.exists(lib_path)
                 and os.path.getmtime(lib_path) >= os.path.getmtime(_SRC))
        if not fresh and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        L = ctypes.c_long
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.np_pack_non_increasing.restype = L
        lib.np_pack_non_increasing.argtypes = [u64p, L, u8p]
        lib.np_pack_delta.restype = L
        lib.np_pack_delta.argtypes = [i64p, L, u8p]
        lib.np_pack_doubles.restype = L
        lib.np_pack_doubles.argtypes = [f64p, L, u8p]
        lib.np_unpack_words.restype = L
        lib.np_unpack_words.argtypes = [u8p, L, L, L, u64p]
        lib.np_unpack_delta.restype = L
        lib.np_unpack_delta.argtypes = [u8p, L, L, L, i64p]
        lib.np_unpack_double_xor.restype = L
        lib.np_unpack_double_xor.argtypes = [u8p, L, L, L, f64p]
        _lib = lib
        return _lib
