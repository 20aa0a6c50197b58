"""ctypes loader of the native host runtime (osim_native.cpp).

The port's copy of the JAX package's native/ loader, with the same API
(`load`, `available`, `parse_quantity_one`, `hash_rows`) and contract: a
function returns None when the library is unavailable or when the value
needs the exact Python path, and callers keep their pure-Python paths.

The library is built at first use, never at import: `g++ -O2 -fPIC -shared
-std=c++17` (`$CXX` when set) through utils/platform.py:build(), the build
step of the kernels too, into the compile cache (`build_dir()`, read at the
build, honouring OSIM_COMPILE_CACHE), under a name tagged by the source and
the flags, so a stale or half-written library never loads. A g++ run is
host code, not a kernel build: it is counted here (`builds`,
`build_seconds`), not as a compile-cache event.

`calls` counts the hash_rows calls that ran the library in this process; a
caller showing that a path went through it reads the difference.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils import platform as _platform
from ..utils.concurrency import guarded_by

SOURCE = Path(__file__).resolve().with_name("osim_native.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

calls = 0                   # hash_rows calls that ran the library
builds = 0                  # g++ runs of this process
build_seconds = 0.0         # their seconds
_lock = threading.Lock()    # the load and its build
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(out_dir: Path) -> Path:
    """The library built from this source with these flags, in `out_dir`."""
    return _platform.library_path(SOURCE, CXX_FLAGS, out_dir)


def _compiler() -> Optional[str]:
    """$CXX when set, else g++, resolved on PATH; None when absent."""
    return shutil.which(os.environ.get("CXX") or "g++")


@guarded_by("_lock")
def _build() -> Optional[Path]:
    """The library, built unless it is there; None when it cannot be built.
    Callers hold _lock."""
    global builds, build_seconds
    cxx = _compiler()
    if cxx is None:
        return None
    t0 = time.perf_counter()
    (built,) = _platform.build(lambda: cxx, CXX_FLAGS, [SOURCE])
    if built.ran:
        builds += 1
        build_seconds += time.perf_counter() - t0
    return built.path if built.ok else None


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it on first use; None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        # double-checked locking: the unlocked fast-path read above pairs
        # with these writes, but both writes happen under _lock and a stale
        # fast-path read only costs a harmless second trip into the lock
        _tried = True  # osim: audit-ok[race]
        try:
            so = _build()
            if so is None:
                return None
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.osim_hash_rows.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        ]
        lib.osim_hash_rows.restype = None
        lib.osim_parse_quantity_one.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.osim_parse_quantity_one.restype = ctypes.c_int
        # publish under _lock; the unlocked reader sees either None (and
        # takes the lock) or the fully-initialized CDLL
        _lib = lib  # osim: audit-ok[race]
        return _lib


def available() -> bool:
    return load() is not None


def parse_quantity_one(s: str) -> Optional[Tuple[int, int, int, int]]:
    """Scalar fast path: (milli_ceil, milli_floor, base_ceil, base_floor), or
    None when unavailable / the value needs the exact Python path."""
    lib = load()
    if lib is None:
        return None
    b = s.encode()
    mc = ctypes.c_int64()
    mf = ctypes.c_int64()
    bc = ctypes.c_int64()
    bf = ctypes.c_int64()
    if not lib.osim_parse_quantity_one(
        b, len(b),
        ctypes.byref(mc), ctypes.byref(mf), ctypes.byref(bc), ctypes.byref(bf),
    ):
        return None
    return mc.value, mf.value, bc.value, bf.value


def hash_rows(data: np.ndarray) -> Optional[np.ndarray]:
    """128-bit hash per row of a 2-D uint8 array -> uint64[n, 2], or None
    when the native library is unavailable."""
    global calls
    lib = load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    if data.ndim != 2:
        raise ValueError(f"hash_rows: expected a 2-D uint8 array, got shape {data.shape}")
    n, row_bytes = data.shape
    out = np.zeros((n, 2), np.uint64)
    lib.osim_hash_rows(data, n, row_bytes, out)
    with _count_lock:
        calls += 1
    return out
