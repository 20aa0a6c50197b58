"""The port's hand kernels: which the main path has, and how each is
loaded, launched and counted.

A kernel is a CUDA source in csrc/, built with nvcc at first use into the
compile cache (utils/platform.py:build_kernels) and loaded with ctypes.
`KERNELS` registers the main path's kernels: name -> source and the
signatures of the C functions its wrapper calls. `SOURCES` is what `simon
warmup`, the warm-start check and chip_smoke.py build.

  - `library(name)` loads a kernel's library: once per process, under one
    lock, at its first launch, never at import;
  - `launch(name, symbol, *args)` calls the launch function inside a
    profiler range named after the kernel, raises
    "<name> kernel launch failed: CUDA error N" on a CUDA error and counts
    the launch;
  - `launches(name)` counts the process's launches, `thread_launches(name)`
    the calling thread's. Counters only go up: a caller measuring its own
    launches reads a difference;
  - `check_tensors` is the wrappers' argument check.

The measurement probes of tools/ load their sources through
`open_library` and stay out of the registry: nothing on the scheduler's
path builds them.

Adding a kernel: its .cu in csrc/, its wrapper in ops/ (argument checks,
scalar packing, one `launch` call), one KERNELS entry here, its branch in
ops/fast.py, and its tests.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from ..utils import platform as _platform
from ..utils.concurrency import guarded_by

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C function -> (argtypes, restype)
Symbols = Dict[str, Tuple[list, type]]


class Kernel(NamedTuple):
    source: Path
    symbols: Symbols    # the C functions its wrapper calls


KERNELS: Dict[str, Kernel] = {
    "domain_pop": Kernel(CSRC / "domain_pop.cu", {
        "domain_pop_launch": ([_P] * 16 + [_I] * 9 + [_F, _I, _P], _I),
        "domain_pop_divide_check": ([_P, _P, _I, _P, _P], _I),
    }),
    "light_scan": Kernel(CSRC / "light_scan.cu", {
        "light_scan_launch": ([_P] * 15 + [_I] * 10 + [ctypes.POINTER(_I), _P], _I),
    }),
    "trajectory": Kernel(CSRC / "trajectory.cu", {
        "trajectory_launch": ([_P] * 17 + [_I] * 6 + [_P], _I),
    }),
}
SOURCES = tuple(k.source for k in KERNELS.values())

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()            # _libs
_launches = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()      # _launches
_local = threading.local()          # this thread's launches, by kernel name


def open_library(source: Path, symbols: Symbols) -> ctypes.CDLL:
    """The library of CUDA source `source`, built at the first call and
    loaded once per process, its functions given these signatures."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        return _load(source, symbols)


@guarded_by("_lock")
def _load(source: Path, symbols: Symbols) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(_platform.build_kernels(source)[0]))
        for name, (argtypes, restype) in symbols.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        # published whole: the unlocked read in open_library sees None (and
        # takes the lock) or the library with its signatures set
        _libs[source] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """The library of the registered kernel `name`."""
    kernel = KERNELS[name]
    return open_library(kernel.source, kernel.symbols)


def launch(name: str, symbol: str, *args) -> None:
    """Call kernel `name`'s launch function `symbol` on `args` and count the
    launch; raise if it returns a CUDA error."""
    fn = getattr(library(name), symbol)
    # a named host range around the ctypes launch, so a profiler trace ties
    # the kernel to its caller
    with torch.profiler.record_function(name):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _count_lock:
        _launches[name] += 1
    setattr(_local, name, thread_launches(name) + 1)


def launches(name: str) -> int:
    """Launches of kernel `name` in this process."""
    return _launches[name]


def thread_launches(name: str) -> int:
    """Launches of kernel `name` by the calling thread."""
    return getattr(_local, name, 0)


def check_tensors(kernel: str, dev: torch.device, specs) -> None:
    """Raise ValueError unless `dev` is a card and each (name, tensor, dtype,
    shape) of `specs` is a contiguous tensor on `dev` of that dtype and
    shape."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {dev}; the kernel needs CUDA")
    for name, t, dtype, shape in specs:
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
