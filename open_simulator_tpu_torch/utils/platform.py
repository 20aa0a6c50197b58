"""The port's compile cache: the build directory of the hand kernels.

The counterpart of the JAX package's utils/platform.py. There, XLA
executables are banked in a persistent compilation cache so that a later
process pays no compile; here the only compiled programs are the hand
kernels (ops/domain_pop.py builds `csrc/*.cu` with nvcc into a shared
library and loads it with ctypes), so the cache is the directory those
libraries are built into:

  - `OSIM_COMPILE_CACHE` unset or empty: the repo's `build/`
    (`ops.domain_pop.BUILD_DIR`, listed in .gitignore);
  - set: `$OSIM_COMPILE_CACHE/<fingerprint>`, the fingerprint a hash of the
    card and the toolchain (device name, compute capability, `nvcc
    --version`), so a library built for another card or compiler is never
    loaded. The reference keys its cache by the host CPU's feature flags
    (`_host_fingerprint`) for the same reason.

The directory is read at every build (`ops.domain_pop.build_dir()`), never
at import, so a process may point it elsewhere before its first launch.

Compile accounting: every nvcc run is a `backend_compile` event, every load
of a library that was already built is a `persistent_hit` event.
`install_compile_listener()` mirrors both into
`osim_compile_cache_total{event=}`, and `CompileCounter` counts them over a
region of code. Unlike the reference (whose duration event fires for hits
too), a hit here is not also a compile request, so `cold_compiles` equals
the builds.

The reference's `ensure_platform()` has no counterpart: every entry point
of the port takes its device as an argument (`device="cuda"` by default)
and no site hook can redirect it.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, List

CACHE_ENV = "OSIM_COMPILE_CACHE"

#: an nvcc run of one kernel source
BACKEND_COMPILE_EVENT = "backend_compile"
#: a kernel library found already built in the cache directory
PERSISTENT_HIT_EVENT = "persistent_hit"

_listeners: List[Callable[[str], None]] = []
_listeners_lock = threading.Lock()
_compile_listener_installed = False


@functools.lru_cache(maxsize=None)
def _card_fingerprint() -> str:
    """Short stable id of this machine's card and CUDA toolchain."""
    import torch

    parts = [torch.__version__, str(torch.version.cuda)]
    if torch.cuda.is_available():
        parts += [torch.cuda.get_device_name(0),
                  "sm_%d%d" % torch.cuda.get_device_capability(0)]
    # names the cache directory only; the libraries in it compute the same bits
    nvcc = os.environ.get("NVCC") or shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"  # osim: lint-ok[impure-read]
    try:
        parts.append(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                    timeout=60).stdout)
    except (OSError, subprocess.SubprocessError):
        parts.append("no-nvcc")
    return hashlib.blake2b("\n".join(parts).encode(), digest_size=6).hexdigest()


def enable_compilation_cache() -> str:
    """The directory the hand kernels are built into and loaded from (made
    when missing): `$OSIM_COMPILE_CACHE/<card fingerprint>` when the
    variable is set, else the repo's `build/`."""
    # where kernel builds are kept; the libraries compute the same bits anywhere
    root = os.environ.get(CACHE_ENV, "").strip()  # osim: lint-ok[impure-read]
    if not root:
        from ..ops import domain_pop

        return str(domain_pop.BUILD_DIR)
    path = os.path.join(root, _card_fingerprint())
    os.makedirs(path, exist_ok=True)
    return path


def compile_event(event: str) -> None:
    """Report one compile-cache event to every listener (ops/domain_pop.py
    calls this per source it builds or finds built)."""
    with _listeners_lock:
        listeners = list(_listeners)
    for fn in listeners:
        fn(event)


def _add_listener(fn: Callable[[str], None]) -> None:
    with _listeners_lock:
        _listeners.append(fn)


def _remove_listener(fn: Callable[[str], None]) -> None:
    with _listeners_lock:
        if fn in _listeners:
            _listeners.remove(fn)


def install_compile_listener() -> bool:
    """Mirror kernel builds and cache hits into
    `osim_compile_cache_total{event="backend_compile"|"persistent_hit"}`.
    Idempotent; returns True."""
    global _compile_listener_installed
    with _listeners_lock:
        if _compile_listener_installed:
            return True
        _compile_listener_installed = True
    from . import metrics

    _add_listener(lambda event: metrics.COMPILE_CACHE.inc(event=event))
    return True


class CompileCounter:
    """Context manager counting kernel builds (`backend_compiles`) and loads
    of already-built libraries (`persistent_hits`) over a region of code.
    `cold_compiles` is the builds: the number `simon warmup --check`
    demands to be 0."""

    def __init__(self) -> None:
        self.backend_compiles = 0
        self.persistent_hits = 0

    @property
    def cold_compiles(self) -> int:
        return self.backend_compiles

    def _on_event(self, event: str) -> None:
        if event == BACKEND_COMPILE_EVENT:
            self.backend_compiles += 1
        elif event == PERSISTENT_HIT_EVENT:
            self.persistent_hits += 1

    def __enter__(self) -> "CompileCounter":
        _add_listener(self._on_event)
        return self

    def __exit__(self, *exc) -> None:
        _remove_listener(self._on_event)
