"""The port's compile cache: where its shared libraries are built, and how.

The counterpart of the JAX package's utils/platform.py. There, XLA
executables are banked in a persistent compilation cache so that a later
process pays no compile; here the only compiled programs are shared
libraries built at first use and loaded with ctypes: the hand kernels
(`csrc/*.cu`, nvcc, ops/kernel_lib.py) and the native host runtime
(`native/osim_native.cpp`, g++). So the cache is the directory those
libraries are built into:

  - `OSIM_COMPILE_CACHE` unset or empty: the repo's `build/` (`BUILD_DIR`,
    listed in .gitignore);
  - set: `$OSIM_COMPILE_CACHE/<fingerprint>`, the fingerprint a hash of the
    card and the toolchain (device name, compute capability, `nvcc
    --version`), so a library built for another card or compiler is never
    loaded. The reference keys its cache by the host CPU's feature flags
    (`_host_fingerprint`) for the same reason.

The directory is read at every build (`build_dir()`), never at import, so a
process may point it elsewhere before its first launch.

`build()` is the one build step of every library: a name tagged by the
source and the flags (`lib<stem>-<tag>.so`), one compiler process per
missing library, a temporary file renamed onto that name under the
directory's file lock, so a stale or half-written library never loads.
`build_kernels()` runs it with nvcc and `NVCC_FLAGS` for the kernels.

Compile accounting: every nvcc run is a `backend_compile` event, every load
of a kernel library that was already built is a `persistent_hit` event
(a g++ run is host code: native/ counts it itself).
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

import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, NamedTuple, Sequence

from .concurrency import guarded_by

CACHE_ENV = "OSIM_COMPILE_CACHE"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"   # the default of build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600       # one compiler process, at most

#: an nvcc run of one kernel source
BACKEND_COMPILE_EVENT = "backend_compile"
#: a kernel library found already built in the cache directory
PERSISTENT_HIT_EVENT = "persistent_hit"

_listeners: List[Callable[[str], None]] = []
_listeners_lock = threading.Lock()
_compile_listener_installed = False

build_log = ""              # the compilers' output (nvcc: registers, spills) of this process
_build_lock = threading.Lock()      # build(): one build at a time per process


@functools.lru_cache(maxsize=None)
def _card_fingerprint() -> str:
    """Short stable id of this machine's card and CUDA toolchain."""
    import torch

    parts = [torch.__version__, str(torch.version.cuda)]
    if torch.cuda.is_available():
        parts += [torch.cuda.get_device_name(0),
                  "sm_%d%d" % torch.cuda.get_device_capability(0)]
    try:
        parts.append(subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                                    timeout=60).stdout)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        parts.append("no-nvcc")
    return hashlib.blake2b("\n".join(parts).encode(), digest_size=6).hexdigest()


def enable_compilation_cache() -> str:
    """The directory the hand kernels are built into and loaded from (made
    when missing): `$OSIM_COMPILE_CACHE/<card fingerprint>` when the
    variable is set, else the repo's `build/`."""
    # where kernel builds are kept; the libraries compute the same bits anywhere
    root = os.environ.get(CACHE_ENV, "").strip()  # osim: lint-ok[impure-read]
    if not root:
        return str(BUILD_DIR)
    path = os.path.join(root, _card_fingerprint())
    os.makedirs(path, exist_ok=True)
    return path


def build_dir() -> Path:
    """The directory libraries are built into and loaded from, read at each
    build: `$OSIM_COMPILE_CACHE/<card fingerprint>` when that is set, else
    BUILD_DIR."""
    return Path(enable_compilation_cache())


def nvcc() -> str:
    """$NVCC when set, else nvcc on PATH, else the toolkit's default path."""
    # the compiler's path only: the library it builds computes the same bits
    env = os.environ.get("NVCC")  # osim: lint-ok[impure-read]
    cands = (env,) if env else (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc")
    for cand in cands:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels cannot be built "
        "(set NVCC or put the CUDA toolkit's bin directory on PATH)"
    )


def library_path(source: Path, flags: Sequence[str], out_dir: Path) -> Path:
    """The library built from `source` with `flags`, in `out_dir`: its name
    carries a tag of both."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return out_dir / f"lib{source.stem}-{tag}.so"


class Built(NamedTuple):
    """One library of a build() call."""

    path: Path
    ran: bool       # the compiler ran for it (it was missing)
    ok: bool        # it is there to load
    output: str     # the compiler's output, or why it did not run


def build(compiler: Callable[[], str], flags: Sequence[str],
          sources: Sequence[Path]) -> List[Built]:
    """Build each source's library into build_dir() unless it is there:
    `compiler flags -o <temporary file> source`, the compilers of the
    missing libraries started together, each temporary file renamed onto
    its library's name. One build at a time per process (a lock) and per
    directory (a file lock); a library that appeared while waiting is not
    built again. `compiler()` is asked only when a library is missing: it
    returns the compiler's path or raises. Returns one Built per source, in
    order; the callers count their builds and raise or not."""
    out_dir = build_dir()
    sos = [library_path(src, flags, out_dir) for src in sources]
    if all(so.is_file() for so in sos):
        return [Built(so, False, True, "") for so in sos]
    with _build_lock:
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / ".build.lock", "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            return _build_missing(compiler, flags, sources, sos)


@guarded_by("_build_lock")
def _build_missing(compiler, flags, sources, sos) -> List[Built]:
    """build()'s compiler runs. Callers hold _build_lock and the
    directory's file lock."""
    global build_log
    out = [Built(so, False, True, "") for so in sos]
    todo = [k for k, so in enumerate(sos) if not so.is_file()]
    if not todo:
        return out
    cc = compiler()
    procs = []
    for k in todo:
        tmp = sos[k].with_name(f"{sos[k].stem}.{os.getpid()}.tmp.so")
        try:
            procs.append((k, tmp, subprocess.Popen(
                [cc, *flags, "-o", str(tmp), str(sources[k])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        except OSError as exc:
            out[k] = Built(sos[k], False, False, f"{cc} did not start: {exc}")
    for k, tmp, proc in procs:
        try:
            text = proc.communicate(timeout=BUILD_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0] + f"\nkilled after {BUILD_TIMEOUT_S} s"
        build_log += f"[{sources[k].name}]\n{text}"
        ok = proc.returncode == 0 and tmp.is_file()
        if ok:
            os.replace(tmp, sos[k])
        else:
            tmp.unlink(missing_ok=True)
        out[k] = Built(sos[k], True, ok, text)
    return out


def build_kernels(*sources: Path) -> List[Path]:
    """Compile each CUDA source with nvcc (`build()`, NVCC_FLAGS) and return
    the libraries' paths; a failed build raises. Each source counts one
    compile-cache event: a `backend_compile` when nvcc ran for it, else a
    `persistent_hit`."""
    built = build(nvcc, NVCC_FLAGS, sources)
    failed = [f"nvcc failed building {src.name}:\n{b.output}"
              for src, b in zip(sources, built) if not b.ok]
    if failed:
        raise RuntimeError("\n".join(failed))
    for b in built:
        compile_event(BACKEND_COMPILE_EVENT if b.ran else PERSISTENT_HIT_EVENT)
    return [b.path for b in built]


def compile_event(event: str) -> None:
    """Report one compile-cache event to every listener (build_kernels calls
    this per source it builds or finds built)."""
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
