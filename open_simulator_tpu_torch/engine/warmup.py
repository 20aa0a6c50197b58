"""Warmup: pay every one-time cost before anyone is timing.

The port of the JAX package's engine/warmup.py. There, warm means every
jit entry compiled and banked in the persistent compilation cache. The
port compiles nothing at run time but its hand kernels, so warm means
every one-time cost paid in this phase:

  - the nvcc builds of the hand kernels (every source of ops/kernel_lib.py's
    registry, in one build: `build_libraries`), into the compile cache
    (utils/platform.py: OSIM_COMPILE_CACHE, else build/);
  - the g++ build of the native host runtime (native/), into the same
    directory, on every device: quantity parsing and group_runs' row hash
    run on the host. It is reported as `native_builds`, not as a compile
    event: the compile events count kernel builds;
  - the CUDA context;
  - the first launch of each registry entry (lazy module loading, library
    handles, the caching allocator's growth): `warmup_registry()` runs the
    capture pass of analysis/entry_audit.py, which calls every entry once at
    its canonical shapes; the report's per-entry seconds are those first
    calls' (`simon profile --gaps` times the warm calls after them);
  - with `include_sweep`, the canonical capacity sweep
    (entry_audit._run_sweeps), whose node-axis shapes are the ladder rungs
    a production capacity search rounds to (`ladder_rungs`).

A later process sharing OSIM_COMPILE_CACHE then builds nothing: `simon
warmup --check` (entry_audit.warm_start_check) demands exactly that.

No CUDA graph is captured and nothing goes through torch.compile: the
reference has neither (a graph per scan step is ROADMAP.md's perf
candidate 5).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "EntryWarmup",
    "WarmupReport",
    "warmup_registry",
    "registry_captures",
    "run_warmup",
]


@dataclasses.dataclass
class EntryWarmup:
    """One registry entry: the seconds of its first call (the capture's,
    which paid the one-time costs; the device synchronized around it)."""

    name: str
    seconds: float
    donated: List[int] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seconds": round(self.seconds, 4),
            "donated": list(self.donated),
        }


@dataclasses.dataclass
class WarmupReport:
    """What `simon warmup` did: the registry's entries, the sweep rehearsal
    and the compile cache's builds (`backend_compiles`) and hits.

    `ok` demands full registry coverage (every REQUIRED_COVERAGE entry
    captured and run), NOT zero builds: a cold process is supposed to build
    here. Zero builds is the warm-start check's demand."""

    entries: List[EntryWarmup]
    missing: List[str]
    seconds: float
    backend_compiles: int
    persistent_hits: int
    cache_dir: str = ""
    swept: bool = True
    #: node-bucket ladder rungs the sweep rehearsal ran batched programs at
    ladder_rungs: List[int] = dataclasses.field(default_factory=list)
    #: seconds of the kernel builds and the native library's (or of finding
    #: them in the cache)
    build_seconds: float = 0.0
    #: g++ runs of the native host runtime in this warmup (0 when cached)
    native_builds: int = 0
    #: whether the native host runtime loaded (False: no compiler)
    native: bool = False

    @property
    def cold_compiles(self) -> int:
        return self.backend_compiles

    @property
    def ok(self) -> bool:
        return not self.missing

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "entries": [e.to_dict() for e in self.entries],
            "missing": list(self.missing),
            "seconds": round(self.seconds, 4),
            "build_seconds": round(self.build_seconds, 4),
            "native": self.native,
            "native_builds": self.native_builds,
            "backend_compiles": self.backend_compiles,
            "persistent_hits": self.persistent_hits,
            "cold_compiles": self.cold_compiles,
            "cache_dir": self.cache_dir,
            "swept": self.swept,
            "ladder_rungs": list(self.ladder_rungs),
        }

    def render_text(self) -> str:
        lines = [
            f"warmup: {'ok' if self.ok else 'FAILED'} — "
            f"{len(self.entries)} entries warmed in {self.seconds:.2f}s "
            f"({self.backend_compiles} compile request(s), "
            f"{self.persistent_hits} persistent-cache hit(s), "
            f"{self.cold_compiles} cold)"
        ]
        if self.cache_dir:
            lines.append(f"  cache: {self.cache_dir} (builds {self.build_seconds:.2f}s)")
        lines.append(f"  native host runtime: {'loaded' if self.native else 'unavailable'} "
                     f"({self.native_builds} g++ build(s))")
        if not self.swept:
            lines.append("  sweep rehearsal: skipped (--no-sweep)")
        elif self.ladder_rungs:
            lines.append(f"  node-bucket rungs banked: {self.ladder_rungs}")
        for e in sorted(self.entries, key=lambda e: -e.seconds):
            don = f"  donates {e.donated}" if e.donated else ""
            lines.append(f"  {e.name:34s} {e.seconds:7.3f}s{don}")
        for name in self.missing:
            lines.append(f"  MISSING: {name} (audited but not captured)")
        return "\n".join(lines)


def warmup_registry(device=DEFAULT_DEVICE) -> List[Any]:
    """The registry: entry_audit's capture list, one _Captured (name,
    callable, canonical arguments) per entry, made by running the host
    dispatchers over the canonical state on `device` (which calls every
    entry once)."""
    from ..analysis.entry_audit import _capture_calls

    return _capture_calls(device)


def registry_captures(names: Any = None, device=DEFAULT_DEVICE) -> List[Any]:
    """`warmup_registry()` filtered to `names` (audit names like
    "ops.fast:schedule_scenarios"); None keeps everything. Raises KeyError
    naming the misses, before any capture when a name is no registry
    entry at all."""
    from ..analysis.entry_audit import entry_locations

    wanted = None if names is None else set(names)
    if wanted is not None and wanted - set(entry_locations()):
        raise KeyError(
            f"not in the capture registry: {sorted(wanted - set(entry_locations()))} "
            f"(known: {sorted(entry_locations())})"
        )
    caps = warmup_registry(device)
    if wanted is None:
        return caps
    got = [c for c in caps if c.name in wanted]
    missing = wanted - {c.name for c in got}
    if missing:
        raise KeyError(
            f"not in the capture registry: {sorted(missing)} "
            f"(known: {sorted(c.name for c in caps)})"
        )
    return got


def build_libraries(dev) -> bool:
    """The one-time builds into the compile cache: on a card the registry's
    kernels (ops/kernel_lib.py: SOURCES, one nvcc each, together), on every
    device the native host runtime. Returns whether the native runtime
    loaded."""
    from .. import native
    from ..ops import kernel_lib
    from ..utils import platform

    if dev.type == "cuda":
        platform.build_kernels(*kernel_lib.SOURCES)
    return native.available()


def run_warmup(include_sweep: bool = True, device=DEFAULT_DEVICE) -> WarmupReport:
    """Pay the one-time costs on `device`, in order: the kernel builds into
    the compile cache, the registry capture (every entry's first call,
    timed), and with `include_sweep` the canonical capacity sweep."""
    from .. import native
    from ..analysis.entry_audit import REQUIRED_COVERAGE, _run_sweeps
    from ..ops.fast import reset_scenario_programs, scenario_programs
    from ..utils.platform import CompileCounter, enable_compilation_cache, install_compile_listener

    dev = resolve_device(device)
    cache_dir = enable_compilation_cache()
    install_compile_listener()
    reset_scenario_programs()
    t_start = time.perf_counter()
    native_builds0 = native.builds
    with CompileCounter() as counter:
        loaded = build_libraries(dev)
        build_s = time.perf_counter() - t_start
        entries = [
            EntryWarmup(
                name=cap.name, seconds=cap.first_seconds,
                donated=sorted(getattr(cap.fn, "__osim_donate_argnums__", ()) or ()),
            )
            for cap in warmup_registry(dev)
        ]
        if include_sweep:
            _run_sweeps(dev)
    missing = sorted(REQUIRED_COVERAGE - {e.name for e in entries})
    return WarmupReport(
        entries=entries,
        missing=missing,
        seconds=time.perf_counter() - t_start,
        backend_compiles=counter.backend_compiles,
        persistent_hits=counter.persistent_hits,
        cache_dir=cache_dir,
        swept=include_sweep,
        ladder_rungs=sorted({n for (n, _p) in scenario_programs()}),
        build_seconds=build_s,
        native_builds=native.builds - native_builds0,
        native=loaded,
    )
