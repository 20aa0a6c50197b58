"""Device-time profiling: the device-trace capture and the dispatch-gap
analyzer.

The port of the JAX package's utils/profiling.py. Two tools:

* **Device trace capture** (`capture_device_trace`), behind `simon profile
  -- <command>` and the server's `GET /debug/profile?ms=N`. The trace is
  `torch.profiler`'s: CUDA
activity (kernels, copies, through CUPTI) when the device is a card, CPU
activity (operators and `record_function` ranges, such as `domain_pop`'s
launch) always, from every thread of the process where the installed
PyTorch can (`profile_all_threads`), so the scheduler loop's work shows
up in a capture taken on an HTTP handler thread. The trace is written as
Chrome-trace JSON (Perfetto, chrome://tracing).

The profiler's tracing client initialises on first use and only when that
use is on the thread that imported torch; a capture started first from a
handler thread records no device activity. `prime()` makes that first use
there, once per process: the server hands it to the thread serving its
socket (the main thread under `simon server`) on the first CUDA capture,
and a program that embeds the server on another thread calls it itself.

* **Dispatch-gap analyzer** (`analyze_dispatch_gaps`): every registry entry
  (engine/warmup.registry_captures, the capture list of
  analysis/entry_audit.py) is called once outside the timed window, then
  timed `repeats` times, keeping the fastest. One definition serves every
  entry, including those that sync inside themselves (a `.item()` or a
  `.cpu()` in the middle of an entry would make the reference's
  block_until_ready sandwich call device time "dispatch"):

      total_ms    = wall between two torch.cuda.synchronize() around the
                    call (the fastest of the timed calls)
      device_ms   = the kernel time (CUDA activity: kernels, copies, sets)
                    summed from one torch.profiler capture of the timed
                    calls, divided by their number
      events_ms   = the span between two torch.cuda.Event(enable_timing)
                    recorded on the current stream around each timed call,
                    averaged: an upper bound of the device-busy time
      dispatch_ms = total_ms - device_ms (0 when the capture sums longer)
      gap_ratio   = dispatch_ms / total_ms

  The events cross-check the capture. A capture of an entry of a few us can
  hold no kernel at all (CUPTI's activity records for it never reach the
  capture), and a device time of 0 is never true on a card. So where the
  capture holds no kernel but the events show time, the entry's device_ms
  is its events_ms and `device_source` says "events" (in the JSON and the
  text report); otherwise it is "profiler". The events span includes the
  stream's idle waits on the host, so such an entry's gap ratio is a lower
  bound. osim_device_time_seconds is never set to 0 on a card.

  On the CPU there is no device: device_ms is 0 and the gap ratio 1. The
  per-entry numbers are published as osim_device_time_seconds{entry=} and
  osim_dispatch_gap_ratio{entry=} and emitted as `device:<entry>` spans
  (so OSIM_TRACE_FILE carries them). The aggregate gap is time-weighted:
  total dispatch over total wall, not a mean of ratios. Arguments an entry
  writes in place are copied afresh for every call (`_fresh_args`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..device import DEFAULT_DEVICE, resolve_device
from . import metrics
from .tracing import log, span

TRACE_NAME = "trace.json"


def profiler_available() -> bool:
    try:
        import torch.profiler  # noqa: F401

        return True
    except Exception:
        return False


def _activities(torch, device):
    out = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        out.append(torch.profiler.ProfilerActivity.CUDA)
    return out


_primed = False
_prime_lock = threading.Lock()


def primed() -> bool:
    """Whether prime() has run in this process."""
    return _primed


def prime(device="cuda") -> None:
    """An empty CUDA capture on the calling thread, which should be the one
    that imported torch: the profiler's client initialises there, so later
    captures from other threads record the device too. Once per process; a
    no-op for a CPU device."""
    global _primed
    import torch

    if torch.device(device).type != "cuda":
        return
    with _prime_lock:
        if _primed:
            return
        with _profile(torch, _activities(torch, device)):
            pass
        _primed = True


def _profile(torch, activities):
    """A torch.profiler.profile over `activities`, recording every thread
    when the installed PyTorch offers it."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return torch.profiler.profile(activities=activities, experimental_config=cfg)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=activities)


def capture_device_trace(
    out_dir: str, duration_ms: float = 1000.0, fn: Optional[Callable[[], Any]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Capture a profiler trace into `out_dir`/trace.json, around `fn()` when
    given, else for `duration_ms` of wall time. CUDA activity is recorded
    when `device` is a CUDA device. Returns {"ok", "trace_dir",
    "trace_file", "seconds"} (plus "error" on a failure); never raises."""
    import torch

    report: Dict[str, Any] = {"ok": False, "trace_dir": out_dir}
    t0 = time.perf_counter()
    err: Optional[str] = None
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = _profile(torch, _activities(torch, device))
        prof.__enter__()
    except Exception as e:
        report["error"] = str(e)
        return report
    try:
        with span("device-profile", out_dir=out_dir):
            if fn is not None:
                fn()
            else:
                time.sleep(max(float(duration_ms), 0.0) / 1000.0)
    except Exception as e:
        # the workload failed, not the profiler: stop the trace all the same
        err = f"{type(e).__name__}: {e}"
    path = os.path.join(out_dir, TRACE_NAME)
    try:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
    except Exception as e:
        report["error"] = err or str(e)
        return report
    if err is not None:
        report["error"] = err
        return report
    report.update(ok=True, trace_file=path, seconds=round(time.perf_counter() - t0, 4))
    return report


@dataclasses.dataclass
class EntryTiming:
    """One registry entry's fastest timed call (best of `repeats`)."""

    name: str
    dispatch_ms: float  # total_ms - device_ms: host time the device waited
    device_ms: float    # kernel time in the window, 0 on the CPU
    total_ms: float     # wall between two synchronizes around the call
    gap_ratio: float    # dispatch_ms / total_ms, in [0, 1]
    repeats: int
    #: "profiler" (the capture's kernel sum), "events" (the capture held no
    #: kernel: the CUDA events' span) or "none" (the CPU)
    device_source: str = "none"
    events_ms: float = 0.0  # CUDA events' span around the call, 0 on the CPU

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dispatch_ms": round(self.dispatch_ms, 4),
            "device_ms": round(self.device_ms, 4),
            "device_source": self.device_source,
            "events_ms": round(self.events_ms, 4),
            "total_ms": round(self.total_ms, 4),
            "gap_ratio": round(self.gap_ratio, 4),
            "repeats": self.repeats,
        }


@dataclasses.dataclass
class DispatchGapReport:
    entries: List[EntryTiming]
    seconds: float

    @property
    def device_time_ms(self) -> float:
        return round(sum(e.device_ms for e in self.entries), 4)

    @property
    def dispatch_gap_ratio(self) -> float:
        """Aggregate gap: total dispatch time over total wall time across
        every timed entry (NOT a mean of ratios: a 2 us entry must not
        outvote a 20 ms one)."""
        total = sum(e.total_ms for e in self.entries)
        if total <= 0:
            return 0.0
        return round(sum(e.dispatch_ms for e in self.entries) / total, 4)

    def to_dict(self) -> dict:
        return {
            "entries": [e.to_dict() for e in self.entries],
            "seconds": round(self.seconds, 4),
            "device_time_ms": self.device_time_ms,
            "dispatch_gap_ratio": self.dispatch_gap_ratio,
        }

    def render_text(self) -> str:
        lines = [
            f"dispatch-gap analysis: {len(self.entries)} entries in "
            f"{self.seconds:.2f}s — device {self.device_time_ms:.2f} ms, "
            f"aggregate gap ratio {self.dispatch_gap_ratio:.3f}"
        ]
        for e in sorted(self.entries, key=lambda e: -e.device_ms):
            src = " (events)" if e.device_source == "events" else ""
            lines.append(
                f"  {e.name:34s} device {e.device_ms:8.3f} ms  "
                f"dispatch {e.dispatch_ms:7.3f} ms  gap {e.gap_ratio:.3f}{src}"
            )
        return "\n".join(lines)


def _fresh_args(cap) -> tuple:
    """The argument tuple of one call: the positional arguments the entry
    writes in place (`__osim_donate_argnums__`) are copied, so the
    registry's stored arguments stay as captured; the others are passed as
    they are."""
    from ..analysis.entry_audit import copy_leaf, tree_map

    donated = set(getattr(cap.fn, "__osim_donate_argnums__", ()) or ())
    if not donated:
        return cap.args
    return tuple(
        tree_map(copy_leaf, arg) if i in donated else arg for i, arg in enumerate(cap.args)
    )


def _kernel_ms(prof) -> float:
    """Milliseconds of device activity (kernels, copies, sets) in a
    finished torch.profiler capture, summed over its raw events: a scan
    entry launches ~10^5 kernels, which the profiler's own event tree
    (`prof.events()`) takes minutes to build."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    return sum(e.duration_ns() for e in events if e.device_type() == cuda) / 1e6


def _timed_calls(cap, dev, repeats: int) -> tuple:
    """(fastest total ms, profiler device ms a call, events ms a call) of
    `repeats` calls of `cap` on `dev`. On a card one CUDA-only profiler
    capture spans the calls (a capture costs seconds to start and stop, more
    than most entries take) and a pair of timing events on the current
    stream brackets each call; the arguments are copied before it, so no
    copy is billed."""
    import torch

    arg_sets = [_fresh_args(cap) for _ in range(repeats)]
    totals = []
    spans = []

    def timed(args):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        cap.fn(*args, **cap.kwargs)
        if dev.type == "cuda":
            end.record(torch.cuda.current_stream(dev))
            torch.cuda.synchronize(dev)
            spans.append((start, end))
        totals.append((time.perf_counter() - t0) * 1e3)

    if dev.type != "cuda":
        for args in arg_sets:
            timed(args)
        return min(totals), 0.0, 0.0
    torch.cuda.synchronize(dev)
    with _capture(torch) as prof:
        for args in arg_sets:
            timed(args)
    events_ms = sum(s.elapsed_time(e) for s, e in spans) / repeats
    return min(totals), _kernel_ms(prof) / repeats, events_ms


def _capture(torch):
    """The CUDA-only profiler capture around the timed calls."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def device_reading(profiler_ms: float, events_ms: float, on_card: bool) -> tuple:
    """(device ms, source) of one entry: the capture's kernel sum, or the
    events' span where the capture held no kernel but the events show time
    (module docstring)."""
    if not on_card:
        return 0.0, "none"
    if profiler_ms <= 0.0 and events_ms > 0.0:
        return events_ms, "events"
    return profiler_ms, "profiler"


def analyze_dispatch_gaps(
    names: Optional[Sequence[str]] = None,
    repeats: int = 2,
    captures: Optional[Sequence[Any]] = None,
    device=DEFAULT_DEVICE,
) -> DispatchGapReport:
    """Time every registry entry at its canonical shapes on `device` and
    derive per-entry device ms and dispatch-gap fraction (module docstring).

    `names` filters the registry (audit names like
    "ops.fast:schedule_scenarios"); `captures` injects a prepared capture
    list (anything with .name/.fn/.args/.kwargs). Each entry is called once
    outside the timed window (the registry's capture makes that call),
    then `repeats` times, keeping the fastest."""
    dev = resolve_device(device)
    warmed = captures is None
    if captures is None:
        from ..engine.warmup import registry_captures

        captures = registry_captures(names, device=dev)
    repeats = max(1, int(repeats))
    t_start = time.perf_counter()
    entries: List[EntryTiming] = []
    with span("dispatch-gap-analysis", entries=len(captures)):
        for cap in captures:
            if not warmed:  # a first call must never be billed here
                cap.fn(*_fresh_args(cap), **cap.kwargs)
            with span(f"device:{cap.name}", entry=cap.name) as dev_span:
                total_ms, profiler_ms, events_ms = _timed_calls(cap, dev, repeats)
                device_ms, source = device_reading(profiler_ms, events_ms, dev.type == "cuda")
                dispatch_ms = max(total_ms - device_ms, 0.0)
                gap = dispatch_ms / total_ms if total_ms > 0 else 0.0
                dev_span.meta.update(
                    device_ms=round(device_ms, 4),
                    device_source=source,
                    dispatch_ms=round(dispatch_ms, 4),
                    gap_ratio=round(gap, 4),
                )
            entries.append(EntryTiming(
                name=cap.name, dispatch_ms=dispatch_ms, device_ms=device_ms,
                total_ms=total_ms, gap_ratio=gap, repeats=repeats,
                device_source=source, events_ms=events_ms,
            ))
            metrics.DEVICE_TIME.set(device_ms / 1e3, entry=cap.name)
            metrics.DISPATCH_GAP.set(gap, entry=cap.name)
    report = DispatchGapReport(entries=entries, seconds=time.perf_counter() - t_start)
    log.debug("dispatch-gap analysis:\n%s", report.render_text())
    return report
