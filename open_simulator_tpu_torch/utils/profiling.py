"""Device-trace capture for the server's `GET /debug/profile?ms=N`.

After the JAX package's utils/profiling.py, cut to `profiler_available`
and `capture_device_trace` (the dispatch-gap analyzer and the `profile`
verb are ROADMAP.md item 14). The trace is `torch.profiler`'s: CUDA
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
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

from .tracing import span

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

    if _primed or torch.device(device).type != "cuda":
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
