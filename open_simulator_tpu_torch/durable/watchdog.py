"""Watchdogs: hard deadlines around backend acquisition and blocking calls.

After the JAX package's durable/watchdog.py. A blocking call runs in a
worker thread while the host polls a monotonic clock; when the deadline
passes, `DeadlineExceeded` is raised in the *caller*, the journal (when the
call has one) records a `watchdog` event, and the flight recorder dumps its
ring. Two deadlines:

    OSIM_BACKEND_DEADLINE_S  (default 90)  first contact with the device
    OSIM_CALL_DEADLINE_S     (default 0)   any guarded simulate/sweep call;
                                           0 runs the call inline

`acquire_backend` is the acquisition ladder: a first contact with the
device under the deadline, then one journaled retry (`backend_retry`).
After the second failure it journals `backend_error` and raises
BackendUnavailable. This is where the port departs from the reference,
whose ladder ends by switching JAX to the CPU and stamping
`fallback: cpu`: the port never moves a run to another device after a
failure. The `fallback` fields of outcome.json and `simon runs` stay, and
stay empty. OSIM_WARMUP=1 (or `warmup=True`) runs the warmup phase
(engine/warmup.run_warmup) right after the first contact, under its own
deadline, and journals a `warmup` event; a warmup that fails is journaled
(`warmup_error`) and the run goes on cold, on the same device, as the
reference's does.

The worker thread cannot be stopped and runs on; the CLI exits on
DeadlineExceeded (code 3), which ends it with the process, and `simon runs
resume` continues a journaled run from what it committed. Such a worker
may still be inside the device runtime's native code, where interpreter
shutdown would tear it down mid-call and abort the process (SIGABRT), so
the CLI ends a process that `abandoned_workers()` reports without
finalising the interpreter. Tests inject
`clock`/`poll_s` (and a fake probe), so deadline behaviour is testable
without sleeping.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..device import DEFAULT_DEVICE, resolve_device
from ..resilience import faults
from ..utils import metrics
from ..utils.tracing import log, span

DEFAULT_BACKEND_DEADLINE_S = 90.0
_WORKER_PREFIX = "osim-guarded-"


class DeadlineExceeded(Exception):
    """A guarded call outlived its deadline. The worker may still be
    running (blocking native code cannot be killed from the host)."""

    def __init__(self, stage: str, deadline_s: float) -> None:
        super().__init__(f"{stage} exceeded {deadline_s:g}s deadline")
        self.stage = stage
        self.deadline_s = deadline_s


class BackendUnavailable(RuntimeError):
    """The device could not be reached twice in a row (acquire_backend)."""


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %g", name, raw, default)
        return default


def backend_deadline_s() -> float:
    """Deadline of the first device contact (OSIM_BACKEND_DEADLINE_S)."""
    return _env_float("OSIM_BACKEND_DEADLINE_S", DEFAULT_BACKEND_DEADLINE_S)


def call_deadline_s() -> float:
    """Deadline of guarded calls (OSIM_CALL_DEADLINE_S); 0 = watchdog off."""
    return _env_float("OSIM_CALL_DEADLINE_S", 0.0)


def guarded_call(
    stage: str,
    fn: Callable[[], Any],
    deadline_s: float,
    *,
    clock: Callable[[], float] = time.monotonic,
    poll_s: float = 0.25,
    journal: Any = None,
) -> Any:
    """Run `fn()` in a watched worker thread; raise DeadlineExceeded if it
    has not finished within `deadline_s` (<= 0 runs `fn` inline). A fired
    deadline is counted, journaled (with `journal`) and dumped by the flight
    recorder next to the journal."""
    if deadline_s <= 0:
        return fn()

    result: List[Any] = []
    error: List[BaseException] = []
    done = threading.Event()

    def _worker() -> None:
        try:
            result.append(fn())
        except BaseException as e:  # noqa: B036 - forwards KeyboardInterrupt too
            error.append(e)
        finally:
            done.set()

    with span("watchdog", stage=stage, deadline_s=deadline_s):
        t = threading.Thread(target=_worker, name=f"{_WORKER_PREFIX}{stage}", daemon=True)
        start = clock()
        t.start()
        while not done.is_set():
            remaining = deadline_s - (clock() - start)
            if remaining <= 0 and not done.is_set():
                metrics.WATCHDOG_FIRED.inc(stage=stage)
                log.error("watchdog: %s exceeded %gs deadline", stage, deadline_s)
                if journal is not None:
                    journal.append("watchdog", stage=stage, deadline_s=deadline_s)
                try:
                    from ..utils import flightrec

                    flightrec.dump(
                        "watchdog",
                        run_dir=getattr(journal, "run_dir", None),
                        error=f"{stage} exceeded {deadline_s:g}s deadline",
                    )
                except Exception:
                    pass
                raise DeadlineExceeded(stage, deadline_s)
            done.wait(min(poll_s, max(remaining, 0.001)))
    if error:
        raise error[0]
    return result[0]


def abandoned_workers() -> List[str]:
    """Names of guarded workers still running after their deadline fired."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith(_WORKER_PREFIX) and t.is_alive()]


# ---------------------------------------------------------------------------
# Backend acquisition ladder.
# ---------------------------------------------------------------------------

def _default_probe(device=DEFAULT_DEVICE) -> str:
    """First device contact: touch the device and return its name (the
    card's name on CUDA, the device string elsewhere). The fault-injection
    point for backend faults (target=backend, op=acquire)."""
    import torch

    rule = faults.maybe_inject("backend", "acquire")
    if rule is not None:
        faults.apply_backend_fault(rule)
    dev = resolve_device(device)
    torch.zeros(4, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        return torch.cuda.get_device_name(dev)
    return str(dev)


def warmup_requested() -> bool:
    """OSIM_WARMUP=1 opts runs into the warmup phase after acquisition."""
    return os.environ.get("OSIM_WARMUP", "").strip().lower() in ("1", "true", "yes", "on")


def _warm_phase(deadline_s: float, journal: Any, info: Dict[str, Any], device) -> None:
    """The warmup phase after the first contact: every one-time cost paid
    while nothing is timed, journaled so that a warm start is recorded. A
    timeout or an error is journaled and the run goes on cold."""
    from ..engine.warmup import run_warmup

    try:
        report = guarded_call("warmup", lambda: run_warmup(device=device), deadline_s,
                              journal=journal)
    except Exception as e:  # the run goes on cold; the journal records why
        log.warning("warmup phase failed (%s); continuing cold", e)
        info["warmup"] = {"ok": False, "error": str(e)}
        if journal is not None:
            journal.append("warmup_error", error=str(e))
        return
    info["warmup"] = {
        "ok": report.ok, "entries": len(report.entries), "seconds": round(report.seconds, 3),
        "cold_compiles": report.cold_compiles, "cache_dir": report.cache_dir,
    }
    if journal is not None:
        journal.append("warmup", **info["warmup"])


def acquire_backend(
    deadline_s: Optional[float] = None,
    journal: Any = None,
    *,
    probe: Optional[Callable[[], str]] = None,
    clock: Callable[[], float] = time.monotonic,
    poll_s: float = 0.25,
    device=DEFAULT_DEVICE,
    warmup: Optional[bool] = None,
) -> Dict[str, Any]:
    """Reach `device` under a hard deadline: one try, one journaled retry,
    then `backend_error` and BackendUnavailable. `warmup` (default:
    OSIM_WARMUP) runs the warmup phase after the contact. Returns
    `{"device": name}` (plus `"warmup"` when the phase ran), the provenance
    the caller stamps on its output."""
    if deadline_s is None:
        deadline_s = backend_deadline_s()
    if warmup is None:
        warmup = warmup_requested()
    probe_fn = probe or (lambda: _default_probe(device))

    def _try(stage: str) -> str:
        return guarded_call(stage, probe_fn, deadline_s, clock=clock, poll_s=poll_s,
                            journal=journal)

    try:
        name = _try("backend-acquire")
        if journal is not None:
            journal.append("backend", device=name)
        info: Dict[str, Any] = {"device": name}
        if warmup:
            _warm_phase(deadline_s, journal, info, device)
        return info
    except Exception as first_err:  # DeadlineExceeded or a probe error
        if journal is not None:
            journal.append("backend_retry", error=str(first_err))
        log.warning("backend acquisition failed (%s); retrying once", first_err)
        try:
            name = _try("backend-retry")
        except Exception as second_err:
            reason = (f"backend acquisition timed out/failed twice: {first_err}; "
                      f"retry: {second_err}")
            log.error("%s", reason)
            if journal is not None:
                journal.append("backend_error", error=reason)
            raise BackendUnavailable(reason) from second_err
        if journal is not None:
            journal.append("backend", device=name, retried=True)
        info = {"device": name}
        if warmup:
            _warm_phase(deadline_s, journal, info, device)
        return info
