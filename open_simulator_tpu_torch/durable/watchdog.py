"""Host-side watchdog around a blocking call.

The port's copy of `guarded_call` from the JAX package's durable/watchdog.py
(without its backend acquisition ladder, journal and flight recorder):
OSIM_CALL_DEADLINE_S > 0 runs a capacity probe or sweep in a worker thread
and raises DeadlineExceeded when it outlives the deadline; 0, the default,
runs it inline. Nothing degrades to another device: the exception reaches
the caller. The worker thread cannot be stopped and runs on; the CLI
exits on DeadlineExceeded (code 3), which ends it with the process, so the
deadline bounds the wall of `simon apply`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, List

from ..utils.tracing import log, span


class DeadlineExceeded(Exception):
    """A guarded call outlived its deadline. The worker may still be
    running (blocking native code cannot be killed from the host)."""

    def __init__(self, stage: str, deadline_s: float) -> None:
        super().__init__(f"{stage} exceeded {deadline_s:g}s deadline")
        self.stage = stage
        self.deadline_s = deadline_s


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %g", name, raw, default)
        return default


def call_deadline_s() -> float:
    """Deadline of guarded calls (OSIM_CALL_DEADLINE_S); 0 = watchdog off."""
    return _env_float("OSIM_CALL_DEADLINE_S", 0.0)


# how often the host re-reads the clock while a guarded call runs
_POLL_S = 0.25


def guarded_call(stage: str, fn: Callable[[], Any], deadline_s: float) -> Any:
    """Run `fn()` in a watched worker thread; raise DeadlineExceeded if it
    has not finished within `deadline_s` (<= 0 runs `fn` inline)."""
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
        t = threading.Thread(target=_worker, name=f"osim-guarded-{stage}", daemon=True)
        start = time.monotonic()
        t.start()
        while not done.is_set():
            remaining = deadline_s - (time.monotonic() - start)
            if remaining <= 0 and not done.is_set():
                log.error("watchdog: %s exceeded %gs deadline", stage, deadline_s)
                raise DeadlineExceeded(stage, deadline_s)
            done.wait(min(_POLL_S, max(remaining, 0.001)))
    if error:
        raise error[0]
    return result[0]
