"""Timing spans and logging.

The port's copy of the JAX package's span tree, without the W3C
traceparent on the wire and the Chrome-trace export (those come with the
tooling slice). Every span carries a trace id (32 hex digits, shared by its
tree) and a span id (16 hex digits). A worker thread nests its spans under
a span of the dispatching thread through current_context() / activate(). Spans nest through a
thread-local stack; every finished span feeds the metrics histograms, and
each finished root tree is kept in a bounded ring (`recent_timings`), which
is where `chip_smoke.py` reads the simulator's phase split from, and fed
to the crash flight recorder (utils/flightrec.py). A root span
slower than OSIM_SLOW_TRACE seconds (default 1.0) logs its tree at WARNING,
the reference's LogIfLong.

Spans are host wall time. A span around work queued on the card measures
the enqueue unless the work ends in a transfer to the host, as every
simulator phase does (placements come back as numpy arrays).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

from . import metrics

log = logging.getLogger("osim")

SLOW_TRACE_S = float(os.environ.get("OSIM_SLOW_TRACE", "1.0"))
HISTORY_MAX = 64


class Span:
    __slots__ = ("name", "start", "end", "children", "meta", "wall_start",
                 "trace_id", "span_id", "parent_id")

    def __init__(self, name: str) -> None:
        self.name = name
        self.start = time.perf_counter()
        self.wall_start = time.time()
        self.end: Optional[float] = None
        self.children: List["Span"] = []
        self.meta: dict = {}
        self.trace_id = ""
        self.span_id = os.urandom(8).hex()
        self.parent_id: Optional[str] = None

    @property
    def duration(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def to_dict(self) -> dict:
        d = {"name": self.name, "start": round(self.wall_start, 6),
             "duration_s": self.duration, "trace_id": self.trace_id,
             "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.meta:
            d["meta"] = dict(self.meta)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def render(self, indent: int = 0) -> str:
        lines = [f"{'  ' * indent}{self.name}: {self.duration * 1e3:.1f} ms"
                 + (f" {self.meta}" if self.meta else "")]
        lines += [c.render(indent + 1) for c in self.children]
        return "\n".join(lines)


class _Tracer(threading.local):
    def __init__(self) -> None:
        self.stack: List[Span] = []


_tracer = _Tracer()
_history: List[dict] = []
_history_lock = threading.Lock()


@contextmanager
def span(name: str, **meta):
    """Time a phase. Nested spans build a tree; a finished root is kept for
    recent_timings() and logged (at WARNING when slow)."""
    s = Span(name)
    s.meta.update(meta)
    parent = _tracer.stack[-1] if _tracer.stack else None
    if parent is not None:
        parent.children.append(s)
        s.trace_id = parent.trace_id
        s.parent_id = parent.span_id
    else:
        s.trace_id = os.urandom(16).hex()
    _tracer.stack.append(s)
    try:
        yield s
    finally:
        s.end = time.perf_counter()
        _tracer.stack.pop()
        metrics.observe_span(s.name, s.end - s.start)
        if parent is None:
            root = s.to_dict()
            with _history_lock:
                _history.append(root)
                del _history[:-HISTORY_MAX]
            _record_flight(root)
            if s.duration > SLOW_TRACE_S:
                log.warning("slow trace (> %.1fs):\n%s", SLOW_TRACE_S, s.render())
            else:
                log.debug("trace:\n%s", s.render())


def current_context() -> Optional[Span]:
    """The calling thread's innermost open span (None outside any span): a
    dispatching thread captures it so worker threads can nest under it."""
    return _tracer.stack[-1] if _tracer.stack else None


@contextmanager
def activate(ctx: Optional[Span]):
    """Open spans of this (worker) thread as children of `ctx`, a span
    captured on another thread by current_context(), for the block."""
    if ctx is None:
        yield
        return
    _tracer.stack.append(ctx)
    try:
        yield
    finally:
        _tracer.stack.pop()


def current_trace_id() -> Optional[str]:
    """The trace id of the calling thread's innermost open span, if any."""
    return _tracer.stack[-1].trace_id if _tracer.stack else None


def _record_flight(root: dict) -> None:
    """Feed a finished root tree into the crash flight recorder. Lazy
    import: flightrec reads trace ids back through this module."""
    try:
        from . import flightrec

        flightrec.record_span(root)
    except Exception:  # the recorder must never break tracing
        pass


def current_traceparent() -> Optional[str]:
    """The W3C traceparent of the calling thread's trace. The port does not
    put trace identity on the wire yet (ROADMAP item 14), so there is none:
    HTTP callers send no traceparent header."""
    return None


def recent_timings() -> List[dict]:
    """Recent root span trees, oldest first."""
    with _history_lock:
        return list(_history)


def span_seconds(tree: dict) -> dict:
    """Seconds per span name, summed over a finished span tree (as
    recent_timings() returns it), the root's own name included."""
    out: dict = {}

    def walk(node):
        out[node["name"]] = out.get(node["name"], 0.0) + node["duration_s"]
        for child in node.get("children", ()):
            walk(child)

    walk(tree)
    return out


def progress(fmt: str, *args) -> None:
    """Per-batch progress line (the reference's per-pod report.Progress,
    lifted to batch granularity)."""
    log.debug(fmt, *args)


_LEVELS = {
    "debug": logging.DEBUG, "info": logging.INFO, "warn": logging.WARNING,
    "warning": logging.WARNING, "error": logging.ERROR,
}
_log_handler: Optional[logging.Handler] = None


def init_logging(default: str = "info") -> None:
    """Honor the LogLevel env (debug/info/warn/error, case-insensitive;
    invalid values fall back to `default`). Idempotent."""
    level = _LEVELS.get(os.environ.get("LogLevel", default).strip().lower(), _LEVELS[default])
    global _log_handler
    if _log_handler is None:
        _log_handler = logging.StreamHandler()
        _log_handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s")
        )
        log.addHandler(_log_handler)
    _log_handler.setLevel(level)
    log.setLevel(level)
