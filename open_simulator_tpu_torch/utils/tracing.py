"""Timing spans, trace identity, the Chrome-trace export and logging.

The port's copy of the JAX package's span tree. Every span carries a trace id (32 hex digits,
shared by its trace) and a span id (16 hex digits). A `TraceContext`
snapshot of the active span (`current_context()`) crosses a thread or a
queue and is re-activated on the far side with `activate(ctx)`: the next
root span opened there becomes a child by id of the captured span. On the
wire the context is a W3C `traceparent` header (`TraceContext.
to_traceparent` / `from_traceparent`); lanes that share one execution are
related by span links (`Span.add_link`) instead of a parent. Spans nest
through a thread-local stack; every finished span feeds the metrics
histograms, and
each finished root tree is kept in a bounded ring (`recent_timings`), which
is where `chip_smoke.py` reads the simulator's phase split from, and fed
to the crash flight recorder (utils/flightrec.py). A root span
slower than OSIM_SLOW_TRACE seconds (default 1.0) logs its tree at WARNING,
the reference's LogIfLong. With OSIM_TRACE_FILE set, every finished root
tree is also exported as Chrome trace events (Perfetto, chrome://tracing);
see `_maybe_export_trace`.

Spans are host wall time on one clock: a span records its start and end
with `time.perf_counter_ns()`, and a root reads the epoch offset once when
it opens, which every span of its tree shares. So `start` (epoch seconds)
and `duration_s` place a child inside its parent exactly, and on the epoch
clock that torch.profiler's device events and `time.time_ns()` use. A span
around work queued on the card measures the enqueue unless the work ends
in a transfer to the host, as every simulator phase does (placements come
back as numpy arrays). `child_span` opens a phase only inside a trace, so
code that also runs outside one opens no stray root.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

from . import metrics

log = logging.getLogger("osim")

SLOW_TRACE_S = float(os.environ.get("OSIM_SLOW_TRACE", "1.0"))
HISTORY_MAX = 64


class TraceContext:
    """Immutable (trace_id, span_id): the part of a span's identity that
    crosses a thread, a queue or a process."""

    __slots__ = ("trace_id", "span_id")
    _TRACEPARENT_RE = re.compile(r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

    def __init__(self, trace_id: str, span_id: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, TraceContext) and self.trace_id == other.trace_id
                and self.span_id == other.span_id)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, {self.span_id})"

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_traceparent(self) -> str:
        """The W3C traceparent header (version 00, sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header: Optional[str]) -> Optional["TraceContext"]:
        """Parse a traceparent header; an absent or malformed header, version
        ff, or an all-zero id gives None (the request starts a fresh trace)."""
        if not header:
            return None
        m = cls._TRACEPARENT_RE.match(header.strip().lower())
        if m is None:
            return None
        version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
        if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id, span_id)


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "epoch_ns", "children", "meta",
                 "trace_id", "span_id", "parent_id", "links")

    def __init__(self, name: str, epoch_ns: Optional[int] = None) -> None:
        """`epoch_ns`: the tree's offset from perf_counter_ns to the epoch,
        which a child takes from its parent; a root reads it here."""
        self.name = name
        self.start_ns = time.perf_counter_ns()
        self.epoch_ns = time.time_ns() - self.start_ns if epoch_ns is None else epoch_ns
        self.end_ns: Optional[int] = None
        self.children: List["Span"] = []
        self.meta: dict = {}
        self.trace_id = ""
        self.span_id = os.urandom(8).hex()
        self.parent_id: Optional[str] = None
        self.links: List[dict] = []

    def _end_ns(self) -> int:
        return self.end_ns if self.end_ns is not None else time.perf_counter_ns()

    @property
    def duration(self) -> float:
        return (self._end_ns() - self.start_ns) / 1e9

    def epoch(self, per_s: int = 1_000_000_000) -> tuple:
        """(start, duration) on the epoch clock, in 1/per_s of a second.
        Each end is the correctly rounded quotient of an integer, and the
        duration their difference, which is exact (both ends lie within a
        factor of two): so start + duration is the end's rounding, and a
        child's interval lies inside its parent's exactly."""
        start = (self.start_ns + self.epoch_ns) / per_s
        return start, (self._end_ns() + self.epoch_ns) / per_s - start

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def add_link(self, ctx) -> None:
        """Record a non-parent relation to another span (a TraceContext or a
        Span): a packed lane and the pack that executed it."""
        self.links.append({"trace_id": ctx.trace_id, "span_id": ctx.span_id})

    def to_dict(self) -> dict:
        start, duration = self.epoch()
        d = {"name": self.name, "start": start, "duration_s": duration,
             "trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.links:
            d["links"] = [dict(ln) for ln in self.links]
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
        # a context re-activated on this thread (activate()): the next root
        # span opened here becomes its child by id
        self.remote: Optional[TraceContext] = None


_tracer = _Tracer()
_history: List[dict] = []
_history_lock = threading.Lock()


@contextmanager
def span(name: str, **meta):
    """Time a phase. Nested spans build a tree; a finished root is kept for
    recent_timings() and logged (at WARNING when slow)."""
    parent = _tracer.stack[-1] if _tracer.stack else None
    s = Span(name, None if parent is None else parent.epoch_ns)
    s.meta.update(meta)
    if parent is not None:
        parent.children.append(s)
        s.trace_id = parent.trace_id
        s.parent_id = parent.span_id
    elif _tracer.remote is not None:
        s.trace_id = _tracer.remote.trace_id
        s.parent_id = _tracer.remote.span_id
    else:
        s.trace_id = os.urandom(16).hex()
    _tracer.stack.append(s)
    try:
        yield s
    finally:
        s.end_ns = time.perf_counter_ns()
        _tracer.stack.pop()
        metrics.observe_span(s.name, s.duration)
        if parent is None:
            root = s.to_dict()
            with _history_lock:
                _history.append(root)
                del _history[:-HISTORY_MAX]
            _record_flight(root)
            _maybe_export_trace(s)
            if s.duration > SLOW_TRACE_S:
                log.warning("slow trace (> %.1fs):\n%s", SLOW_TRACE_S, s.render())
            else:
                log.debug("trace:\n%s", s.render())


@contextmanager
def child_span(name: str, **meta):
    """A span under the innermost open span of this thread; outside any
    span, nothing (yields None). For the phases of code that also runs
    outside a trace, where a span of its own would be a stray root."""
    if not _tracer.stack:
        yield None
        return
    with span(name, **meta) as s:
        yield s


def gc_passes() -> int:
    """The cyclic collector's passes so far, summed over its generations:
    read before and after a span, the difference is the passes inside it
    (the `gc_passes` meta of `pod-clones` and `validate`)."""
    return sum(g["collections"] for g in gc.get_stats())


def current_span() -> Optional[Span]:
    """The innermost open span on this thread, if any."""
    return _tracer.stack[-1] if _tracer.stack else None


def current_context() -> Optional[TraceContext]:
    """The context of the innermost open span, else the context activated on
    this thread, else None: what a dispatching thread hands a worker."""
    if _tracer.stack:
        return _tracer.stack[-1].context()
    return _tracer.remote


@contextmanager
def activate(ctx: Optional[TraceContext]):
    """Re-activate a captured context on this thread for the block: root
    spans opened inside become its children by id. None is a no-op."""
    if ctx is None:
        yield
        return
    prev = _tracer.remote
    _tracer.remote = ctx
    try:
        yield
    finally:
        _tracer.remote = prev


def current_trace_id() -> Optional[str]:
    ctx = current_context()
    return ctx.trace_id if ctx is not None else None


def _record_flight(root: dict) -> None:
    """Feed a finished root tree into the crash flight recorder. Lazy
    import: flightrec reads trace ids back through this module."""
    try:
        from . import flightrec

        flightrec.record_span(root)
    except Exception:  # the recorder must never break tracing
        pass


def current_traceparent() -> Optional[str]:
    """The W3C traceparent header for an outbound HTTP call, or None outside
    any trace (no id is minted: a header nobody can correlate is noise)."""
    ctx = current_context()
    return ctx.to_traceparent() if ctx is not None else None


def recent_timings() -> List[dict]:
    """Recent root span trees, oldest first."""
    with _history_lock:
        return list(_history)


# ---------------------------------------------------------------------------
# Chrome trace-event export (OSIM_TRACE_FILE)
# ---------------------------------------------------------------------------
#
# Each finished root tree is flattened into "X" (complete) events with
# epoch-microsecond `ts` and `dur`, and the whole accumulated event list is
# rewritten to the file (to a temporary name, then renamed): roots are rare
# (one per simulate() call), so the rewrite is cheap and the file is valid
# JSON after every root, even if the process dies mid-run. Every event
# carries its span's trace, span and parent ids (and links) as args, so the
# exported file stays one connected, offline-reconnectable tree per request.
# OSIM_TRACE_MAX_EVENTS (default 250,000) caps the events kept: past it the
# oldest are rotated out, with one warning per process.

_trace_lock = threading.Lock()
_trace_events: List[dict] = []
_TRACE_MAX_EVENTS = 250_000
_trace_overflow_logged = False


def _trace_max_events() -> int:
    """OSIM_TRACE_MAX_EVENTS, read per export; a bad value keeps the
    default."""
    raw = os.environ.get("OSIM_TRACE_MAX_EVENTS", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            log.warning("ignoring non-integer OSIM_TRACE_MAX_EVENTS=%r", raw)
    return _TRACE_MAX_EVENTS


def _span_events(s: Span, pid: int, tid: int, out: List[dict]) -> None:
    args = dict(s.meta)
    args["trace_id"] = s.trace_id
    args["span_id"] = s.span_id
    if s.parent_id:
        args["parent_id"] = s.parent_id
    if s.links:
        args["links"] = [dict(ln) for ln in s.links]
    ts, dur = s.epoch(1_000_000)
    out.append({
        "name": s.name, "cat": "osim", "ph": "X", "ts": ts, "dur": dur,
        "pid": pid, "tid": tid, "args": args,
    })
    for c in s.children:
        _span_events(c, pid, tid, out)


def _maybe_export_trace(root: Span) -> None:
    """Append a finished root's events to OSIM_TRACE_FILE's list and
    rewrite the file atomically; a no-op when the variable is unset."""
    path = os.environ.get("OSIM_TRACE_FILE", "").strip()
    if not path:
        return
    global _trace_overflow_logged
    events: List[dict] = []
    _span_events(root, os.getpid(), threading.get_ident(), events)
    with _trace_lock:
        cap = _trace_max_events()
        _trace_events.extend(events)
        overflow = len(_trace_events) - cap
        if overflow > 0:
            # oldest first: the newest spans are the ones an incident needs
            del _trace_events[:overflow]
            if not _trace_overflow_logged:
                _trace_overflow_logged = True
                log.warning(
                    "OSIM_TRACE_FILE: event cap %d reached; rotating oldest events out "
                    "(set OSIM_TRACE_MAX_EVENTS to resize)", cap,
                )
        payload = {"traceEvents": list(_trace_events), "displayTimeUnit": "ms"}
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError as exc:
            log.warning("OSIM_TRACE_FILE write failed: %s", exc)


def reset_trace_events() -> None:
    """Drop the accumulated trace events (and re-arm the cap warning)."""
    global _trace_overflow_logged
    with _trace_lock:
        _trace_events.clear()
        _trace_overflow_logged = False


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
