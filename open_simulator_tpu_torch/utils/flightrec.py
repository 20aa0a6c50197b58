"""Crash flight recorder: the last N spans/journal keys, dumped on failure.

The port's copy of the JAX package's utils/flightrec.py. Postmortems of a
wedged or killed run keep asking the same three questions —
what was the process *doing* (spans), what had it *promised* (journal
records), and what had it *counted* (metrics) — right before the watchdog
fired / SIGTERM landed / the chaos plan aborted the apply / an exception
nobody caught unwound the stack. This module keeps an always-on bounded
ring of exactly that evidence and serializes it as ONE correlated JSON
artifact when any of those four triggers fires:

* **spans** — every finished root span tree feeds the ring via
  `tracing._record_flight` (compact summary: name, duration, trace/span
  IDs, meta — not the whole subtree);
* **journal event keys** — `durable/journal.RunJournal.append` notes each
  committed record's (event, seq, run_dir) plus the trace ID active on the
  appending thread, so a dump's journal notes join against the WAL on
  `seq` and against the spans on `trace_id`;
* **metric deltas** — counter/histogram movement since the recorder's
  baseline (lazily snapshotted at first record), so the dump shows what
  changed during the window, not the process's whole life.

Recording is a deque append under a lock — cheap enough to stay on in
every hot path. Dumping never raises: a flight recorder that can crash
the crashing process is worse than none.

Import direction: tracing feeds this module through a lazy import, and
this module reads trace IDs back through a lazy import of tracing — no
top-level cycle. The dump writes through `durable.journal.atomic_write`
(also lazy) so a crash mid-dump can't leave a torn artifact.

Env knobs: OSIM_FLIGHT_EVENTS (ring size, default 512) and
OSIM_FLIGHT_DIR (dump directory; falls back to the dump call's run_dir
argument, then the temporary directory: the reference's last resort is the
current directory, which would litter a checkout).
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_RING = 512

_lock = threading.Lock()
_events: "deque[dict]" = deque(maxlen=DEFAULT_RING)
_baseline: Optional[Dict[str, dict]] = None
_dump_seq = 0
_hooks_installed = False
_prev_sys_hook = None
_prev_threading_hook = None


def _ring_size() -> int:
    raw = os.environ.get("OSIM_FLIGHT_EVENTS", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return DEFAULT_RING


def _snapshot_metrics() -> Dict[str, dict]:
    from . import metrics

    return metrics.REGISTRY.snapshot()


def _record(ev: dict) -> None:
    global _baseline, _events
    with _lock:
        if _baseline is None:
            try:
                _baseline = _snapshot_metrics()
            except Exception:  # pragma: no cover - metrics must not kill us
                _baseline = {}
        size = _ring_size()
        if _events.maxlen != size:
            _events = deque(_events, maxlen=size)
        _events.append(ev)


def _current_trace_id() -> Optional[str]:
    try:
        from . import tracing

        return tracing.current_trace_id()
    except Exception:  # pragma: no cover
        return None


def record_span(root_dict: dict) -> None:
    """One finished root span tree (called by tracing on root close).
    Kept compact: identity + timing + meta, not the whole subtree."""
    _record(
        {
            "kind": "span",
            "ts": root_dict.get("start"),
            "name": root_dict.get("name"),
            "trace_id": root_dict.get("trace_id"),
            "span_id": root_dict.get("span_id"),
            "parent_id": root_dict.get("parent_id"),
            "duration_s": root_dict.get("duration_s"),
            "meta": root_dict.get("meta") or {},
        }
    )


def record_journal(event: str, seq: int, run_dir: str) -> None:
    """One durably committed journal record's key (called by
    RunJournal.append, post-fsync). `trace_id` is whatever trace the
    appending thread was inside — the correlation key of the dump."""
    _record(
        {
            "kind": "journal",
            "ts": round(time.time(), 6),
            "event": event,
            "seq": seq,
            "run_dir": run_dir,
            "trace_id": _current_trace_id(),
        }
    )


def note(kind: str, **payload: Any) -> None:
    """Free-form marker (e.g. a chaos rule firing) stamped with the active
    trace ID."""
    ev = {"kind": kind, "ts": round(time.time(), 6),
          "trace_id": _current_trace_id()}
    ev.update(payload)
    _record(ev)


# ---------------------------------------------------------------------------
# Dump
# ---------------------------------------------------------------------------


def _metric_deltas(
    baseline: Dict[str, dict], current: Dict[str, dict]
) -> Dict[str, list]:
    """Per-family sample movement since the baseline; zero-delta samples are
    dropped so the dump shows only what moved during the window."""

    def _sample_key(s: dict) -> tuple:
        return tuple(sorted((s.get("labels") or {}).items()))

    out: Dict[str, list] = {}
    for family, snap in current.items():
        base_samples = {
            _sample_key(s): s
            for s in (baseline.get(family) or {}).get("samples", [])
        }
        moved = []
        for s in snap.get("samples", []):
            base = base_samples.get(_sample_key(s), {})
            delta: Dict[str, Any] = {"labels": s.get("labels") or {}}
            changed = False
            for fieldname in ("value", "count", "sum"):
                if fieldname in s:
                    d = s[fieldname] - base.get(fieldname, 0)
                    if d:
                        delta[fieldname] = d
                        changed = True
            if changed:
                moved.append(delta)
        if moved:
            out[family] = moved
    return out


def dump(
    reason: str,
    *,
    run_dir: Optional[str] = None,
    error: Optional[str] = None,
) -> Optional[str]:
    """Write the flight-recorder artifact; returns its path, or None when
    the write failed (logged, never raised). One artifact per trigger:
    flightrec-<reason>-<pid>-<n>.json under OSIM_FLIGHT_DIR, else
    `run_dir`, else the temporary directory."""
    global _dump_seq
    try:
        import json

        from ..durable.journal import atomic_write

        with _lock:
            events = list(_events)
            baseline = dict(_baseline or {})
            _dump_seq += 1
            seq = _dump_seq
        try:
            deltas = _metric_deltas(baseline, _snapshot_metrics())
        except Exception:  # pragma: no cover
            deltas = {}
        traces: Dict[str, List[dict]] = {}
        for ev in events:
            traces.setdefault(ev.get("trace_id") or "untraced", []).append(ev)
        artifact = {
            "kind": "flight-recorder",
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "error": error,
            "events": events,
            "traces": traces,
            "metrics_delta": deltas,
        }
        out_dir = (
            os.environ.get("OSIM_FLIGHT_DIR", "").strip()
            or run_dir
            or tempfile.gettempdir()
        )
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"flightrec-{reason}-{os.getpid()}-{seq}.json"
        )
        atomic_write(path, json.dumps(artifact, sort_keys=True) + "\n")
        from .tracing import log

        log.warning("flight recorder: %s dump written to %s", reason, path)
        return path
    except Exception:  # pragma: no cover - never let the dump crash the crash
        try:
            from .tracing import log

            log.warning("flight recorder dump failed", exc_info=True)
        except Exception:
            pass
        return None


# ---------------------------------------------------------------------------
# Unhandled-crash hooks
# ---------------------------------------------------------------------------


def _sys_hook(exc_type, exc, tb) -> None:
    if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
        dump(
            "crash",
            error="".join(
                traceback.format_exception_only(exc_type, exc)
            ).strip(),
        )
    if _prev_sys_hook is not None:
        _prev_sys_hook(exc_type, exc, tb)


def _threading_hook(args) -> None:
    if not issubclass(args.exc_type, (KeyboardInterrupt, SystemExit)):
        dump(
            "crash",
            error="".join(
                traceback.format_exception_only(args.exc_type, args.exc_value)
            ).strip(),
        )
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def install_crash_hook() -> None:
    """Chain the flight-recorder dump into sys.excepthook and
    threading.excepthook (idempotent; previous hooks still run)."""
    global _hooks_installed, _prev_sys_hook, _prev_threading_hook
    with _lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    _prev_sys_hook = sys.excepthook
    sys.excepthook = _sys_hook
    _prev_threading_hook = threading.excepthook
    threading.excepthook = _threading_hook


def events() -> List[dict]:
    """Current ring contents, oldest first (tests, /debug introspection)."""
    with _lock:
        return list(_events)


def reset() -> None:
    """Clear the ring, the metrics baseline, and the dump counter (test
    isolation). Crash hooks stay installed."""
    global _baseline, _dump_seq
    with _lock:
        _events.clear()
        _baseline = None
        _dump_seq = 0
