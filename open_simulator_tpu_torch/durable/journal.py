"""Run journal: an append-only JSONL write-ahead log per run directory.

The port's copy of the JAX package's durable/journal.py. Long capacity
sweeps are the runs that matter most and the runs most likely to die: a
preempted host, a wedged card, a deadline that ends the process. The WAL
discipline is the one a training stack applies to checkpoints: commit every
unit of proved work (a capacity trial, a batched sweep, a backend
acquisition, a commit chunk) to durable storage *before* moving on, so a
crashed run resumes from what it already proved instead of starting over.

Format: `<run_dir>/journal.jsonl`, one JSON object per line, in append
order. Every record carries `seq` (monotonic), `ts` (epoch seconds) and
`event` (the record type); everything else is event payload. Well-known
events:

    run_start / run_resume / run_end   run lifecycle + metadata
    backend / backend_retry / backend_error   acquisition ladder
    trial                               one committed capacity probe
    sweep                               one committed batched sweep
    final                               the plan-materializing replay
    plan_chunk / plan_done              commit chunks (durable/checkpoint.py)
    segment                             one completed bench segment
    watchdog                            a deadline fired
    resident_repair                     a resident-state repair

Durability: appends are `write + flush + fsync` per record — a SIGKILL
after `append()` returns can never lose that record. Readers tolerate the
one failure mode fsync-per-line leaves open: a torn final line (crash
mid-append) is discarded, not fatal, and `RunJournal.open` truncates the
torn tail so subsequent appends produce a valid file. Whole-file artifacts
(e.g. the run's `outcome.json`) go through `atomic_write` (tmp + fsync +
rename) instead, so they are either absent or complete.

Every append is mirrored into the observability stack: a
`journal-append` tracing span, the `osim_journal_events_total{event=}`
counter and a flight-recorder breadcrumb. `summarize_run` also reads the
reference's `backend_fallback` records, so a journal the JAX package wrote
lists the same; the port itself never falls back to another device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, TextIO, Tuple

from ..resilience import faults
from ..utils import metrics
from ..utils.tracing import log, span

JOURNAL_NAME = "journal.jsonl"


class JournalError(Exception):
    """A journal could not be opened or appended to."""


def atomic_write(path: str, data: "str | bytes") -> None:
    """Write a whole file atomically: tmp + fsync + rename (+ best-effort
    directory fsync). Readers see either the old content or the new,
    never a torn mix — the discipline every non-append run artifact
    (outcome.json, bench JSON snapshots) goes through."""
    if isinstance(data, str):
        data = data.encode()
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # directory fsync is belt-and-braces; not all filesystems allow it


def _scan(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse a journal file. Returns (events, good_bytes) where good_bytes
    is the file offset just past the last intact record. A torn/corrupt
    line and everything after it are discarded (conservative prefix): a
    WAL's guarantees only hold up to the first broken record."""
    events: List[Dict[str, Any]] = []
    good = 0
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except FileNotFoundError:
        return events, 0
    offset = 0
    for line in raw.split(b"\n"):
        consumed = len(line) + 1  # +1 for the newline split removed
        stripped = line.strip()
        if stripped:
            # a record is intact only if it parsed AND its newline made it
            # to disk (offset + len(line) < len(raw)); a crash mid-append
            # can leave a syntactically-complete JSON prefix with no
            # terminator, which the next append would otherwise corrupt
            terminated = offset + len(line) < len(raw)
            try:
                rec = json.loads(stripped)
            except ValueError:
                rec = None
            if not terminated or not isinstance(rec, dict) or "event" not in rec:
                log.warning(
                    "journal %s: discarding torn/invalid record at byte %d "
                    "(and any records after it)", path, offset,
                )
                break
            events.append(rec)
            good = offset + consumed
        offset += consumed
    return events, good


def replay(run_dir: str) -> List[Dict[str, Any]]:
    """Read-only replay of a run directory's journal, oldest record first.
    Torn tails are discarded, never fatal; a missing journal is []."""
    events, _ = _scan(os.path.join(run_dir, JOURNAL_NAME))
    return events


class RunJournal:
    """Append handle + replayed history for one run directory.

    Not safe for concurrent writers from multiple processes (a run owns its
    directory); appends from multiple threads of one process are fine."""

    run_dir: str
    path: str
    _events: List[Dict[str, Any]]
    _seq: int
    _lock: threading.Lock
    _fh: TextIO

    def __init__(self, run_dir: str) -> None:
        raise TypeError("use RunJournal.open(run_dir)")

    @classmethod
    def open(cls, run_dir: str) -> "RunJournal":
        run_dir = os.path.abspath(run_dir)
        try:
            os.makedirs(run_dir, exist_ok=True)
        except OSError as e:
            raise JournalError(f"cannot create run dir {run_dir}: {e}")
        path = os.path.join(run_dir, JOURNAL_NAME)
        events, good = _scan(path)
        if os.path.exists(path) and good < os.path.getsize(path):
            # repair the torn tail in place so future appends start on a
            # record boundary (the discarded bytes were never acknowledged)
            with open(path, "rb+") as fh:
                fh.truncate(good)
        self = object.__new__(cls)
        self.run_dir = run_dir
        self.path = path
        self._events = events
        self._seq = (events[-1]["seq"] + 1) if events else 0
        self._lock = threading.Lock()
        try:
            self._fh = open(path, "a", encoding="utf-8")
        except OSError as e:
            raise JournalError(f"cannot open journal {path}: {e}")
        return self

    # -- write path ---------------------------------------------------------

    def append(self, event: str, **payload: Any) -> Dict[str, Any]:
        """Durably commit one record (write + flush + fsync) and return it.
        The record is on disk when this returns — a crash immediately after
        cannot lose it."""
        rule = faults.maybe_inject("journal", event)
        if rule is not None:
            faults.apply_journal_fault(rule)
        with self._lock:
            rec: Dict[str, Any] = {
                "seq": self._seq,
                "ts": round(time.time(), 6),
                "event": event,
            }
            rec.update(payload)
            with span("journal-append", event=event):
                try:
                    self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except (OSError, ValueError) as e:
                    raise JournalError(f"journal append failed: {e}")
            self._seq += 1
            self._events.append(rec)
        metrics.JOURNAL_EVENTS.inc(event=event)
        try:
            # flight recorder breadcrumb (utils/flightrec.py): the event key
            # + seq + current trace id, so a post-crash dump correlates its
            # span ring to this journal's records. Never on the durability
            # path — an import/ring failure cannot fail the append.
            from ..utils import flightrec

            flightrec.record_journal(event, rec["seq"], self.run_dir)
        except Exception:
            pass
        return rec

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- read path ----------------------------------------------------------

    def events(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        """Committed records, oldest first (optionally one event type)."""
        with self._lock:
            evs = list(self._events)
        if event is not None:
            evs = [e for e in evs if e.get("event") == event]
        return evs

    def has(self, event: str) -> bool:
        return any(e.get("event") == event for e in self.events())


# ---------------------------------------------------------------------------
# Replay helpers shared by the capacity planner, bench, and `simon runs`.
# ---------------------------------------------------------------------------

def completed_segments(events: List[Dict[str, Any]]) -> Dict[str, Dict]:
    """segment name -> journaled result dict (last write wins)."""
    out: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") == "segment" and e.get("segment"):
            out[str(e["segment"])] = e.get("result") or {}
    return out


def default_runs_root() -> str:
    """Where `simon runs` looks by default (OSIM_RUNS_DIR overrides)."""
    return os.environ.get("OSIM_RUNS_DIR", "").strip() or os.path.join(
        os.path.expanduser("~"), ".cache", "open-simulator-tpu", "runs"
    )


def summarize_run(run_dir: str) -> Dict[str, Any]:
    """One run directory -> a flat summary row for `simon runs list/show`."""
    events = replay(run_dir)
    by = {}
    for e in events:
        by.setdefault(e.get("event"), []).append(e)
    start = (by.get("run_start") or [{}])[0]
    status = "in-flight/crashed"
    outcome = ""
    if by.get("run_end"):
        status = "completed"
        outcome = str(by["run_end"][-1].get("outcome", ""))
    backend = (by.get("backend") or by.get("backend_fallback") or [{}])[-1]
    return {
        "run_dir": os.path.abspath(run_dir),
        "name": os.path.basename(os.path.abspath(run_dir)),
        "started": start.get("ts"),
        "kind": start.get("kind", ""),
        "config": start.get("simon_config", ""),
        "status": status,
        "outcome": outcome,
        "events": len(events),
        "trials": len(by.get("trial") or []),
        "segments": len(completed_segments(events)),
        "resumes": len(by.get("run_resume") or []),
        "watchdogs": len(by.get("watchdog") or []),
        "device": backend.get("device", "")
        or ("cpu" if backend.get("fallback") == "cpu" else ""),
        "fallback": backend.get("fallback", ""),
    }


def list_runs(root: str) -> List[Dict[str, Any]]:
    """Summaries for every journaled run directory under `root`, newest
    first (by run_start timestamp, unknown timestamps last)."""
    out = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return out
    for name in entries:
        run_dir = os.path.join(root, name)
        if os.path.isfile(os.path.join(run_dir, JOURNAL_NAME)):
            out.append(summarize_run(run_dir))
    out.sort(key=lambda r: -(r["started"] or 0.0))
    return out
