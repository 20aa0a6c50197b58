"""Overload-safe serving core: admission, deadlines, coalescing, shedding.

The port's copy of the JAX package's server/admission.py. POST bodies are
admitted into a bounded queue (`OSIM_SERVER_QUEUE_DEPTH`) drained by the
continuous-batching scheduler loop (server/loop.py), or shed at once with
a definite answer:

* queue full: 429 plus a `Retry-After` from the observed loop-iteration
  EWMA times the backlog (a flat DEFAULT_SERVICE_TIME_S before the first
  iteration);
* deadline: an `X-Osim-Deadline-Ms` header (or
  `OSIM_SERVER_DEFAULT_DEADLINE_MS`) rides the ticket as an absolute
  deadline; a ticket whose deadline passes while queued is shed at dequeue
  (429), and the remaining budget of a pack that starts bounds its device
  call through `durable/watchdog.guarded_call` (504 when it fires);
* draining (SIGTERM): everything still queued gets 503 plus Retry-After.

Tickets with the same coalesce key (body digest, plus the live snapshot's
generation) run as one executor entry whose result fans out to every
waiter. `osim_requests_dropped_total` counts the one failure that is never
acceptable: a waiter left without an answer because the loop thread died
(500). `OSIM_SERVER_PACK_WINDOW_MS` bounds how long a partial pack waits;
`OSIM_SERVER_COALESCE_MS` is its deprecated alias.

Tests drive the queue without the loop thread (`run_pending()`) under an
injectable clock, so shedding and deadlines are provable without sleeping.
Fault injection: target `admission`, kinds `queue_full` / `deadline_storm`
(op "submit") and `slow_drain` (op "drain").
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# Re-exported for the scheduler loop (server/loop.py), which resolves
# guarded_call / call_deadline_s / DeadlineExceeded through THIS module's
# namespace so tests monkeypatching `admission.guarded_call` keep
# intercepting the device call.
from ..durable.watchdog import (  # noqa: F401
    DeadlineExceeded,
    call_deadline_s,
    guarded_call,
)
from ..resilience import faults
from ..utils import metrics
from ..utils import tracing
from ..utils.tracing import log

# Serve-time defaults; the env knobs are resolved when the queue is
# constructed (serve()/make_server() time), never at import.
DEFAULT_QUEUE_DEPTH = 16
DEFAULT_COALESCE_MS = 0.0
DEFAULT_DEADLINE_MS = 0.0
#: Retry-After fallback for the zero-sample cold start: before the loop
#: has completed a single iteration there is no observed service time, so
#: the hint is this flat constant WITHOUT backlog scaling (the old code
#: multiplied a made-up 1 s by the backlog, telling the first burst's
#: clients to back off for the full queue depth before anything had run).
DEFAULT_SERVICE_TIME_S = 1.0

# One-time deprecation warning for OSIM_SERVER_COALESCE_MS (kept working
# as the pack-window upper bound; see SchedulerLoop). The flag is read and
# set under the lock because queues are constructed from handler-bearing
# modules.
_deprecation_lock = threading.Lock()
_coalesce_ms_warned = False


def _warn_coalesce_deprecated() -> None:
    global _coalesce_ms_warned
    with _deprecation_lock:
        if _coalesce_ms_warned:
            return
        _coalesce_ms_warned = True
    log.warning(
        "OSIM_SERVER_COALESCE_MS is deprecated: the coalesce window became "
        "the continuous-batching pack window (an upper bound, not a latency "
        "floor). Set OSIM_SERVER_PACK_WINDOW_MS instead; the old variable "
        "keeps working with identical units (docs/serving.md)."
    )

REASON_QUEUE_FULL = "queue_full"
REASON_DEADLINE = "deadline"
REASON_DRAINING = "draining"

#: Shed reason -> HTTP status. queue_full/deadline are client-retryable
#: (429); draining means THIS server is going away (503 + Retry-After).
_SHED_CODE = {
    REASON_QUEUE_FULL: 429,
    REASON_DEADLINE: 429,
    REASON_DRAINING: 503,
}


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %g", name, raw, default)
        return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))


def coalesce_key(
    path: str,
    body: dict,
    generation: Optional[int] = None,
    stale: bool = False,
) -> str:
    """Stable identity of a request's *work*: two requests with the same key
    would produce byte-identical results, so one simulate pass serves both.
    `generation` folds in the live-snapshot generation for kubeconfig-backed
    requests (the same body against a refreshed snapshot is different work).
    `stale` marks a snapshot served past a failed refresh: the failure does
    not advance the generation, so staleness needs its own key dimension —
    a request admitted while degraded must never share a response with one
    admitted against the same generation served fresh."""
    digest = hashlib.sha256(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()
    if generation is None:
        return f"{path}:{digest}"
    suffix = ":stale" if stale else ""
    return f"{path}:{digest}:gen{generation}{suffix}"


@dataclass
class Ticket:
    """One admitted (or shed) request. The handler thread blocks on `done`;
    the scheduler worker (or submit itself, for sheds) finalizes it."""

    body: dict
    key: str
    enqueued_at: float
    deadline_at: Optional[float] = None  # absolute, clock() domain
    # live-snapshot generation recorded at admission; None = not fenced.
    # the loop re-keys the ticket at pack time if the fence moved past it.
    fence_epoch: Optional[int] = None
    done: threading.Event = field(default_factory=threading.Event)
    # response (valid once done is set)
    code: int = 0
    payload: Optional[dict] = None
    headers: Dict[str, str] = field(default_factory=dict)
    shed_reason: str = ""
    # Trace context captured on the submitting (handler) thread so the
    # scheduler loop can parent/link its pack span to the request's trace
    # across the queue hop; pack_ctx is filled by the loop at execution
    # time so the handler can link its root span to the pack that served
    # the request (utils/tracing.py, docs/observability.md).
    trace_ctx: Optional[Any] = None
    pack_ctx: Optional[Any] = None

    def remaining_s(self, now: float) -> Optional[float]:
        if self.deadline_at is None:
            return None
        return self.deadline_at - now


class AdmissionQueue:
    """Bounded admission queue drained by the continuous-batching scheduler
    loop (server/loop.py).

    `execute` is the batch executor: it receives the pack's UNIQUE bodies
    (one per coalesce key, in arrival order) and returns one result per
    body — a payload dict, or an Exception instance for a per-body
    failure. All other parameters default from the environment at
    construction time (never import time):

        OSIM_SERVER_QUEUE_DEPTH         max queued requests (beyond the
                                        pack being executed)
        OSIM_SERVER_PACK_WINDOW_MS      upper bound on how long a PARTIAL
                                        pack waits for stragglers; 0
                                        disables (never a latency floor)
        OSIM_SERVER_COALESCE_MS         deprecated alias of the pack
                                        window (same units; warns once)
        OSIM_SERVER_DEFAULT_DEADLINE_MS deadline for requests that carry
                                        no X-Osim-Deadline-Ms; 0 = none

    `service_time_s` seeds the loop-iteration EWMA behind Retry-After;
    None (the default) starts with zero samples — sheds before the first
    completed iteration answer a flat DEFAULT_SERVICE_TIME_S hint instead
    of a backlog multiple of a constant nobody measured.

    `clock` and `watchdog_poll_s` are injectable so tests prove deadline
    and shed behavior without sleeping.
    """

    def __init__(
        self,
        execute: Callable[[List[dict]], List[Any]],
        *,
        depth: Optional[int] = None,
        coalesce_ms: Optional[float] = None,
        pack_window_ms: Optional[float] = None,
        pack_lanes: Optional[int] = None,
        default_deadline_ms: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        service_time_s: Optional[float] = None,
        watchdog_poll_s: float = 0.25,
        fence: Optional[Callable[[], int]] = None,
    ) -> None:
        self._execute = execute
        # Generation fence (engine/resident.py): called once per PACK at
        # pack-take time; fenced tickets whose recorded epoch differs are
        # re-keyed so they only coalesce with same-state work
        # (docs/serving.md).
        self._fence = fence
        self.depth = (
            depth
            if depth is not None
            else _env_int("OSIM_SERVER_QUEUE_DEPTH", DEFAULT_QUEUE_DEPTH)
        )
        if self.depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {self.depth}")
        # Pack window resolution: explicit pack_window_ms wins, then the
        # legacy coalesce_ms parameter, then OSIM_SERVER_PACK_WINDOW_MS,
        # then the deprecated OSIM_SERVER_COALESCE_MS (with a one-time
        # warning). The attribute keeps its historical name — it is public
        # API for tests and the server.
        if pack_window_ms is not None:
            window_ms = float(pack_window_ms)
        elif coalesce_ms is not None:
            window_ms = float(coalesce_ms)
        elif os.environ.get("OSIM_SERVER_PACK_WINDOW_MS", "").strip():
            window_ms = _env_float(
                "OSIM_SERVER_PACK_WINDOW_MS", DEFAULT_COALESCE_MS
            )
        else:
            if os.environ.get("OSIM_SERVER_COALESCE_MS", "").strip():
                _warn_coalesce_deprecated()
            window_ms = _env_float(
                "OSIM_SERVER_COALESCE_MS", DEFAULT_COALESCE_MS
            )
        self.coalesce_s = window_ms / 1000.0
        self.default_deadline_ms = (
            default_deadline_ms
            if default_deadline_ms is not None
            else _env_float("OSIM_SERVER_DEFAULT_DEADLINE_MS", DEFAULT_DEADLINE_MS)
        )
        self._clock = clock
        self._poll_s = watchdog_poll_s
        self._cv = threading.Condition()
        self._queue: List[Ticket] = []
        self._draining = False
        # Loop-iteration EWMA (seconds per iteration); None = no samples.
        self._service_time_s: Optional[float] = (
            max(float(service_time_s), 0.001)
            if service_time_s is not None
            else None
        )
        self._worker: Optional[threading.Thread] = None
        from .loop import SchedulerLoop  # local: loop.py imports this module

        self._loop = SchedulerLoop(self, pack_lanes=pack_lanes)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "AdmissionQueue":
        self._worker = threading.Thread(
            target=self._worker_main, name="osim-scheduler-loop", daemon=True
        )
        self._worker.start()
        return self

    def shutdown(self) -> None:
        """Begin draining: shed everything still QUEUED (reason=draining,
        those clients should retry elsewhere) and let the batch already
        executing complete and respond. Idempotent."""
        with self._cv:
            self._draining = True
            for t in self._queue:
                self._shed_locked(t, REASON_DRAINING)
            self._queue.clear()
            metrics.ADMISSION_QUEUE_DEPTH.set(0)
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._worker is not None:
            self._worker.join(timeout)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- submit / wait (handler-thread side) --------------------------------

    def submit(
        self,
        body: dict,
        *,
        key: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        op: str = "submit",
        fence_epoch: Optional[int] = None,
        trace_ctx: Optional[Any] = None,
    ) -> Ticket:
        """Admit, or immediately shed, one request. Never blocks.
        `fence_epoch` is the live-snapshot generation the caller keyed the
        request under (None = the request is not generation-dependent).
        `trace_ctx` pins the trace the ticket belongs to; defaults to the
        calling thread's current trace context, so the queue hop to the
        scheduler loop does not sever the request's trace."""
        now = self._clock()
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if trace_ctx is None:
            trace_ctx = tracing.current_context()
        ticket = Ticket(
            body=body,
            key=key if key is not None else coalesce_key("", body),
            enqueued_at=now,
            deadline_at=(now + deadline_ms / 1000.0) if deadline_ms > 0 else None,
            fence_epoch=fence_epoch,
            trace_ctx=trace_ctx,
        )
        rule = faults.maybe_inject("admission", op)
        with self._cv:
            if self._draining:
                self._shed_locked(ticket, REASON_DRAINING)
                return ticket
            if rule is not None and rule.kind == "queue_full":
                self._shed_locked(ticket, REASON_QUEUE_FULL)
                return ticket
            if rule is not None and rule.kind == "deadline_storm":
                # every request arrives with its deadline already spent —
                # must be shed at dequeue without entering a simulate call
                ticket.deadline_at = now
            if len(self._queue) >= self.depth:
                self._shed_locked(ticket, REASON_QUEUE_FULL)
                return ticket
            self._queue.append(ticket)
            metrics.ADMISSION_QUEUE_DEPTH.set(len(self._queue))
            self._cv.notify_all()
        return ticket

    def wait(self, ticket: Ticket, poll_s: float = 1.0) -> Ticket:
        """Block the handler thread until the ticket is finalized. If the
        worker dies with the ticket unfinalized (the only way a request
        could be silently dropped), answer 500 and count it dropped."""
        while not ticket.done.wait(poll_s):
            worker = self._worker
            if worker is not None and not worker.is_alive():
                self._drop(ticket)
                break
        return ticket

    # -- the scheduler-loop thread ------------------------------------------

    def worker_alive(self) -> bool:
        """Whether the scheduler-loop thread is running. The HTTP layer
        consults this before submit to take the per-request degradation
        path (docs/serving.md) instead of queueing behind a dead loop."""
        w = self._worker
        return w is not None and w.is_alive()

    def _worker_main(self) -> None:
        """Thread body: the continuous-batching loop (server/loop.py) plus
        crash containment — a dying loop drains every queued ticket as
        dropped (counted; the one unacceptable outcome) instead of leaving
        waiters hanging."""
        try:
            self._loop.run_forever()
        except BaseException:  # pragma: no cover - loop must never die silently
            log.exception("scheduler loop crashed; draining queue as dropped")
            with self._cv:
                for t in self._queue:
                    self._drop(t)
                self._queue.clear()
                metrics.ADMISSION_QUEUE_DEPTH.set(0)
            raise

    def run_pending(self) -> int:
        """Test/embedding hook: synchronously process everything queued NOW
        (no window waiting, no loop thread). Returns packs processed."""
        n = 0
        while True:
            with self._cv:
                batch = list(self._queue)
                self._queue.clear()
                metrics.ADMISSION_QUEUE_DEPTH.set(0)
            if not batch:
                return n
            self._loop.run_pack(batch)
            n += 1

    def _note_iteration(self, elapsed: float) -> None:
        """Fold one observed loop-iteration duration into the Retry-After
        EWMA. Called by the loop for EVERY iteration (even all-shed ones):
        the hint must track what an iteration costs under current load."""
        metrics.LOOP_ITERATION.observe(elapsed)
        with self._cv:
            if self._service_time_s is None:
                self._service_time_s = max(elapsed, 0.001)
            else:
                self._service_time_s = max(
                    0.3 * elapsed + 0.7 * self._service_time_s, 0.001
                )

    # -- finalization -------------------------------------------------------

    def _retry_hint_locked(self) -> int:
        """Honest backoff hint (seconds, >= 1): observed loop-iteration
        EWMA x backlog — with continuous batching the backlog drains pack
        by pack, so iterations-to-drain scales with how many tickets sit
        ahead. Zero-sample cold start (no iteration observed yet) answers
        the flat DEFAULT_SERVICE_TIME_S instead of backlog x guess."""
        if self._service_time_s is None:
            return max(1, int(math.ceil(DEFAULT_SERVICE_TIME_S)))
        backlog = len(self._queue) + 1
        return max(1, int(math.ceil(self._service_time_s * backlog)))

    def retry_after_s(self) -> int:
        with self._cv:
            return self._retry_hint_locked()

    def _shed_locked(self, ticket: Ticket, reason: str) -> None:
        self._finalize(
            ticket,
            _SHED_CODE[reason],
            {
                "error": f"request shed: {reason.replace('_', ' ')}",
                "reason": reason,
            },
            headers={"Retry-After": str(self._retry_hint_locked())},
            shed_reason=reason,
        )

    def _shed(self, ticket: Ticket, reason: str) -> None:
        with self._cv:
            self._shed_locked(ticket, reason)

    def _drop(self, ticket: Ticket) -> None:
        if ticket.done.is_set():
            return
        metrics.REQUESTS_DROPPED.inc()
        self._finalize(
            ticket, 500, {"error": "request dropped: scheduler worker died"}
        )

    def _finalize(
        self,
        ticket: Ticket,
        code: int,
        payload: dict,
        headers: Optional[Dict[str, str]] = None,
        shed_reason: str = "",
    ) -> None:
        if ticket.done.is_set():
            return
        ticket.code = code
        ticket.payload = payload
        if headers:
            ticket.headers.update(headers)
        ticket.shed_reason = shed_reason
        if shed_reason:
            metrics.REQUESTS_SHED.inc(reason=shed_reason)
        metrics.REQUEST_LATENCY.observe(
            max(self._clock() - ticket.enqueued_at, 0.0)
        )
        ticket.done.set()
