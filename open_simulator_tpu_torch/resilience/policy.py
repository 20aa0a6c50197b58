"""Retry policies and circuit breakers for external I/O.

Production schedulers treat extender/apiserver flakiness as the common case:
a transport blip must cost one bounded retry, not a failed pod, and a dead
backend must fail fast instead of eating a full timeout per pod. Two
composable pieces implement that discipline:

  * `RetryPolicy` — bounded attempts with decorrelated-jitter exponential
    backoff (the AWS architecture-blog variant: each delay is drawn uniformly
    from [base, 3 × previous] and capped), a per-attempt timeout, and an
    overall deadline budget. The RNG, clock, and sleep function are all
    injectable so tests are deterministic and sleep-free.
  * `CircuitBreaker` — per-endpoint closed → open after N consecutive
    failures, half-open probe after a cooldown, success closes. State is
    exported through `osim_circuit_state{endpoint=}` and every retry through
    `osim_retry_attempts_total{target=}` (utils/metrics.py).

Both are dependency-free and thread-safe; the extender transport, the kube
client, and the capacity planner share them (see docs/resilience.md).
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Type

from ..utils import metrics


class RetryExhaustedError(Exception):
    """All attempts of a RetryPolicy.execute() call failed. `last_exc` is the
    final attempt's exception; `attempts` the number of attempts made."""

    def __init__(self, last_exc: BaseException, attempts: int) -> None:
        super().__init__(f"{last_exc} (after {attempts} attempt(s))")
        self.last_exc = last_exc
        self.attempts = attempts


class CircuitOpenError(Exception):
    """A call was refused because the endpoint's circuit breaker is open."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass
class RetryPolicy:
    """Bounded retry with decorrelated jitter.

    `execute(fn)` calls `fn(timeout)` up to `max_attempts` times; `timeout`
    is the per-attempt budget (min of `per_attempt_timeout_s` and the
    remaining `deadline_s`, or None when neither is set). Exceptions listed
    in `retryable` are retried after a backoff; anything else propagates
    immediately. When attempts or the deadline run out the last exception is
    wrapped in RetryExhaustedError so callers can render an aggregate
    message ("... after 3 attempts").
    """

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    per_attempt_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep
    # random.Random.uniform is a read-modify-write of hidden generator state;
    # the wave engine shares one policy across its HTTP worker threads, so
    # jitter draws must serialize (execute() itself keeps all other state in
    # locals). Excluded from comparison: a Lock carries no policy identity.
    _rng_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    @staticmethod
    def from_env(
        max_attempts: int = 3,
        deadline_s: Optional[float] = None,
    ) -> "RetryPolicy":
        """Policy from the OSIM_RETRY_* env knobs (docs/resilience.md).
        Arguments are the caller's defaults; a set env knob overrides them
        (OSIM_RETRY_DEADLINE_S <= 0 means no deadline)."""
        env_deadline = _env_float("OSIM_RETRY_DEADLINE_S", -1.0)
        if env_deadline >= 0:
            deadline_s = env_deadline if env_deadline > 0 else None
        return RetryPolicy(
            max_attempts=max(1, _env_int("OSIM_RETRY_MAX_ATTEMPTS", max_attempts)),
            base_s=max(0.0, _env_float("OSIM_RETRY_BASE_S", 0.05)),
            cap_s=max(0.0, _env_float("OSIM_RETRY_CAP_S", 2.0)),
            deadline_s=deadline_s,
            rng=random.Random(_env_int("OSIM_RETRY_JITTER_SEED", 0)),
        )

    def next_delay(self, prev_delay: float) -> float:
        """One decorrelated-jitter step: uniform(base, 3 × prev), capped.
        Thread-safe: the shared RNG draw serializes under `_rng_lock`."""
        lo = self.base_s
        hi = max(lo, prev_delay * 3.0)
        with self._rng_lock:
            return min(self.cap_s, self.rng.uniform(lo, hi))

    def _attempt_timeout(self, start: float) -> Optional[float]:
        """Per-attempt budget: min(per_attempt_timeout_s, remaining
        deadline). The deadline clamp floors at 0 — once the budget is
        blown, `remaining` is negative, and handing a negative/zero timeout
        to a transport (which commonly treats <=0 as *unbounded*) would let
        one attempt overshoot the whole deadline. execute() refuses to
        launch an attempt whose clamped budget is 0."""
        timeout = self.per_attempt_timeout_s
        if self.deadline_s is not None:
            remaining = max(0.0, self.deadline_s - (self.clock() - start))
            timeout = remaining if timeout is None else min(timeout, remaining)
        return timeout

    def execute(
        self,
        fn: Callable[[Optional[float]], object],
        retryable: Tuple[Type[BaseException], ...] = (Exception,),
        target: str = "",
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    ):
        start = self.clock()
        delay = self.base_s
        attempt = 0
        last_exc: BaseException = TimeoutError(
            f"retry deadline of {self.deadline_s}s exhausted before an "
            "attempt could start"
        )
        while True:
            attempt += 1
            timeout = self._attempt_timeout(start)
            if timeout is not None and timeout <= 0:
                # deadline exhausted before this attempt could launch
                raise RetryExhaustedError(last_exc, attempt - 1)
            try:
                return fn(timeout)
            except retryable as e:
                last_exc = e
                if attempt >= self.max_attempts:
                    raise RetryExhaustedError(e, attempt)
                delay = self.next_delay(delay)
                if (
                    self.deadline_s is not None
                    and (self.clock() - start) + delay > self.deadline_s
                ):
                    # the backoff would blow the overall budget: give up now
                    raise RetryExhaustedError(e, attempt)
                metrics.RETRY_ATTEMPTS.inc(target=target)
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    self.sleep(delay)


class CircuitBreaker:
    """Per-endpoint circuit breaker.

    closed: calls flow; N consecutive failures trip it open.
    open:   calls are refused (allow() is False) until `cooldown_s` elapses,
            then ONE probe is admitted (half-open).
    half-open: the probe's success closes the breaker; its failure reopens
            it (and restarts the cooldown). Further calls while the probe is
            in flight are refused.

    State is mirrored to osim_circuit_state{endpoint=} as 0/1/2 for
    closed/open/half-open.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

    def __init__(
        self,
        endpoint: str,
        failure_threshold: int = 5,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.endpoint = endpoint
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.last_error = ""
        self._opened_at = 0.0
        self._export()

    def _export(self) -> None:
        metrics.CIRCUIT_STATE.set(
            self._STATE_VALUE[self.state], endpoint=self.endpoint
        )

    def allow(self) -> bool:
        """True when a call may proceed; transitions open→half-open once the
        cooldown has elapsed (admitting exactly one probe)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self.state = self.HALF_OPEN
                    self._export()
                    return True
                return False
            # half-open: one probe already in flight
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = self.CLOSED
            self.consecutive_failures = 0
            self.last_error = ""
            self._export()

    def record_failure(self, error: str = "") -> None:
        with self._lock:
            self.consecutive_failures += 1
            if error:
                self.last_error = error
            if (
                self.state == self.HALF_OPEN
                or self.consecutive_failures >= self.failure_threshold
            ):
                self.state = self.OPEN
                self._opened_at = self.clock()
            self._export()

    def force_open(self, error: str = "forced open") -> None:
        """Trip the breaker immediately (test/chaos helper)."""
        with self._lock:
            self.consecutive_failures = max(
                self.consecutive_failures, self.failure_threshold
            )
            self.last_error = error
            self.state = self.OPEN
            self._opened_at = self.clock()
            self._export()

    def describe(self) -> str:
        return (
            f"circuit {self.state} ({self.consecutive_failures} consecutive "
            f"failure(s)"
            + (f"; last error: {self.last_error}" if self.last_error else "")
            + ")"
        )


# ---------------------------------------------------------------------------
# Endpoint-keyed breaker registry. HTTPExtender instances are rebuilt per
# simulate() call, so breaker state must live OUTSIDE them to persist across
# pods, probes, and capacity-search iterations; keyed by endpoint base URL.
# ---------------------------------------------------------------------------

_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(endpoint: str) -> CircuitBreaker:
    """Get-or-create the shared breaker for an endpoint. Threshold/cooldown
    come from OSIM_BREAKER_THRESHOLD / OSIM_BREAKER_COOLDOWN_S at creation."""
    with _breakers_lock:
        b = _breakers.get(endpoint)
        if b is None:
            b = _breakers[endpoint] = CircuitBreaker(
                endpoint,
                failure_threshold=max(1, _env_int("OSIM_BREAKER_THRESHOLD", 5)),
                cooldown_s=_env_float("OSIM_BREAKER_COOLDOWN_S", 30.0),
            )
        return b


def reset_breakers() -> None:
    """Drop all breaker state (test isolation; `simon chaos` startup)."""
    with _breakers_lock:
        _breakers.clear()


def breaker_states() -> Dict[str, str]:
    """endpoint -> state for every registered breaker, sorted by endpoint
    (the `simon chaos` report and /metrics-adjacent debugging)."""
    with _breakers_lock:
        return {ep: _breakers[ep].state for ep in sorted(_breakers)}
