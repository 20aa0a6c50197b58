"""Scheduler metrics: labeled counters and histograms.

The port's copy of the JAX package's registry, cut to the metrics the
simulator, preemption, capacity search, scenario sweep, apply, extender
and resilience paths increment (kube-scheduler names under
the `osim_` prefix). No Prometheus exposition: the port has no server yet.

    osim_e2e_scheduling_duration_seconds  -> scheduler_e2e_scheduling_duration_seconds
    osim_pod_scheduling_attempts_total    -> scheduler_pod_scheduling_attempts
    osim_schedule_result_total{result=}   -> scheduler_schedule_attempts_total{result=}
    osim_filter_failure_total{reason=}    -> per-plugin unschedulable counts
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

# kube-scheduler's e2e duration buckets: exponential from 1 ms, factor 2,
# 15 buckets (1 ms .. ~16 s)
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(0.001 * 2 ** i for i in range(15))


class Counter:
    """One metric family; one float per label-value tuple."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)


class Gauge:
    """One float per label-value tuple, set to the latest value (or moved by
    inc/dec)."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)


class Histogram:
    """Bucketed observations per label tuple."""

    def __init__(
        self, name: str, help: str, labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets)) + (math.inf,)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], list] = {}   # [counts, sum, count]

    def observe(self, value: float, **labels: str) -> None:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != declared")
        key = tuple(str(labels[n]) for n in self.labelnames)
        value = float(value)
        idx = next(i for i, ub in enumerate(self.buckets) if value <= ub)
        with self._lock:
            child = self._children.setdefault(key, [[0] * len(self.buckets), 0.0, 0])
            child[0][idx] += 1
            child[1] += value
            child[2] += 1

    def child_state(self, **labels: str) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts, sum, count) of one label tuple."""
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            counts, total, n = self._children.get(key, [[0] * len(self.buckets), 0.0, 0])
            cum, running = [], 0
            for c in counts:
                running += c
                cum.append(running)
            return cum, total, n


E2E_SCHEDULING = Histogram(
    "osim_e2e_scheduling_duration_seconds",
    "End-to-end simulate() duration (root span), seconds.",
)
ENCODE_DURATION = Histogram(
    "osim_encode_duration_seconds",
    "Pod/cluster -> device-tensor encode duration, seconds.",
)
SPAN_DURATION = Histogram(
    "osim_span_duration_seconds",
    "Duration of every tracing span, by span name, seconds.",
    labelnames=("span",),
)
SCHEDULING_ATTEMPTS = Counter(
    "osim_pod_scheduling_attempts_total",
    "Pods entering a scheduling pass (preemption retries count again).",
)
SCHEDULE_RESULT = Counter(
    "osim_schedule_result_total",
    "Final scheduling outcomes: scheduled, unscheduled, or preempted "
    "(victims evicted by a committed preemption).",
    labelnames=("result",),
)
EXPAND_CACHE = Counter(
    "osim_expand_cache_total",
    "Workload expand-cache lookups inside simulate().",
    labelnames=("event",),
)
FILTER_FAILURE = Counter(
    "osim_filter_failure_total",
    "Per-(pod,node) filter rejections for pods that failed to schedule, "
    "by kube failure-reason string.",
    labelnames=("reason",),
)
PREEMPTION_ATTEMPTS = Counter(
    "osim_preemption_attempts_total",
    "Preemption attempts for unscheduled pods, by outcome.",
    labelnames=("outcome",),
)
PROBE_LANES = Counter(
    "osim_preemption_probe_lanes_total",
    "Post-eviction node states evaluated by the batched device probe "
    "(Simulator._device_fits_many), and the probe calls that carried them.",
    labelnames=("unit",),
)
APPLY_RUNS = Counter(
    "osim_apply_total",
    "simon-apply runs, by outcome.",
    labelnames=("outcome",),
)

CAPACITY_PROBES = Counter(
    "osim_capacity_probe_total",
    "Capacity-planner probes: serial simulate() probes plus the lanes of "
    "batched sweeps.",
)
CAPACITY_NODES_ADDED = Gauge(
    "osim_capacity_plan_nodes_added",
    "Nodes added by the most recent capacity plan.",
)
NODE_BUCKET = Gauge(
    "osim_node_bucket",
    "Node-axis ladder rung (padded node count, ops.encode.node_bucket) of "
    "the most recent capacity-sweep device call.",
)
BATCH_SWEEP_DURATION = Histogram(
    "osim_batch_sweep_duration_seconds",
    "Wall-clock duration of one batched multi-scenario sweep call "
    "(capacity ladder or refinement), seconds.",
)
LANE_OCCUPANCY = Histogram(
    "osim_lane_occupancy_ratio",
    "Real scenario lanes over padded lanes (s_real / s_pad) per batched "
    "sweep.",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)
SCENARIOS_PER_CALL = Histogram(
    "osim_scenarios_per_call",
    "Scenarios evaluated by one batched scheduling call; the sample count "
    "is the number of batched calls.",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
PLAN_CHUNKS = Counter(
    "osim_plan_chunks_total",
    "Commit chunks (or waves) executed by the chunked and wave scenario "
    "drivers.",
)
COMMIT_ROUNDS = Histogram(
    "osim_commit_rounds",
    "Rounds to fixpoint per wave of the wave commit engine (ops/wave.py); "
    "a wave that exhausts its round budget records the rounds it burned "
    "before the serial fallback.",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
)
WAVE_CONFLICTS = Counter(
    "osim_wave_conflicts_total",
    "Pod decisions revised between wave rounds (choice changes observed in "
    "rounds >= 2).",
)
WAVE_FALLBACKS = Counter(
    "osim_wave_fallbacks_total",
    "Waves re-run through the serial chunked scan after missing the "
    "fixpoint within the round budget (OSIM_WAVE_ROUNDS), by reason.",
    labelnames=("reason",),
)
RETRY_ATTEMPTS = Counter(
    "osim_retry_attempts_total",
    "Retries performed by resilience.RetryPolicy, by call target.",
    labelnames=("target",),
)
CIRCUIT_STATE = Gauge(
    "osim_circuit_state",
    "Per-endpoint circuit-breaker state (0=closed, 1=open, 2=half-open).",
    labelnames=("endpoint",),
)
FAULTS_INJECTED = Counter(
    "osim_faults_injected_total",
    "Faults injected by the resilience fault-injection harness.",
    labelnames=("target", "kind"),
)
EXTENDER_REQUESTS = Counter(
    "osim_extender_requests_total",
    "HTTP scheduler-extender round trips, by verb and outcome.",
    labelnames=("verb", "outcome"),
)
EXTENDER_DURATION = Histogram(
    "osim_extender_duration_seconds",
    "HTTP scheduler-extender round-trip duration, seconds, by verb and "
    "outcome (ok / error / circuit_open).",
    labelnames=("verb", "outcome"),
)
EXTENDER_INFLIGHT = Gauge(
    "osim_extender_inflight",
    "Per-pod extender HTTP chains currently in flight in the wave engine.",
)
EXTENDER_WAVE_SIZE = Histogram(
    "osim_extender_wave_size",
    "Pods per dispatched extender wave (real lanes, excluding bucket pad).",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
EXTENDER_WAVE_RESPILL = Counter(
    "osim_extender_wave_respill_total",
    "Wave pods respilled to the next wave after the commit-time feasibility "
    "recheck saw a mask changed by earlier commits.",
)
EXTENDER_SKIPPED = Counter(
    "osim_extender_skipped_total",
    "Ignorable extenders skipped after an error or an open circuit breaker.",
    labelnames=("endpoint",),
)

# span names with a dedicated kube-parity histogram
_SPAN_HISTOGRAMS = {"simulate": E2E_SCHEDULING, "encode": ENCODE_DURATION}


def observe_span(name: str, seconds: float) -> None:
    """Feed one finished tracing span into the histograms (called by
    tracing.span for every span; metrics never imports tracing)."""
    dedicated = _SPAN_HISTOGRAMS.get(name)
    if dedicated is not None:
        dedicated.observe(seconds)
    SPAN_DURATION.observe(seconds, span=name)
