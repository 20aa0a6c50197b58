"""Scheduler metrics: a registry of labeled counters, gauges and histograms.

The port's copy of the JAX package's registry, cut to the metrics the
simulator, preemption, capacity search, scenario sweep, apply, extender,
resilience, durability and resident-state paths increment (kube-scheduler
names under the `osim_` prefix). `REGISTRY.snapshot()` is the JSON form the
flight recorder (utils/flightrec.py) and `simon chaos` read;
`REGISTRY.reset()` zeroes every sample, and `REGISTRY.render()` is the
Prometheus text exposition (format 0.0.4) the server's `GET /metrics`
serves, byte for byte the JAX registry's for the same metrics and samples.

    osim_e2e_scheduling_duration_seconds  -> scheduler_e2e_scheduling_duration_seconds
    osim_pod_scheduling_attempts_total    -> scheduler_pod_scheduling_attempts
    osim_schedule_result_total{result=}   -> scheduler_schedule_attempts_total{result=}
    osim_filter_failure_total{reason=}    -> per-plugin unschedulable counts
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# kube-scheduler's e2e duration buckets: exponential from 1 ms, factor 2,
# 15 buckets (1 ms .. ~16 s)
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(0.001 * 2 ** i for i in range(15))


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_labels(
    labelnames: Sequence[str], labelvalues: Sequence[str], extra: str = ""
) -> str:
    """`{a="x",b="y"}`, or "" when there are no labels."""
    parts = ['%s="%s"' % (n, _escape_label_value(v)) for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, float) and value.is_integer() and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(float(value))


class _Metric:
    """One metric family; children keyed by label-value tuples. A metric
    without labels holds its one sample from the start."""

    kind = "untyped"

    def __init__(
        self, name: str, help: str, labelnames: Sequence[str] = (),
        lock: Optional[threading.RLock] = None,
    ) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock if lock is not None else threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._child(())

    def _new_child(self) -> object:
        raise NotImplementedError

    def _child(self, key: Tuple[str, ...]) -> object:
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._new_child()
        return child

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _clear(self) -> None:
        self._children.clear()
        if not self.labelnames:
            self._child(())

    def _sample_lines(self) -> Iterable[str]:
        raise NotImplementedError

    def render(self) -> str:
        """This family in the text format: HELP, TYPE, then its samples in
        label order."""
        with self._lock:
            lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                     f"# TYPE {self.name} {self.kind}"]
            lines.extend(self._sample_lines())
        return "\n".join(lines) + "\n"


class Counter(_Metric):
    """One float per label-value tuple, only ever increased."""

    kind = "counter"

    def _new_child(self) -> list:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._child(key)[0] += amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            return child[0] if child is not None else 0.0

    def _sample_lines(self) -> Iterable[str]:
        for key in sorted(self._children):
            yield "%s%s %s" % (self.name, _format_labels(self.labelnames, key),
                               _format_value(self._children[key][0]))

    def snapshot(self) -> dict:
        with self._lock:
            samples = [
                {"labels": dict(zip(self.labelnames, key)), "value": val[0]}
                for key, val in sorted(self._children.items())
            ]
        return {"type": self.kind, "help": self.help, "samples": samples}


class Gauge(Counter):
    """One float per label-value tuple, set to the latest value (or moved by
    inc/dec)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._child(key)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._child(key)[0] += amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets  # per bucket, not cumulative
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Bucketed observations per label tuple."""

    kind = "histogram"

    def __init__(
        self, name: str, help: str, labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS, lock: Optional[threading.RLock] = None,
    ) -> None:
        ordered = sorted(float(b) for b in buckets)
        if ordered[-1] != math.inf:
            ordered.append(math.inf)
        self.buckets = tuple(ordered)
        super().__init__(name, help, labelnames, lock=lock)

    def _new_child(self) -> _HistChild:
        return _HistChild(len(self.buckets))

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        value = float(value)
        idx = next(i for i, ub in enumerate(self.buckets) if value <= ub)
        with self._lock:
            child = self._child(key)
            child.counts[idx] += 1
            child.sum += value
            child.count += 1

    def child_state(self, **labels: str) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts, sum, count) of one label tuple."""
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                return [0] * len(self.buckets), 0.0, 0
            cum, running = [], 0
            for c in child.counts:
                running += c
                cum.append(running)
            return cum, child.sum, child.count

    def _sample_lines(self) -> Iterable[str]:
        for key in sorted(self._children):
            child = self._children[key]
            running = 0
            for ub, c in zip(self.buckets, child.counts):
                running += c
                le = _format_labels(self.labelnames, key, extra='le="%s"' % _format_value(ub))
                yield "%s_bucket%s %d" % (self.name, le, running)
            plain = _format_labels(self.labelnames, key)
            yield "%s_sum%s %s" % (self.name, plain, _format_value(child.sum))
            yield "%s_count%s %d" % (self.name, plain, child.count)

    def snapshot(self) -> dict:
        with self._lock:
            samples = []
            for key, child in sorted(self._children.items()):
                running, cum = 0, []
                for c in child.counts:
                    running += c
                    cum.append(running)
                samples.append({
                    "labels": dict(zip(self.labelnames, key)),
                    "buckets": {_format_value(ub): n for ub, n in zip(self.buckets, cum)},
                    "sum": child.sum,
                    "count": child.count,
                })
        return {"type": self.kind, "help": self.help, "samples": samples}


class MetricsRegistry:
    """Get-or-create registry; registering a name again returns the metric
    (and raises if its kind or label set changed)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames, **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with a different kind or label set"
                    )
                return existing
            metric = cls(name, help, labelnames, lock=self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4, families in name order,
        ending in exactly one newline (an empty registry renders "\\n")."""
        with self._lock:
            families = [self._metrics[n] for n in sorted(self._metrics)]
        out = "".join(f.render() for f in families)
        return out if out.endswith("\n") else out + "\n"

    def snapshot(self, include_empty: bool = False) -> Dict[str, dict]:
        """{metric name: its snapshot()}, skipping metrics with no nonzero
        sample unless `include_empty`."""
        with self._lock:
            families = sorted(self._metrics.items())
        out = {}
        for name, metric in families:
            snap = metric.snapshot()
            if not include_empty and not any(
                s.get("value") or s.get("count") for s in snap["samples"]
            ):
                continue
            out[name] = snap
        return out

    def reset(self) -> None:
        """Zero every sample; registrations stay."""
        with self._lock:
            for metric in self._metrics.values():
                metric._clear()


REGISTRY = MetricsRegistry()

E2E_SCHEDULING = REGISTRY.histogram(
    "osim_e2e_scheduling_duration_seconds",
    "End-to-end simulate() duration (root span), seconds.",
)
ENCODE_DURATION = REGISTRY.histogram(
    "osim_encode_duration_seconds",
    "Pod/cluster -> device-tensor encode duration, seconds.",
)
SPAN_DURATION = REGISTRY.histogram(
    "osim_span_duration_seconds",
    "Duration of every tracing span, by span name, seconds.",
    labelnames=("span",),
)
SCHEDULING_ATTEMPTS = REGISTRY.counter(
    "osim_pod_scheduling_attempts_total",
    "Pods entering a scheduling pass (preemption retries count again).",
)
SCHEDULE_RESULT = REGISTRY.counter(
    "osim_schedule_result_total",
    "Final scheduling outcomes: scheduled, unscheduled, or preempted "
    "(victims evicted by a committed preemption).",
    labelnames=("result",),
)
EXPAND_CACHE = REGISTRY.counter(
    "osim_expand_cache_total",
    "Workload expand-cache lookups inside simulate().",
    labelnames=("event",),
)
FILTER_FAILURE = REGISTRY.counter(
    "osim_filter_failure_total",
    "Per-(pod,node) filter rejections for pods that failed to schedule, "
    "by kube failure-reason string.",
    labelnames=("reason",),
)
PREEMPTION_ATTEMPTS = REGISTRY.counter(
    "osim_preemption_attempts_total",
    "Preemption attempts for unscheduled pods, by outcome.",
    labelnames=("outcome",),
)
PROBE_LANES = REGISTRY.counter(
    "osim_preemption_probe_lanes_total",
    "Post-eviction node states evaluated by the batched device probe "
    "(Simulator._device_fits_many), and the probe calls that carried them.",
    labelnames=("unit",),
)
APPLY_RUNS = REGISTRY.counter(
    "osim_apply_total",
    "simon-apply runs, by outcome.",
    labelnames=("outcome",),
)

CAPACITY_PROBES = REGISTRY.counter(
    "osim_capacity_probe_total",
    "Capacity-planner probes: serial simulate() probes plus the lanes of "
    "batched sweeps.",
)
CAPACITY_NODES_ADDED = REGISTRY.gauge(
    "osim_capacity_plan_nodes_added",
    "Nodes added by the most recent capacity plan.",
)
NODE_BUCKET = REGISTRY.gauge(
    "osim_node_bucket",
    "Node-axis ladder rung (padded node count, ops.encode.node_bucket) of "
    "the most recent capacity-sweep device call.",
)
BATCH_SWEEP_DURATION = REGISTRY.histogram(
    "osim_batch_sweep_duration_seconds",
    "Wall-clock duration of one batched multi-scenario sweep call "
    "(capacity ladder or refinement), seconds.",
)
LANE_OCCUPANCY = REGISTRY.histogram(
    "osim_lane_occupancy_ratio",
    "Real scenario lanes over padded lanes (s_real / s_pad) per batched "
    "sweep.",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)
SCENARIOS_PER_CALL = REGISTRY.histogram(
    "osim_scenarios_per_call",
    "Scenarios evaluated by one batched scheduling call; the sample count "
    "is the number of batched calls.",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
PLAN_CHUNKS = REGISTRY.counter(
    "osim_plan_chunks_total",
    "Commit chunks (or waves) executed by the chunked and wave scenario "
    "drivers.",
)
COMMIT_ROUNDS = REGISTRY.histogram(
    "osim_commit_rounds",
    "Rounds to fixpoint per wave of the wave commit engine (ops/wave.py); "
    "a wave that exhausts its round budget records the rounds it burned "
    "before the serial fallback.",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
)
WAVE_CONFLICTS = REGISTRY.counter(
    "osim_wave_conflicts_total",
    "Pod decisions revised between wave rounds (choice changes observed in "
    "rounds >= 2).",
)
WAVE_FALLBACKS = REGISTRY.counter(
    "osim_wave_fallbacks_total",
    "Waves re-run through the serial chunked scan after missing the "
    "fixpoint within the round budget (OSIM_WAVE_ROUNDS), by reason.",
    labelnames=("reason",),
)
RETRY_ATTEMPTS = REGISTRY.counter(
    "osim_retry_attempts_total",
    "Retries performed by resilience.RetryPolicy, by call target.",
    labelnames=("target",),
)
CIRCUIT_STATE = REGISTRY.gauge(
    "osim_circuit_state",
    "Per-endpoint circuit-breaker state (0=closed, 1=open, 2=half-open).",
    labelnames=("endpoint",),
)
FAULTS_INJECTED = REGISTRY.counter(
    "osim_faults_injected_total",
    "Faults injected by the resilience fault-injection harness.",
    labelnames=("target", "kind"),
)
EXTENDER_REQUESTS = REGISTRY.counter(
    "osim_extender_requests_total",
    "HTTP scheduler-extender round trips, by verb and outcome.",
    labelnames=("verb", "outcome"),
)
EXTENDER_DURATION = REGISTRY.histogram(
    "osim_extender_duration_seconds",
    "HTTP scheduler-extender round-trip duration, seconds, by verb and "
    "outcome (ok / error / circuit_open).",
    labelnames=("verb", "outcome"),
)
EXTENDER_INFLIGHT = REGISTRY.gauge(
    "osim_extender_inflight",
    "Per-pod extender HTTP chains currently in flight in the wave engine.",
)
EXTENDER_WAVE_SIZE = REGISTRY.histogram(
    "osim_extender_wave_size",
    "Pods per dispatched extender wave (real lanes, excluding bucket pad).",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
EXTENDER_WAVE_RESPILL = REGISTRY.counter(
    "osim_extender_wave_respill_total",
    "Wave pods respilled to the next wave after the commit-time feasibility "
    "recheck saw a mask changed by earlier commits.",
)
EXTENDER_SKIPPED = REGISTRY.counter(
    "osim_extender_skipped_total",
    "Ignorable extenders skipped after an error or an open circuit breaker.",
    labelnames=("endpoint",),
)

SNAPSHOT_STALE = REGISTRY.counter(
    "osim_snapshot_stale_total",
    "Server requests served from a stale cluster snapshot after a refresh "
    "failure.",
)
WATCHDOG_FIRED = REGISTRY.counter(
    "osim_watchdog_fired_total",
    "Watchdog deadlines that fired on a guarded call (backend acquisition, "
    "simulate and sweep calls), by stage.",
    labelnames=("stage",),
)
RUN_RESUMED = REGISTRY.counter(
    "osim_run_resumed_total",
    "Runs resumed from a journal (apply --resume, simon runs resume).",
)
CHECKPOINT_BYTES = REGISTRY.counter(
    "osim_checkpoint_bytes",
    "Bytes atomically persisted in mid-plan carry snapshots.",
)
RESUME_CHUNKS_SKIPPED = REGISTRY.counter(
    "osim_resume_chunks_skipped_total",
    "Commit chunks a resumed plan restored from a snapshot instead of "
    "re-executing.",
)
DEVICE_LOST = REGISTRY.counter(
    "osim_device_lost_total",
    "Device-loss events seen by the chunked and wave scenario drivers; "
    "handled=yes means the carry was restored from the last good snapshot "
    "and the plan continued.",
    labelnames=("handled",),
)
JOURNAL_EVENTS = REGISTRY.counter(
    "osim_journal_events_total",
    "Records durably committed to run journals, by event type.",
    labelnames=("event",),
)
REQUESTS_SHED = REGISTRY.counter(
    "osim_requests_shed_total",
    "Requests shed by admission control with a definite response "
    "(429/503 + Retry-After), by reason.",
    labelnames=("reason",),
)
REQUESTS_DROPPED = REGISTRY.counter(
    "osim_requests_dropped_total",
    "Requests dropped without a simulated or shed response (scheduler "
    "worker death) — any nonzero value is a failure, not degradation.",
)
RESIDENT_DRIFT_REPAIRS = REGISTRY.counter(
    "osim_resident_drift_repairs_total",
    "Anti-entropy repairs (full re-encode) of the resident cluster state, by "
    "trigger: digest_mismatch, torn_delta, delta_budget, disabled "
    "(OSIM_RESIDENT=0 mid-run).",
    labelnames=("reason",),
)
RESIDENT_DELTAS = REGISTRY.counter(
    "osim_resident_deltas_total",
    "Rows applied to the resident cluster state without a full re-encode, "
    "by kind (pod_usage, node_row, node_added).",
    labelnames=("kind",),
)
RESIDENT_FALLBACKS = REGISTRY.counter(
    "osim_resident_fallbacks_total",
    "Syncs and simulations that declined the resident path and re-encoded "
    "for a structural reason (node_removed, node_order, bucket_overflow, "
    "shape_growth, not_covering, disabled).",
    labelnames=("reason",),
)
RESIDENT_VERIFICATIONS = REGISTRY.counter(
    "osim_resident_verifications_total",
    "Digest cross-checks of the resident state against a full re-encode, "
    "by outcome (ok | mismatch).",
    labelnames=("outcome",),
)
RESIDENT_EPOCH = REGISTRY.gauge(
    "osim_resident_epoch",
    "Current generation of the resident cluster state; bumps on every delta "
    "apply and every repair, globally monotonic.",
)

# the server, its admission queue and its scheduler loop
HTTP_REQUESTS = REGISTRY.counter(
    "osim_http_requests_total",
    "Simulator HTTP server responses, by path and status code.",
    labelnames=("path", "code"),
)
ADMISSION_QUEUE_DEPTH = REGISTRY.gauge(
    "osim_admission_queue_depth",
    "Requests currently waiting in the server admission queue.",
)
COALESCED_BATCH = REGISTRY.histogram(
    "osim_coalesced_batch_size",
    "Requests answered by one coalesced simulate pass: mode=fanout counts "
    "identical-body waiters fanned out from one result (per coalesce key), "
    "mode=scenarios counts distinct-scenario bodies merged into one batched "
    "device call.",
    labelnames=("mode",),
    buckets=(1, 2, 4, 8, 16, 32, 64),
)
REQUEST_LATENCY = REGISTRY.histogram(
    "osim_server_request_duration_seconds",
    "Admission-to-response latency of POST simulation requests, seconds.",
)
ADMISSION_FENCE = REGISTRY.counter(
    "osim_admission_fence_total",
    "Generation-fence decisions at admission dequeue: current = ticket ran "
    "against the epoch it was submitted under, rekeyed = the resident epoch "
    "moved between submit and dequeue so the ticket was re-keyed to prevent "
    "cross-generation coalescing.",
    labelnames=("outcome",),
)
LOOP_ITERATION = REGISTRY.histogram(
    "osim_loop_iteration_seconds",
    "Wall-clock duration of one continuous-batching scheduler-loop "
    "iteration (pack assembly + the device call + fan-out); the EWMA of "
    "this feeds Retry-After hints.",
)
PACK_LATENCY = REGISTRY.histogram(
    "osim_pack_latency_seconds",
    "Per-ticket time between admission and the moment its pack was taken "
    "by the scheduler loop — the queueing cost of continuous batching, "
    "excluding the device call itself.",
)
LOOP_FALLBACKS = REGISTRY.counter(
    "osim_loop_fallbacks_total",
    "Requests served per-request on the handler thread because the "
    "scheduler loop thread was not alive (degradation ladder, "
    "docs/serving.md) — correctness is preserved, batching is lost.",
)
JOBS = REGISTRY.counter(
    "osim_jobs_total",
    "Async jobs (POST /v1/jobs), by terminal outcome "
    "(completed | failed | rejected).",
    labelnames=("outcome",),
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
