"""Deterministic fault injection for the external-I/O surfaces.

The port's copy of the JAX package's resilience/faults.py, every target
included.

A `FaultPlan` (YAML file, or the OSIM_FAULT_PLAN env var holding a path or
inline YAML) names rules that inject latency, connection errors, HTTP 5xx,
malformed-JSON responses, or generic errors into the extender transport
(`engine/extenders.py`), the apiserver client (`utils/kubeclient.py`), and
chart rendering (`utils/chart.py`). The schedule is seeded — rule order,
per-rule call counters, and one `random.Random(seed)` for probabilistic
rules — so a plan replays byte-identically: the same calls fail in the same
order on every run, which is what makes degraded-mode behavior testable
(`simon chaos`, tests/test_resilience.py).

Plan schema:

    seed: 7
    rules:
      - target: extender          # extender | kubeclient | chart
                                  # | backend | journal | admission
                                  # | resident | device
        op: filter                # optional substring match on the call's
                                  # operation (extender verb, api path,
                                  # chart release/path, backend stage,
                                  # journal event, admission phase
                                  # "submit"/"drain", resident phase
                                  # "apply"/"verify"/"fence", device chunk
                                  # "commit-chunk:<i>"); empty = any
        kind: connection_error    # latency | connection_error | http_error
                                  # | malformed_json | error | kill
                                  # | queue_full | slow_drain
                                  # | deadline_storm  (admission only)
                                  # | torn_delta | stale_generation
                                  # | digest_mismatch  (resident only)
                                  # | device_lost | chunk_kill (device only)
        times: 2                  # inject on the first 2 matching calls
                                  # (omit = every matching call)
        after: 0                  # skip this many matching calls first
        probability: 1.0          # seeded coin per matching call
        latency_s: 0.05           # kind=latency: injected delay
        status: 503               # kind=http_error: response status
        body: ""                  # http_error/malformed_json response body

Call sites consult `maybe_inject(target, op)`; with no plan installed this
is a single None-check, so the production hot path pays nothing.
"""

from __future__ import annotations

import io
import os
import random
import threading
import urllib.error
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


from ..utils import metrics

TARGETS = (
    "extender", "kubeclient", "chart", "backend", "journal", "admission",
    "resident", "device",
)
KINDS = (
    "latency", "connection_error", "http_error", "malformed_json", "error",
    "kill", "queue_full", "slow_drain", "deadline_storm",
    "torn_delta", "stale_generation", "digest_mismatch",
    "device_lost", "chunk_kill",
)


class FaultInjectionError(Exception):
    """A fault plan could not be loaded or is invalid."""


class DeviceLostError(Exception):
    """The device holding the carry disappeared mid-plan. Raised by the
    `device_lost` fault kind; the chunked and wave drivers restore the last
    good carry and replay, or re-raise once out of strikes."""


@dataclass
class FaultRule:
    target: str
    kind: str
    op: str = ""
    times: Optional[int] = None
    after: int = 0
    probability: float = 1.0
    latency_s: float = 0.0
    status: int = 503
    body: str = ""
    # runtime counters (mutated under the injector lock)
    seen: int = 0
    injected: int = 0
    # keyed-mode counters (see FaultInjector.intercept): per-key occurrence
    # and injection counts, so `after`/`times`/`probability` gate per key
    # instead of per global call order
    seen_by_key: Dict[str, int] = field(default_factory=dict)
    injected_by_key: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.target not in TARGETS:
            raise FaultInjectionError(
                f"fault rule: unknown target {self.target!r} "
                f"(expected one of {', '.join(TARGETS)})"
            )
        if self.kind not in KINDS:
            raise FaultInjectionError(
                f"fault rule: unknown kind {self.kind!r} "
                f"(expected one of {', '.join(KINDS)})"
            )
        if not 0.0 <= self.probability <= 1.0:
            raise FaultInjectionError(
                f"fault rule: probability {self.probability} not in [0, 1]"
            )

    @staticmethod
    def from_dict(doc: Dict[str, Any]) -> "FaultRule":
        known = {
            "target", "kind", "op", "times", "after", "probability",
            "latency_s", "status", "body",
        }
        unknown = set(doc) - known
        if unknown:
            raise FaultInjectionError(
                f"fault rule: unknown key(s) {sorted(unknown)}"
            )
        return FaultRule(
            target=str(doc.get("target", "")),
            kind=str(doc.get("kind", "")),
            op=str(doc.get("op", "") or ""),
            times=(None if doc.get("times") is None else int(doc["times"])),
            after=int(doc.get("after", 0) or 0),
            probability=float(doc.get("probability", 1.0)),
            latency_s=float(doc.get("latency_s", 0.0) or 0.0),
            status=int(doc.get("status", 503) or 503),
            body=str(doc.get("body", "") or ""),
        )


@dataclass
class FaultPlan:
    seed: int = 0
    rules: List[FaultRule] = field(default_factory=list)

    @staticmethod
    def from_dict(doc: Dict[str, Any]) -> "FaultPlan":
        if not isinstance(doc, dict):
            raise FaultInjectionError("fault plan: top level must be a mapping")
        rules = doc.get("rules")
        if not isinstance(rules, list) or not rules:
            raise FaultInjectionError("fault plan: 'rules' must be a non-empty list")
        return FaultPlan(
            seed=int(doc.get("seed", 0) or 0),
            rules=[FaultRule.from_dict(r or {}) for r in rules],
        )

    @staticmethod
    def load(path: str) -> "FaultPlan":
        import yaml  # read only when a plan is loaded: the card may lack PyYAML

        try:
            with open(path) as fh:
                doc = yaml.safe_load(fh)
        except OSError as e:
            raise FaultInjectionError(f"cannot read fault plan {path}: {e}")
        except yaml.YAMLError as e:
            raise FaultInjectionError(f"invalid fault plan YAML {path}: {e}")
        return FaultPlan.from_dict(doc or {})

    @staticmethod
    def from_env() -> Optional["FaultPlan"]:
        """OSIM_FAULT_PLAN: a path to a plan file, or inline YAML."""
        raw = os.environ.get("OSIM_FAULT_PLAN", "").strip()
        if not raw:
            return None
        if os.path.exists(raw):
            return FaultPlan.load(raw)
        import yaml

        try:
            doc = yaml.safe_load(raw)
        except yaml.YAMLError as e:
            raise FaultInjectionError(f"OSIM_FAULT_PLAN: invalid YAML: {e}")
        if not isinstance(doc, dict):
            raise FaultInjectionError(
                f"OSIM_FAULT_PLAN: not a file and not inline plan YAML: {raw!r}"
            )
        return FaultPlan.from_dict(doc)


class FaultInjector:
    """Evaluates a FaultPlan against intercepted calls. Deterministic: rules
    fire in plan order, per-rule counters gate `after`/`times`, and the one
    seeded RNG drives `probability` coins in call order.

    Keyed mode: a call site that passes `key` (the extender transport passes
    the pod UID) is gated by per-(rule, key) counters and a hash-seeded coin
    instead of the shared call-order state — so a concurrent wave of calls
    injects the exact same faults into the exact same pods regardless of
    thread interleaving. A pod's own calls are temporally ordered (retries
    are sequential within one chain), so per-key occurrence numbering is
    deterministic even though cross-pod order is not.

    `snapshot_key`/`restore_key` give a caller that may re-issue a keyed
    call sequence (the wave engine, after a commit-conflict respill or a
    discarded speculative dispatch) replay semantics: snapshot the key's
    occurrence counters before the first dispatch, restore them before any
    re-issue, and the re-run draws the exact coin positions of its first
    run — outcomes stay byte-identical to the serial path, which runs the
    sequence exactly once from the same starting positions (aggregate
    `injected` counters do count the replay; the per-pod behavior is what
    determinism is about)."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self._lock = threading.Lock()

    def _match_ordered(self, rule: FaultRule) -> bool:
        """Legacy gating: global call-order counters + the shared RNG."""
        rule.seen += 1
        if rule.seen <= rule.after:
            return False
        if rule.times is not None and rule.injected >= rule.times:
            return False
        if rule.probability < 1.0 and self.rng.random() >= rule.probability:
            return False
        rule.injected += 1
        return True

    def _match_keyed(self, rule: FaultRule, idx: int, key: str) -> bool:
        """Keyed gating: `after`/`times` count this key's own calls, and the
        probability coin is a pure function of (seed, rule, key, occurrence)
        — byte-deterministic under any cross-key interleaving."""
        seen = rule.seen_by_key.get(key, 0) + 1
        rule.seen_by_key[key] = seen
        rule.seen += 1
        if seen <= rule.after:
            return False
        if rule.times is not None and (
            rule.injected_by_key.get(key, 0) >= rule.times
        ):
            return False
        if rule.probability < 1.0:
            coin = random.Random(
                f"{self.plan.seed}|{idx}|{key}|{seen}"
            ).random()
            if coin >= rule.probability:
                return False
        rule.injected_by_key[key] = rule.injected_by_key.get(key, 0) + 1
        rule.injected += 1
        return True

    def snapshot_key(self, key: str) -> List[Tuple[int, int]]:
        """Per-rule (seen, injected) counters for `key`, in plan order —
        taken before a keyed sequence's first dispatch (see class
        docstring)."""
        with self._lock:
            return [
                (
                    rule.seen_by_key.get(key, 0),
                    rule.injected_by_key.get(key, 0),
                )
                for rule in self.plan.rules
            ]

    def restore_key(self, key: str, snap: List[Tuple[int, int]]) -> None:
        """Rewind `key`'s counters to a snapshot so a re-issued sequence
        replays its first run's coin positions. The aggregate per-rule
        `seen`/`injected` counters are deliberately not rewound."""
        with self._lock:
            for rule, (seen, injected) in zip(self.plan.rules, snap):
                if seen:
                    rule.seen_by_key[key] = seen
                else:
                    rule.seen_by_key.pop(key, None)
                if injected:
                    rule.injected_by_key[key] = injected
                else:
                    rule.injected_by_key.pop(key, None)

    def intercept(
        self, target: str, op: str = "", key: str = ""
    ) -> Optional[FaultRule]:
        with self._lock:
            for idx, rule in enumerate(self.plan.rules):
                if rule.target != target:
                    continue
                if rule.op and rule.op not in op:
                    continue
                matched = (
                    self._match_keyed(rule, idx, key)
                    if key
                    else self._match_ordered(rule)
                )
                if not matched:
                    continue
                metrics.FAULTS_INJECTED.inc(target=target, kind=rule.kind)
                return rule
        return None

    def summary(self) -> List[Dict[str, Any]]:
        """Per-rule injection counts, in plan order (deterministic)."""
        with self._lock:
            return [
                {
                    "target": r.target,
                    "op": r.op,
                    "kind": r.kind,
                    "matched": r.seen,
                    "injected": r.injected,
                }
                for r in self.plan.rules
            ]


# ---------------------------------------------------------------------------
# Global installation point. None (the default) = production: maybe_inject
# is a single attribute read.
# ---------------------------------------------------------------------------

_active: Optional[FaultInjector] = None


def install_plan(plan: FaultPlan) -> FaultInjector:
    global _active
    _active = FaultInjector(plan)
    return _active


def uninstall_plan() -> None:
    global _active
    _active = None


def active_injector() -> Optional[FaultInjector]:
    return _active


def maybe_inject(
    target: str, op: str = "", key: str = ""
) -> Optional[FaultRule]:
    inj = _active
    if inj is None:
        return None
    return inj.intercept(target, op, key=key)


def has_rules(target: str) -> bool:
    """True when an installed plan names any rule for `target`. Call sites
    that must pay extra bookkeeping to make a fault recoverable (the chunked
    commit driver keeps a host copy of the carry only when a device fault
    can actually fire) use this to keep the production path free."""
    inj = _active
    return inj is not None and any(
        r.target == target for r in inj.plan.rules
    )


def snapshot_key(key: str) -> Optional[List[Tuple[int, int]]]:
    """Snapshot `key`'s fault counters (None with no active plan)."""
    inj = _active
    return None if inj is None else inj.snapshot_key(key)


def restore_key(key: str, snap: Optional[List[Tuple[int, int]]]) -> None:
    """Rewind `key`'s counters to `snap` before re-issuing its sequence
    (no-op with no active plan or a None snapshot)."""
    if snap is None:
        return
    inj = _active
    if inj is not None:
        inj.restore_key(key, snap)


class injected:
    """Context manager: install a plan for the duration of a block."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.injector: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        self.injector = install_plan(self.plan)
        return self.injector

    def __exit__(self, *exc) -> None:
        uninstall_plan()


# ---------------------------------------------------------------------------
# Fault application helpers (shared by the HTTP transports and the chart
# renderer so every call site maps kinds to behavior the same way).
# ---------------------------------------------------------------------------

def apply_http_fault(rule: FaultRule, url: str) -> Optional[bytes]:
    """Raise the rule's fault as the exception the real transport would see,
    or return a replacement response body (malformed_json). latency sleeps
    and returns None so the real call proceeds afterwards."""
    import time as _time

    if rule.kind == "latency":
        if rule.latency_s > 0:
            _time.sleep(rule.latency_s)
        return None
    if rule.kind == "connection_error":
        raise urllib.error.URLError("injected by fault plan: connection refused")
    if rule.kind == "http_error":
        body = (rule.body or "injected by fault plan").encode()
        raise urllib.error.HTTPError(
            url, rule.status, "injected by fault plan", None,  # type: ignore[arg-type]
            io.BytesIO(body),
        )
    if rule.kind == "malformed_json":
        return (rule.body or '{"truncated": ').encode()
    # generic "error" behaves like a connection error on HTTP targets
    raise urllib.error.URLError("injected by fault plan: error")


def apply_chart_fault(rule: FaultRule, what: str) -> None:
    """Chart rendering has no transport: latency sleeps, every error kind
    degrades to a ChartError (the apply layer records a per-app failure)."""
    import time as _time

    if rule.kind == "latency":
        if rule.latency_s > 0:
            _time.sleep(rule.latency_s)
        return
    from ..utils.chart import ChartError

    raise ChartError(f"injected by fault plan ({rule.kind}) rendering {what}")


def apply_backend_fault(rule: FaultRule) -> None:
    """Backend acquisition faults: latency models a wedged first contact
    (the watchdog must fire), kill ends the process, every other kind is an
    immediate failure."""
    import time as _time

    if rule.kind == "latency":
        if rule.latency_s > 0:
            _time.sleep(rule.latency_s)
        return
    if rule.kind == "kill":
        os.kill(os.getpid(), 9)
    raise RuntimeError(f"injected by fault plan ({rule.kind}): backend init failed")


def apply_device_fault(rule: FaultRule) -> None:
    """Device faults against the chunked and wave drivers (ops/fast.py).
    `chunk_kill` (and `kill`) SIGKILLs the process *before* the chunk's
    `plan_chunk` record is journaled: the deterministic mid-plan kill the
    crash-resume checks use. `device_lost` raises DeviceLostError as if the
    device dropped the carry, which the driver recovers from its last good
    host snapshot; other kinds raise it too."""
    import time as _time

    if rule.kind == "latency":
        if rule.latency_s > 0:
            _time.sleep(rule.latency_s)
        return
    if rule.kind in ("chunk_kill", "kill"):
        os.kill(os.getpid(), 9)
    raise DeviceLostError(f"injected by fault plan ({rule.kind}): device lost mid-plan")


def apply_journal_fault(rule: FaultRule) -> None:
    """Journal faults model a dying host: `kill` SIGKILLs the process
    *before* the record is written (the k-th trial is then not committed,
    like a preemption between probe and commit); other kinds raise an
    OSError the journal wraps in JournalError."""
    import time as _time

    if rule.kind == "latency":
        if rule.latency_s > 0:
            _time.sleep(rule.latency_s)
        return
    if rule.kind == "kill":
        os.kill(os.getpid(), 9)
    raise OSError(f"injected by fault plan ({rule.kind}): journal write failed")
