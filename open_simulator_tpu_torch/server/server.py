"""REST simulation service of the port: `simon server`.

The port's copy of the JAX package's server/server.py, with every device
call on the server's device (`serve(device=)`, `make_server(device=)`,
CUDA by default; nothing moves to the CPU when the card is missing or a
call fails). Routes, request and response bodies, status codes and
headers are the reference's:

  POST /api/deploy-apps   simulate deploying workloads onto a cluster snapshot
  POST /api/scale-apps    remove a workload's pods, re-simulate at new counts
  POST /v1/jobs           an async capacity plan on the run journal
  GET  /v1/jobs[/<id>?after=N], /healthz, /metrics, /test, /debug/timings,
       /debug/profile?ms=N, /debug/pprof/{profile,goroutine,heap,cmdline}

POSTs go through admission control (server/admission.py) and the
continuous-batching scheduler loop (server/loop.py): identical concurrent
bodies coalesce into one simulate pass, and bodies that differ only in
`weights` run as scenario lanes of one batched call, served by a warm
ScenarioSession per (cluster, apps) key. With --kubeconfig or --master the
cluster is a cached snapshot of the live apiserver, refreshed after
OSIM_SERVER_RESYNC_S seconds (the reference's 30 s informer resync) into a
device-resident ResidentCluster by row-delta sync. Request schema:

  {
    "cluster": {"objects": [...k8s objects...]} | {"path": "dir"},  # optional
                                     # with --kubeconfig
    "apps":    [{"name": "a", "objects": [...]}],
    "newNodes": [...Node objects...],            # optional
    "removeWorkloads": [{"kind": "Deployment", "name": "x", "namespace": "d"}],
    "weights": {...}                             # optional score weights
  }

The reference's degradations stay, on the same device: a failed warm
session is served cold, a failed scenario group is re-run body by body,
and a failed apiserver refresh serves the stale snapshot.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import signal
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ..core.objects import (
    ANNO_WORKLOAD_KIND,
    ANNO_WORKLOAD_NAME,
    ANNO_WORKLOAD_NAMESPACE,
    Node,
)
from ..engine.simulator import (
    AppResource,
    ClusterResource,
    Scenario,
    ScenarioSession,
    simulate,
    simulate_batch,
)
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils import metrics
from ..utils.concurrency import guarded_by
from ..utils.yamlio import objects_from_directory
from . import admission as admission_mod
from .admission import AdmissionQueue

_kubeconfig: Optional[str] = None  # set by serve()/make_server()
_master: str = ""                  # apiserver URL override (--master)
_device = DEFAULT_DEVICE           # every device call's device; set by serve()/make_server()
_live_servers: set = set()         # servers not yet closed; they all run on _device
_live_lock = threading.Lock()


def _claim_device(device) -> None:
    """Set the process's server device. The servers of one process share the
    snapshot, the resident state and the warm sessions, which live on one
    device, so a server on another device than a live one's is refused."""
    global _device
    dev = resolve_device(device)
    with _live_lock:
        cur = torch.device(_device)
        if _live_servers and (dev.type, dev.index or 0) != (cur.type, cur.index or 0):
            raise ValueError(
                f"a server on {cur} is live in this process; a server on {dev} "
                "would share its snapshot, resident state and warm sessions"
            )
        _device = dev

# Live-cluster snapshot cache (parity: the reference serves every request
# from a SharedInformerFactory with a 30 s resync period, synced once at
# startup — server.go:98-136 — rather than re-listing the apiserver per
# request). The snapshot is re-fetched only when older than _resync_s;
# requests in between reuse it, so per-request latency against a large real
# cluster is simulation-bound, not list-bound. Handler threads read the
# generation while the scheduler worker refreshes, so all access is under
# _snapshot_lock (the old design piggybacked on the POST _busy try-lock,
# which admission control removed).
RESYNC_SECONDS = 30.0
_resync_s = RESYNC_SECONDS
_snapshot_lock = threading.Lock()
_snapshot: Optional[ClusterResource] = None
_snapshot_at = 0.0
_snapshot_fetches = 0  # observability + test hook (NOT the coalesce generation
#                        — that is the resident epoch / (fetches, stale) pair
#                        below, see _snapshot_generation)
_snapshot_stale = False  # last refresh attempt failed; serving cached data
# Device-resident encoded planes for the live snapshot (engine/resident.py):
# created on the first successful fetch when OSIM_RESIDENT is on, delta-synced
# on every refresh, handed to simulate() so live-snapshot requests skip the
# full re-encode. None when no live source or the knob is off.
_resident = None  # Optional[engine.resident.ResidentCluster]

# Warm ScenarioSession cache (engine/simulator.ScenarioSession): one entry per
# (body-minus-weights digest, snapshot generation, stale) key, so consecutive
# packs over the same cluster/apps reuse one encoded Simulator instead of
# re-paying construction + encode per device call — the lane-slot-reuse half
# of continuous batching. Entries are checked out exclusively (busy flag);
# a concurrent second user of the same key falls back to the cold path rather
# than blocking the scheduler loop. Capacity-capped LRU; any session error
# drops the entry (cold path is always correct). OSIM_SERVER_LOOP=0 disables
# the cache entirely (the bench's baseline mode).
_SESSION_CAP = 8
_sessions_lock = threading.Lock()
_sessions: "OrderedDict[tuple, dict]" = OrderedDict()

# Async jobs registry (POST /v1/jobs): job id -> {thread, run_dir, error}.
# The durable state is the run directory's journal (durable/journal.py) —
# this dict only tracks in-process liveness, so a restarted server still
# serves GET /v1/jobs/<id> for journaled runs it never started.
_jobs_lock = threading.Lock()
_jobs: dict = {}

# Per-connection socket read timeout: a slow-loris client trickling a request
# body would otherwise pin a handler thread forever. Body reads that exceed
# it return 408. The OSIM_SERVER_REQUEST_TIMEOUT_S env knob is applied by
# _resolve_env_config() at serve()/make_server() time — NOT at import, so
# setting it after this module is imported still takes effect.
REQUEST_TIMEOUT_S = 30.0

# serve()'s active server, so the SIGTERM/SIGINT handler (and tests) can
# trigger a graceful drain from outside the serve_forever loop.
_current_server: Optional[ThreadingHTTPServer] = None


def _resolve_env_config() -> None:
    """Apply env knobs at serve()/make_server() time (the import-time read
    these replaced silently ignored variables set after import). Only
    overrides when the variable is actually present, so tests that poke the
    module attributes directly keep their values."""
    global REQUEST_TIMEOUT_S, _resync_s
    for env, attr in (
        ("OSIM_SERVER_REQUEST_TIMEOUT_S", "REQUEST_TIMEOUT_S"),
        ("OSIM_SERVER_RESYNC_S", "_resync_s"),
    ):
        raw = os.environ.get(env, "").strip()
        if not raw:
            continue
        try:
            globals()[attr] = float(raw)
        except ValueError:
            from ..utils.tracing import log

            log.warning("%s=%r is not a number; keeping %g", env, raw,
                        globals()[attr])


def _scenario_compat_key(body: dict) -> str:
    """Digest of a request body MINUS its per-scenario `weights` field: two
    bodies with equal compat keys describe the same cluster/apps and differ
    only in score weights, so one batched (vmapped) device call can serve
    both as scenario lanes."""
    import hashlib

    stripped = {k: v for k, v in body.items() if k != "weights"}
    return hashlib.sha256(
        json.dumps(stripped, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def _loop_sessions_enabled() -> bool:
    """OSIM_SERVER_LOOP gates the warm-session cache (default on). Resolved
    at call time, not import time, so the bench can flip it per mode."""
    raw = os.environ.get("OSIM_SERVER_LOOP", "").strip().lower()
    return raw not in ("0", "false", "off", "no")


def _session_key_for(body: dict) -> Optional[tuple]:
    """Cache key for a warm ScenarioSession serving this body, or None when
    the body cannot be session-backed: a `path` cluster reads a directory
    whose contents may change between packs (no identity to key on). Live
    bodies fold in the snapshot (generation, stale) pair — a refresh moves
    the key, so a session never outlives the snapshot it encoded — and the
    key computation touches _live_snapshot() first so the resync clock still
    ticks even when every request is served warm."""
    spec = body.get("cluster") or {}
    if "path" in spec:
        return None
    digest = _scenario_compat_key(body)
    if spec.get("objects") or not (_kubeconfig or _master):
        # body fully describes the cluster: deterministic under any epoch
        return digest, None, None
    try:
        _live_snapshot()
    except Exception:
        return None  # cold path owns the error attribution
    gen, stale = _snapshot_generation()
    return digest, gen, stale


def _checkout_session(key: tuple):
    """(session, may_create): the cached session marked busy, or (None, True)
    when absent (caller may create one), or (None, False) when another
    thread holds it (caller falls back cold rather than waiting)."""
    with _sessions_lock:
        ent = _sessions.get(key)
        if ent is None:
            return None, True
        if ent["busy"]:
            return None, False
        ent["busy"] = True
        _sessions.move_to_end(key)
        return ent["session"], False


def _checkin_session(key: tuple, session, *, keep: bool) -> None:
    """Return a checked-out (or freshly created) session to the cache.
    keep=False drops it — any run error or batched-path refusal invalidates
    the warm state. A concurrent creator that lost the key race discards its
    session silently; the winner's entry stays."""
    with _sessions_lock:
        ent = _sessions.get(key)
        if ent is not None and ent.get("session") is not session:
            return
        if not keep:
            if ent is not None:
                del _sessions[key]
            return
        if ent is None:
            _sessions[key] = {"session": session, "busy": False}
        else:
            ent["busy"] = False
        _sessions.move_to_end(key)
        while len(_sessions) > _SESSION_CAP:
            victim = next(
                (k for k, e in _sessions.items() if not e["busy"]), None
            )
            if victim is None:
                break
            del _sessions[victim]


def _run_scenarios_warm(
    body: dict, cluster, apps, scenarios, resident
) -> Optional[list]:
    """Serve a scenario group through the warm-session cache; returns
    formatted per-body results, or None to fall back to the cold path
    (disabled, unkeyable body, session busy, run refused, or any error)."""
    if not _loop_sessions_enabled():
        return None
    key = _session_key_for(body)
    if key is None:
        return None
    sess, may_create = _checkout_session(key)
    if sess is None:
        if not may_create:
            return None
        try:
            sess = ScenarioSession(cluster, apps, resident=resident, device=_device)
        except Exception:
            from ..utils.tracing import log

            log.warning(
                "warm session creation failed; serving cold", exc_info=True
            )
            return None
    try:
        results = sess.run(scenarios)
    except Exception:
        from ..utils.tracing import log

        log.warning(
            "warm session run failed; dropping session and serving cold",
            exc_info=True,
        )
        _checkin_session(key, sess, keep=False)
        return None
    if results is None:  # batch-ineligible workload: cold path handles it
        _checkin_session(key, sess, keep=False)
        return None
    _checkin_session(key, sess, keep=True)
    return [_format_result(r) for r in results]


def _execute_bodies(bodies: list) -> list:
    """Admission-queue batch executor. Bodies that differ only in their
    `weights` field (same cluster/apps — see _scenario_compat_key) are
    merged into ONE batched device call through the vmapped multi-scenario
    engine (simulate_batch), observed as
    osim_coalesced_batch_size{mode="scenarios"}; everything else runs one
    simulate pass per body. Per-body failures are returned as the Exception
    (the queue fans it out as a 400 to that key's waiters only) — a batched
    group that fails re-runs serially so errors stay attributed per body.
    Resolves _simulate_request/_simulate_scenario_group through module
    globals at call time so tests can monkeypatch them."""
    groups: dict = {}
    order: list = []
    for i, body in enumerate(bodies):
        key = _scenario_compat_key(body)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    results: list = [None] * len(bodies)
    for key in order:
        idxs = groups[key]
        if len(idxs) >= 2:
            try:
                outs = _simulate_scenario_group([bodies[i] for i in idxs])
                for i, out in zip(idxs, outs):
                    results[i] = out
                continue
            except Exception:
                from ..utils.tracing import log

                log.warning(
                    "batched scenario group of %d failed; re-running "
                    "serially for per-body error attribution", len(idxs),
                    exc_info=True,
                )
        for i in idxs:
            try:
                results[i] = _simulate_request(bodies[i])
            except Exception as e:
                results[i] = e
    return results


class _DrainingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose server_close() actually drains.

    socketserver only tracks non-daemon handler threads for the
    block_on_close join, and ThreadingHTTPServer marks handlers daemonic —
    so a plain server_close() would drop in-flight requests on the floor.
    Non-daemon handlers make the close a real drain: every request already
    being computed completes and its response is sent before the process
    exits. The per-socket REQUEST_TIMEOUT_S bounds how long a wedged or idle
    keep-alive client can stall that drain.

    Owns the AdmissionQueue: close first sheds everything still queued
    (reason=draining, 503 + Retry-After), then joins handler threads — the
    in-flight batch finishes and its waiters get real responses."""

    daemon_threads = False
    # socketserver's default TCP accept backlog is 5: a concurrent burst
    # larger than that gets kernel-level connection resets BEFORE admission
    # control can answer with an honest 429. The queue's shed path is the
    # only overload response allowed to reject a client, so the backlog
    # must comfortably exceed any burst the admission queue is sized for.
    request_queue_size = 128

    def __init__(
        self,
        addr,
        handler,
        *,
        queue_depth: Optional[int] = None,
        coalesce_ms: Optional[float] = None,
        pack_window_ms: Optional[float] = None,
        default_deadline_ms: Optional[float] = None,
    ) -> None:
        super().__init__(addr, handler)
        self.admission = AdmissionQueue(
            _execute_bodies,
            depth=queue_depth,
            coalesce_ms=coalesce_ms,
            pack_window_ms=pack_window_ms,
            default_deadline_ms=default_deadline_ms,
            # generation fence: tickets stamped with a live-snapshot epoch at
            # submit are re-keyed at dequeue if the epoch moved (resident
            # delta / snapshot refresh) — a coalesced batch can never mix
            # requests that saw different cluster states
            fence=_fence_epoch,
        ).start()
        self._serving_calls: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        with _live_lock:
            _live_servers.add(self)

    def service_actions(self) -> None:
        """Run the calls handed to the thread inside serve_forever (see
        call_on_serving_thread); it comes here between polls."""
        while True:
            try:
                fn, done = self._serving_calls.get_nowait()
            except queue_mod.Empty:
                return
            try:
                fn()
            except Exception:
                from ..utils.tracing import log

                log.warning("call on the serving thread failed", exc_info=True)
            finally:
                done.set()

    def call_on_serving_thread(self, fn, timeout: float) -> bool:
        """Run `fn` on the thread inside serve_forever and wait for it; False
        when it did not run within `timeout` seconds."""
        done = threading.Event()
        self._serving_calls.put((fn, done))
        return done.wait(timeout)

    def server_close(self) -> None:
        self.admission.shutdown()   # queued work -> 503 draining + Retry-After
        super().server_close()      # joins in-flight handler threads
        self.admission.join(timeout=5.0)
        with _live_lock:
            _live_servers.discard(self)


def _snapshot_generation() -> tuple:
    """Identity of the cached live snapshot as (generation, stale), folded
    into coalesce keys so identical bodies against different snapshots are
    never merged. The generation is the resident epoch when a resident
    exists — globally monotonic, never reused across re-serves — with
    _snapshot_fetches as the fallback when OSIM_RESIDENT=0. `stale` marks a
    snapshot being served past a failed refresh (_refresh_snapshot_locked's
    degradation path): the refresh failure does NOT advance the generation,
    so without the flag a body admitted just before the apiserver flapped
    would coalesce with one admitted just after — same data, but the stale
    response carries degraded-mode semantics the fresh one must not inherit."""
    with _snapshot_lock:
        gen = _resident.fence_epoch() if _resident is not None else _snapshot_fetches
        return gen, _snapshot_stale


def _fence_epoch() -> int:
    """Dequeue-side fence value for the admission queue (see
    AdmissionQueue fence=): the current generation only, staleness has its
    own key dimension."""
    return _snapshot_generation()[0]


def _coalesce_key_for(path: str, body: dict) -> tuple:
    """(coalesce key, fence epoch) for one request. Only live-snapshot bodies
    are generation-keyed and fenced (fence_epoch=None for the rest: a body
    that carries its own cluster produces the same bytes under any epoch, so
    re-keying it at dequeue would only split a valid coalesce)."""
    spec = body.get("cluster") or {}
    uses_live = (
        "path" not in spec
        and not spec.get("objects")
        and bool(_kubeconfig or _master)
    )
    if not uses_live:
        return admission_mod.coalesce_key(path, body), None
    gen, stale = _snapshot_generation()
    return admission_mod.coalesce_key(path, body, generation=gen, stale=stale), gen


def _live_snapshot() -> ClusterResource:
    """Cached kubeconfig/master-backed cluster snapshot. Returns a fresh
    ClusterResource wrapper over shared immutable objects: request handling
    appends newNodes / filters pods on the wrapper's lists, and simulate()
    deep-copies every pod it mutates, so sharing Node/Pod objects across
    requests is safe."""
    with _snapshot_lock:
        return _refresh_snapshot_locked()


@guarded_by("_snapshot_lock")
def _refresh_snapshot_locked() -> ClusterResource:
    import time

    global _snapshot, _snapshot_at, _snapshot_fetches, _snapshot_stale
    global _resident
    now = time.monotonic()
    if _snapshot is None or now - _snapshot_at > _resync_s:
        from ..engine.resident import ResidentCluster, resident_enabled
        from ..utils.kubeclient import (
            KubeClientError,
            create_cluster_resource_from_kubeconfig,
        )

        try:
            _snapshot = create_cluster_resource_from_kubeconfig(
                _kubeconfig or "", master=_master
            )
            _snapshot_at = now
            _snapshot_fetches += 1
            _snapshot_stale = False
            # Keep the device-resident planes in lockstep with the cache:
            # most refreshes land as row deltas, structural changes or drift
            # degrade to a full re-encode inside sync() (engine/resident.py).
            # sync() with the knob off keeps the state machine honest about a
            # mid-run OSIM_RESIDENT=0 flip (counted as a "disabled" repair).
            if _resident is None and resident_enabled():
                _resident = ResidentCluster(device=_device)
            if _resident is not None:
                _resident.sync(_snapshot.nodes, _snapshot.pods)
        except KubeClientError as e:
            if _snapshot is None:
                raise  # nothing cached to degrade to
            # Graceful degradation: a failed refresh serves the stale cached
            # snapshot instead of failing the request (the reference's
            # informer cache behaves the same way when the apiserver flaps).
            # _snapshot_at is left unchanged so the next request retries the
            # refresh immediately; _snapshot_stale stamps the staleness into
            # coalesce keys (_snapshot_generation) so degraded responses
            # never merge with fresh ones.
            from ..utils.tracing import log

            _snapshot_stale = True
            metrics.SNAPSHOT_STALE.inc()
            log.warning(
                "cluster snapshot refresh failed (%s); serving stale "
                "snapshot (age %.0fs)", e, now - _snapshot_at,
            )
    c = _snapshot
    return ClusterResource(
        nodes=list(c.nodes),
        pods=list(c.pods),
        daemonsets=list(c.daemonsets),
        others={k: list(v) for k, v in c.others.items()},
    )


def _request_cluster_apps(body: dict):
    """Decode one request body into (cluster, apps) — shared by the serial
    per-body path and the batched scenario-group path."""
    cluster_spec = body.get("cluster") or {}
    if "path" in cluster_spec:
        objs = objects_from_directory(cluster_spec["path"])
        cluster = ClusterResource.from_objects(objs)
    elif cluster_spec.get("objects"):
        cluster = ClusterResource.from_objects(list(cluster_spec["objects"]))
    elif _kubeconfig or _master:
        cluster = _live_snapshot()
    else:
        cluster = ClusterResource.from_objects([])
    for nd in body.get("newNodes") or []:
        cluster.nodes.append(Node.from_dict(nd))

    # scale-apps: drop pods owned by the named workloads before re-simulating
    # (parity: removePodsOfApp, server.go:404-444)
    removals = {
        (w.get("kind", ""), w.get("namespace", "default"), w.get("name", ""))
        for w in body.get("removeWorkloads") or []
    }
    if removals:
        # Deployment indirection (server.go:408-419): real-cluster pods of a
        # Deployment are owned by its ReplicaSets, which the snapshot lists —
        # an RS whose ownerReferences name a removed Deployment marks its own
        # pods removable. (Simulated pods match directly via annotations.)
        rs_of_removed = set()
        for rs in cluster.others.get("ReplicaSet", []):
            meta = rs.get("metadata") or {}
            ns = meta.get("namespace", "default")
            for ref in meta.get("ownerReferences") or []:
                if (ref.get("kind", ""), ns, ref.get("name", "")) in removals:
                    rs_of_removed.add((ns, meta.get("name", "")))

        def owned(pod) -> bool:
            ann = pod.meta.annotations
            key = (
                ann.get(ANNO_WORKLOAD_KIND, pod.meta.owner_kind),
                ann.get(ANNO_WORKLOAD_NAMESPACE, pod.meta.namespace),
                ann.get(ANNO_WORKLOAD_NAME, pod.meta.owner_name),
            )
            if key in removals:
                return True
            # OwnedByWorkload scans EVERY ownerReference (utils.go:840-853)
            # — a multi-owner pod's RS/STS ref need not be listed first
            refs = ((pod.raw or {}).get("metadata") or {}).get(
                "ownerReferences"
            ) or []
            for ref in refs:
                kind = ref.get("kind", "")
                name = ref.get("name", "")
                if (kind, pod.meta.namespace, name) in removals:
                    return True
                if (
                    kind == "ReplicaSet"
                    and (pod.meta.namespace, name) in rs_of_removed
                ):
                    return True
            return False

        cluster.pods = [p for p in cluster.pods if not owned(p)]

    apps = [
        AppResource(name=a.get("name", f"app-{i}"), objects=list(a.get("objects") or []))
        for i, a in enumerate(body.get("apps") or [])
    ]
    return cluster, apps


def _format_result(result) -> dict:
    placements = {}
    for st in result.node_status:
        for pod in st.pods:
            placements[pod.key] = st.node.name
    return {
        "placements": placements,
        "unscheduled": [
            {"pod": u.pod.key, "reason": u.reason} for u in result.unscheduled
        ],
    }


def _request_resident(body: dict):
    """The ResidentCluster to offer simulate(), or None. Only live-snapshot
    bodies can be covered, and a body that edits the cluster (newNodes /
    removeWorkloads) is simulated against a derived cluster the resident does
    not hold — skipping it here avoids a guaranteed not_covering fallback.
    simulate() still re-checks coverage (covers_reason), so offering the
    resident is always safe, never load-bearing."""
    spec = body.get("cluster") or {}
    uses_live = (
        "path" not in spec
        and not spec.get("objects")
        and bool(_kubeconfig or _master)
    )
    if not uses_live or body.get("newNodes") or body.get("removeWorkloads"):
        return None
    with _snapshot_lock:
        return _resident


def _simulate_request(body: dict) -> dict:
    # Warm-only fast path: an EXISTING session for this body's key serves a
    # lone request as a pack of one — byte-identical to simulate() (the
    # session rewinds the workload-name RNG per run) without re-paying the
    # encode. A lone request never CREATES a session: construction is only
    # amortized when scenario groups recur.
    if _loop_sessions_enabled():
        key = _session_key_for(body)
        if key is not None:
            sess, _may_create = _checkout_session(key)
            if sess is not None:
                try:
                    results = sess.run(
                        [Scenario(name="req-0", weights=body.get("weights"))]
                    )
                except Exception:
                    from ..utils.tracing import log

                    log.warning(
                        "warm session run failed; dropping session and "
                        "serving cold", exc_info=True,
                    )
                    _checkin_session(key, sess, keep=False)
                    results = None
                else:
                    _checkin_session(key, sess, keep=results is not None)
                if results:
                    return _format_result(results[0])
    cluster, apps = _request_cluster_apps(body)
    result = simulate(
        cluster, apps, weights=body.get("weights"),
        resident=_request_resident(body), device=_device,
    )
    return _format_result(result)


def _simulate_scenario_group(bodies: list) -> list:
    """One batched device call for a group of scenario-compatible bodies
    (identical cluster/apps, per-body weights): one vmapped lane per body,
    results in body order. Served through the warm-session cache when
    possible (the encode pass and Simulator construction amortize across
    consecutive packs); otherwise a cold simulate_batch, which falls back
    to serial internally when the workload is batch-ineligible — either
    way this always returns real per-body results."""
    cluster, apps = _request_cluster_apps(bodies[0])
    scenarios = [
        Scenario(name=f"req-{i}", weights=b.get("weights"))
        for i, b in enumerate(bodies)
    ]
    resident = _request_resident(bodies[0])
    out = _run_scenarios_warm(bodies[0], cluster, apps, scenarios, resident)
    if out is None:
        results = simulate_batch(
            cluster, apps, scenarios, resident=resident, device=_device
        )
        out = [_format_result(r) for r in results]
    metrics.COALESCED_BATCH.observe(len(bodies), mode="scenarios")
    return out


# ---------------------------------------------------------------------------
# Async jobs (POST /v1/jobs): long capacity plans run on a job thread, with
# the durable run journal (durable/journal.py) as the source of truth — the
# record sequence is exactly what `simon sweep --capacity --run-dir` writes,
# so `simon runs list/show/resume` work on job directories unchanged, and a
# job interrupted by a server restart resumes with {"resume": true}.
# ---------------------------------------------------------------------------


def _submit_job(body: dict):
    """Validate and launch one async job; returns (code, payload). 202 on
    launch, 409 while the same job id is still running (re-POST after
    completion is allowed: with resume=true it replays the journal and
    re-serves the committed result without new device calls)."""
    from ..durable import default_runs_root

    if body.get("kind", "capacity") != "capacity":
        metrics.JOBS.inc(outcome="rejected")
        return 400, {
            "error": (
                f"unsupported job kind {body.get('kind')!r}; "
                "only 'capacity' is implemented"
            )
        }
    if not isinstance(body.get("newNode"), dict):
        metrics.JOBS.inc(outcome="rejected")
        return 400, {"error": "capacity job needs a newNode candidate object"}
    job_id = str(body.get("job") or "") or f"job-{_scenario_compat_key(body)[:12]}"
    if "/" in job_id or job_id in (".", ".."):
        metrics.JOBS.inc(outcome="rejected")
        return 400, {"error": f"invalid job id {job_id!r}"}
    run_dir = os.path.join(default_runs_root(), job_id)
    with _jobs_lock:
        ent = _jobs.get(job_id)
        if ent is not None and ent["thread"].is_alive():
            metrics.JOBS.inc(outcome="rejected")
            return 409, {
                "error": "job is already running",
                "job": job_id,
                "status_url": f"/v1/jobs/{job_id}",
            }
        from ..utils import tracing

        t = threading.Thread(
            # the job thread outlives the POST that spawned it; the captured
            # trace context keeps its journal/sweep spans in the same trace
            target=_run_job,
            args=(job_id, run_dir, body, tracing.current_context()),
            name=f"osim-job-{job_id}", daemon=True,
        )
        _jobs[job_id] = {"thread": t, "run_dir": run_dir, "error": None}
        t.start()
    return 202, {
        "job": job_id,
        "run_dir": run_dir,
        "status_url": f"/v1/jobs/{job_id}",
    }


def _run_job(job_id: str, run_dir: str, body: dict, trace_ctx=None) -> None:
    """Job worker thread: a journaled capacity sweep. Every phase of the
    batched ladder lands as a `sweep` record (plan_capacity journals them),
    which is what GET /v1/jobs/<id> streams back as progress. The trace
    context captured at submit time keeps the job's spans in the same
    trace as the POST /v1/jobs request that launched it."""
    from ..utils import tracing
    from ..utils.tracing import log

    outcome = "failed"
    try:
        with tracing.activate(trace_ctx), tracing.span("job", job=job_id):
            _run_job_inner(job_id, run_dir, body)
        outcome = "completed"
    except Exception as e:
        log.warning("job %s failed", job_id, exc_info=True)
        with _jobs_lock:
            ent = _jobs.get(job_id)
            if ent is not None:
                ent["error"] = str(e)
    metrics.JOBS.inc(outcome=outcome)


def _run_job_inner(job_id: str, run_dir: str, body: dict) -> None:
    import json as _json

    from ..durable import RunJournal, atomic_write
    from ..engine.apply import placement_digest
    from ..engine.capacity import plan_capacity

    cluster, apps = _request_cluster_apps(body)
    new_node = Node.from_dict(body["newNode"])
    resume = bool(body.get("resume"))
    use_greed = bool(body.get("useGreed"))
    with RunJournal.open(run_dir) as journal:
        if resume:
            journal.append("run_resume")
        else:
            journal.append(
                "run_start", kind="sweep", job=job_id, use_greed=use_greed,
            )
        plan = plan_capacity(
            cluster, apps, new_node, use_greed=use_greed,
            journal=journal, resume=resume,
            sweep_mode="batched", device=_device,
        )
        journal.append(
            "run_end",
            outcome="ok" if plan is not None else "does_not_fit",
            nodes_added=plan.nodes_added if plan else -1,
        )
        # timestamp-free snapshot, byte-identical across crash-resume
        # (mirrors `simon sweep --capacity --run-dir`, cli/main.py)
        atomic_write(
            os.path.join(run_dir, "outcome.json"),
            _json.dumps(
                {
                    "outcome": "ok" if plan else "does_not_fit",
                    "kind": "sweep",
                    "nodes_added": plan.nodes_added if plan else -1,
                    "attempts": plan.attempts if plan else 0,
                    "batched_calls": plan.batched_calls if plan else 0,
                    "retries": plan.retries if plan else 0,
                    "unscheduled": (
                        len(plan.result.unscheduled) if plan else -1
                    ),
                    "placement_digest": (
                        placement_digest(plan.result) if plan else ""
                    ),
                },
                indent=2,
                sort_keys=True,
            )
            + "\n",
        )


def _job_status(job_id: str, after: int):
    """GET /v1/jobs/<id>?after=N: job state plus the `sweep` progress
    records with seq > N (pass the returned next_after back to poll
    incrementally). Works for journaled runs this process never started —
    the registry only adds in-process liveness on top of the journal."""
    from ..durable import default_runs_root, replay, summarize_run
    from ..durable.journal import JOURNAL_NAME

    run_dir = os.path.join(default_runs_root(), job_id)
    with _jobs_lock:
        ent = _jobs.get(job_id)
        running = ent is not None and ent["thread"].is_alive()
        error = ent["error"] if ent is not None else None
    if not os.path.isfile(os.path.join(run_dir, JOURNAL_NAME)):
        if running:
            # submitted moments ago; the journal's first fsync hasn't landed
            return 200, {
                "job": job_id, "run_dir": run_dir, "status": "starting",
                "progress": [], "next_after": after,
            }
        return 404, {"error": f"unknown job {job_id!r}"}
    events = replay(run_dir)
    summary = summarize_run(run_dir)
    if running:
        status = "running"
    elif error is not None:
        status = "failed"
    elif summary["status"] == "completed":
        status = "completed"
    else:
        # journal exists, no run_end, no live thread: interrupted —
        # resumable with POST /v1/jobs {"job": ..., "resume": true}
        status = "interrupted"
    progress = [
        {
            "seq": e.get("seq"),
            "ts": e.get("ts"),
            "phase": e.get("phase"),
            "counts": e.get("counts"),
            "good": e.get("good"),
            "n_pad": e.get("n_pad"),
        }
        for e in events
        if e.get("event") == "sweep" and e.get("seq", -1) > after
    ]
    payload = {
        "job": job_id,
        "run_dir": run_dir,
        "status": status,
        "summary": summary,
        "progress": progress,
        "next_after": events[-1]["seq"] if events else after,
    }
    if error is not None:
        payload["error"] = error
    if status == "completed":
        try:
            with open(os.path.join(run_dir, "outcome.json")) as fh:
                payload["outcome"] = json.load(fh)
        except (OSError, ValueError):
            pass
    return 200, payload


def _jobs_index():
    """GET /v1/jobs: in-process jobs plus every journaled run under the
    runs root (jobs land there, so a restarted server still lists them)."""
    from ..durable import default_runs_root, list_runs

    with _jobs_lock:
        live = {
            job_id: ent["thread"].is_alive() for job_id, ent in _jobs.items()
        }
    return 200, {
        "runs_root": default_runs_root(),
        "jobs": [
            dict(r, running=live.get(r["name"], False))
            for r in list_runs(default_runs_root())
        ],
    }


def _cpu_profile(seconds: float) -> dict:
    """Sampling wall-clock profiler over every live thread (the pprof
    `/debug/pprof/profile?seconds=N` analog): poll sys._current_frames() at
    ~100 Hz, aggregate identical stacks, report the hottest ones. The
    sampling thread excludes itself and the serving thread's own frames are
    visible — exactly like Go's profile including the HTTP handler."""
    import sys
    import time
    import traceback
    from collections import Counter

    me = threading.get_ident()
    samples: Counter = Counter()
    n = 0
    deadline = time.time() + max(0.1, seconds)
    while time.time() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = tuple(
                f"{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno}:{fs.name}"
                for fs in traceback.extract_stack(frame)[-12:]
            )
            samples[stack] += 1
        n += 1
        time.sleep(0.01)
    top = [
        {"count": c, "stack": list(stack)}
        for stack, c in samples.most_common(25)
    ]
    return {"seconds": seconds, "polls": n, "stacks": top}


def _goroutine_dump() -> dict:
    """Instantaneous all-thread stack dump (the `/debug/pprof/goroutine`
    analog — the exact tool the reference's leak postmortem used,
    docs/design/内存泄漏.md). One pass over sys._current_frames(), no
    sampling window: safe to hit on a wedged process."""
    import sys
    import traceback

    names = {t.ident: t for t in threading.enumerate()}
    threads = []
    for tid, frame in sys._current_frames().items():
        t = names.get(tid)
        threads.append(
            {
                "id": tid,
                "name": t.name if t else "?",
                "daemon": bool(t.daemon) if t else None,
                "stack": [
                    f"{fs.filename}:{fs.lineno}:{fs.name}"
                    for fs in traceback.extract_stack(frame)
                ],
            }
        )
    threads.sort(key=lambda d: d["id"])
    return {"count": len(threads), "threads": threads}


_tracemalloc_on = False
# /debug/pprof/heap is served off concurrent _Handler threads, so
# two concurrent requests can both observe _tracemalloc_on False, both call
# tracemalloc.start() and both mislabel their snapshot "tracing just
# started" — serialize the check-then-act.
_tracemalloc_lock = threading.Lock()


def _heap_profile() -> dict:
    """Allocation snapshot (the `/debug/pprof/heap` analog): tracemalloc top
    allocation sites. Tracing starts on the first call — the first snapshot
    only covers allocations made after it (noted in the payload), matching
    how pprof heap profiles need the runtime flag enabled."""
    import tracemalloc

    global _tracemalloc_on
    with _tracemalloc_lock:
        first = not _tracemalloc_on
        if first:
            tracemalloc.start(10)
            _tracemalloc_on = True
    current, peak = tracemalloc.get_traced_memory()
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:25]
    return {
        "note": (
            "tracing just started; snapshot covers allocations from now on"
            if first
            else ""
        ),
        "traced_current_bytes": current,
        "traced_peak_bytes": peak,
        "top": [
            {
                "site": str(s.traceback[0]) if s.traceback else "?",
                "size_bytes": s.size,
                "count": s.count,
            }
            for s in stats
        ],
    }


class _Handler(BaseHTTPRequestHandler):
    def setup(self):
        # BaseRequestHandler applies self.timeout to the connection socket;
        # read dynamically so tests / serve() can tune it per server
        self.timeout = REQUEST_TIMEOUT_S
        super().setup()

    def _count(self, code: int) -> None:
        from urllib.parse import urlparse

        metrics.HTTP_REQUESTS.inc(
            path=urlparse(self.path).path, code=str(code)
        )

    def _send(
        self, code: int, payload: dict, headers: Optional[dict] = None
    ) -> None:
        data = json.dumps(payload).encode()
        self._count(code)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        headers = dict(headers or {})
        # Every traced response echoes its trace id, so a client (or a
        # human with curl) can find the request's spans in the trace
        # export / flight recorder without guessing.
        if "X-Osim-Trace-Id" not in headers:
            from ..utils import tracing

            tid = tracing.current_trace_id()
            if tid is not None:
                headers["X-Osim-Trace-Id"] = tid
        for name, value in headers.items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, data: bytes, content_type: str) -> None:
        self._count(200)
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path == "/metrics":
            # Prometheus text exposition (the kube-scheduler serves its
            # metrics package at the same path) — see utils/metrics.py
            self._send_text(
                metrics.REGISTRY.render().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif self.path == "/debug/timings":
            # span trees (server.go:152's pprof registration analog), see
            # utils/tracing.py
            from ..utils.tracing import recent_timings

            self._send(200, {"timings": recent_timings()})
        elif self.path.startswith("/debug/profile"):
            # Device-time profiling (utils/profiling.py): capture a
            # torch.profiler trace for ?ms=N (default 1000, capped) into the
            # runs root as Chrome-trace JSON. Distinct from
            # /debug/pprof/profile, which samples HOST thread stacks.
            from urllib.parse import parse_qs, urlparse

            from ..durable import default_runs_root
            from ..utils.profiling import capture_device_trace

            q = parse_qs(urlparse(self.path).query)
            try:
                ms = min(float(q.get("ms", ["1000"])[0]), 60_000.0)
            except ValueError:
                ms = 1000.0
            out_dir = os.path.join(default_runs_root(), "device-profile")
            _prime_profiler(self.server)
            report = capture_device_trace(out_dir, duration_ms=ms, device=_device)
            self._send(200 if report.get("ok") else 500, report)
        elif self.path.startswith("/debug/pprof/profile"):
            # CPU profile: sample every thread's stack at ~100 Hz for
            # ?seconds=N (default 2; capped), return aggregated stacks —
            # the wall-clock sampling profile gin-contrib/pprof exposes at
            # the same path, in text form
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            try:
                seconds = min(float(q.get("seconds", ["2"])[0]), 30.0)
            except ValueError:
                seconds = 2.0
            self._send(200, _cpu_profile(seconds))
        elif self.path in ("/debug/pprof", "/debug/pprof/"):
            # the gin-contrib/pprof index (server.go:152): what's available
            self._send(
                200,
                {
                    "profiles": {
                        "goroutine": "/debug/pprof/goroutine",
                        "heap": "/debug/pprof/heap",
                        "profile": "/debug/pprof/profile?seconds=N",
                        "cmdline": "/debug/pprof/cmdline",
                        "timings": "/debug/timings",
                        "device": "/debug/profile?ms=N",
                        "metrics": "/metrics",
                    }
                },
            )
        elif self.path.startswith("/debug/pprof/cmdline"):
            import sys

            self._send(200, {"cmdline": sys.argv})
        elif self.path.startswith("/debug/pprof/goroutine"):
            self._send(200, _goroutine_dump())
        elif self.path.startswith("/debug/pprof/heap"):
            self._send(200, _heap_profile())
        elif self.path.startswith("/v1/jobs"):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            parts = [p for p in u.path.split("/") if p]
            if parts == ["v1", "jobs"]:
                code, payload = _jobs_index()
            elif len(parts) == 3:
                try:
                    after = int(parse_qs(u.query).get("after", ["-1"])[0])
                except ValueError:
                    after = -1
                code, payload = _job_status(parts[2], after)
            else:
                code, payload = 404, {"error": "not found"}
            self._send(code, payload)
        elif self.path == "/test":
            # parity: GET /test returns the literal "test" (server.go:154-156)
            self._send_text(b"test", "text/plain")
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        # One request = one trace: the handler opens the request's root
        # span here, continuing the caller's trace when the request
        # carries a W3C `traceparent` header (utils/tracing.py). Tickets
        # capture this context at submit, the scheduler loop re-activates
        # it across the queue hop, and _send echoes the trace id back as
        # X-Osim-Trace-Id (docs/observability.md).
        from ..utils import tracing

        remote = tracing.TraceContext.from_traceparent(
            self.headers.get("traceparent")
        )
        with tracing.activate(remote):
            with tracing.span(
                "http-request", path=self.path, method="POST"
            ) as root:
                self._do_post_inner(root)

    def _do_post_inner(self, root) -> None:
        if self.path not in ("/api/deploy-apps", "/api/scale-apps", "/v1/jobs"):
            self._send(404, {"error": "not found"})
            return
        # Body I/O stays on the handler thread: the scheduler worker must
        # never block on a client socket, so a slow-loris client costs one
        # handler thread for at most REQUEST_TIMEOUT_S and never a queue
        # slot or the simulate pipeline.
        try:
            length = int(self.headers.get("Content-Length", 0))
            try:
                raw = self.rfile.read(length)
            except TimeoutError:
                self.close_connection = True
                self._send(408, {"error": "request body read timed out"})
                return
            body = json.loads(raw or b"{}")
        except Exception as e:
            self._send(400, {"error": str(e)})
            return
        if self.path == "/v1/jobs":
            # jobs bypass admission: submit is O(validate + thread spawn),
            # and the long work runs on the job thread against the journal
            code, payload = _submit_job(body)
            self._send(code, payload)
            return
        deadline_ms: Optional[float] = None
        hdr = self.headers.get("X-Osim-Deadline-Ms")
        if hdr is not None:
            try:
                deadline_ms = float(hdr)
            except ValueError:
                self._send(
                    400, {"error": f"invalid X-Osim-Deadline-Ms: {hdr!r}"}
                )
                return
        # Admission control (server/admission.py): enqueue or shed, then
        # block this handler thread until the scheduler worker finalizes the
        # ticket. Every outcome is a definite response — 200, 400, 408,
        # 429/503 + Retry-After (shed), 504 (deadline mid-simulate), or 500
        # (worker death, counted in osim_requests_dropped_total).
        queue = self.server.admission
        if not queue.worker_alive():
            # Degradation ladder, bottom rung (docs/serving.md): the
            # scheduler-loop thread died, so serve this request per-request
            # on the handler thread — correctness preserved, batching lost.
            # (Tickets already queued when the loop died still get their
            # honest 500 from wait()'s dead-worker check.)
            metrics.LOOP_FALLBACKS.inc()
            try:
                res = _execute_bodies([body])[0]
            except Exception as e:
                res = e
            if isinstance(res, BaseException):
                self._send(400, {"error": str(res)})
            else:
                self._send(200, res)
            return
        key, fence_epoch = _coalesce_key_for(self.path, body)
        ticket = queue.submit(
            body,
            key=key,
            deadline_ms=deadline_ms,
            fence_epoch=fence_epoch,
        )
        queue.wait(ticket)
        # Link (not parent) this root to the pack span that executed the
        # ticket: the pack ran on the loop thread, possibly serving many
        # lanes, so the relationship is a peer link in both directions.
        if ticket.pack_ctx is not None:
            root.add_link(ticket.pack_ctx)
        self._send(ticket.code, ticket.payload or {}, headers=ticket.headers)

    def log_message(self, fmt, *args):  # quiet gin-style access logs
        pass


def _prime_profiler(httpd) -> None:
    """Before the process's first CUDA capture: the profiler's client must
    initialise on the thread that imported torch, or a capture from a handler
    thread records no device activity (utils/profiling.py). The empty capture
    that does it is handed to the thread serving the socket, the main thread
    under `simon server`, so a server that is never profiled never pays it."""
    from ..utils import profiling

    if torch.device(_device).type == "cuda" and not profiling.primed():
        httpd.call_on_serving_thread(lambda: profiling.prime(_device), timeout=120.0)


def _graceful_shutdown(signum=None, frame=None) -> None:
    """SIGTERM/SIGINT handler: stop accepting connections and let serve()
    fall through to its drain. shutdown() must not run on the thread inside
    serve_forever (it deadlocks waiting for the loop to exit), so it is
    dispatched to a helper thread; signal handlers always run on the main
    thread, which IS the serve_forever thread."""
    httpd = _current_server
    if httpd is None:
        return
    name = signal.Signals(signum).name if signum is not None else "shutdown"
    print(f"simon server: received {name}, draining in-flight requests")
    try:
        # last-breath evidence: what the server was doing when it was told
        # to die (utils/flightrec.py) — written before the drain starts so
        # a kill -9 follow-up can't lose it
        from ..utils import flightrec

        flightrec.dump("sigterm")
    except Exception:
        pass
    threading.Thread(
        target=httpd.shutdown, name="osim-shutdown", daemon=True
    ).start()


def serve(
    port: int = 9998,
    ready: Optional[threading.Event] = None,
    kubeconfig: str = "",
    master: str = "",
    queue_depth: Optional[int] = None,
    coalesce_ms: Optional[float] = None,
    pack_window_ms: Optional[float] = None,
    default_deadline_ms: Optional[float] = None,
    device=DEFAULT_DEVICE,
) -> int:
    """Run the server on 127.0.0.1:`port` until SIGTERM/SIGINT (or
    _graceful_shutdown()), then drain; every device call runs on `device`
    (raises when it is CUDA and there is no card). Returns 0."""
    global _kubeconfig, _master, _snapshot, _snapshot_at, _current_server
    global _resident, _snapshot_stale
    _claim_device(device)
    _resolve_env_config()
    # Crash flight recorder: an unhandled exception on any thread dumps the
    # recent-span/metric/journal ring before the process dies
    # (utils/flightrec.py; idempotent).
    from ..utils import flightrec

    flightrec.install_crash_hook()
    _kubeconfig = kubeconfig or None
    _master = master
    # A previous serve() in this process may have cached a snapshot (and
    # resident planes) of a DIFFERENT cluster — never serve them against the
    # new config. _snapshot_fetches deliberately SURVIVES the reset: it must
    # stay monotonic across re-serves, because a coalesce key minted as
    # "...:gen3" by the old serve would otherwise collide with "...:gen3" of
    # the new cluster once the counter restarted — same key, different work,
    # one (wrong) shared response. With a resident the generation is its
    # epoch, drawn from a module-global counter in engine/resident.py that is
    # never reused across instances, which subsumes this counter entirely;
    # the surviving _snapshot_fetches covers the OSIM_RESIDENT=0 path.
    _snapshot, _snapshot_at = None, 0.0
    _resident, _snapshot_stale = None, False
    # Warm sessions of a previous serve() are keyed so they could never be
    # confused with the new config's (inline bodies are self-describing,
    # live keys carry a never-reused generation), but there is no reason to
    # hold their device buffers across a re-serve.
    with _sessions_lock:
        _sessions.clear()
    httpd = _DrainingHTTPServer(
        ("127.0.0.1", port),
        _Handler,
        queue_depth=queue_depth,
        coalesce_ms=coalesce_ms,
        pack_window_ms=pack_window_ms,
        default_deadline_ms=default_deadline_ms,
    )
    _current_server = httpd
    # Graceful termination: SIGTERM (kubelet/systemd stop) and SIGINT drain
    # in-flight requests before exiting. signal.signal only works on the
    # main thread — embedded/test serve() threads skip installation and can
    # call _graceful_shutdown directly instead.
    prior = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prior[sig] = signal.signal(sig, _graceful_shutdown)
        except ValueError:
            break
    if ready is not None:
        ready.set()
    print(f"simon server listening on 127.0.0.1:{port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # server_close() joins every in-flight handler thread
        # (_DrainingHTTPServer) — this IS the drain.
        httpd.server_close()
        _current_server = None
        for sig, handler in prior.items():
            signal.signal(sig, handler)
    return 0


def make_server(
    port: int = 0,
    *,
    queue_depth: Optional[int] = None,
    coalesce_ms: Optional[float] = None,
    pack_window_ms: Optional[float] = None,
    default_deadline_ms: Optional[float] = None,
    device=DEFAULT_DEVICE,
):
    """Embeddable server; returns the ThreadingHTTPServer (its `.admission`
    attribute is the live AdmissionQueue). Every device call of the process's
    servers runs on `device` (raises when it is CUDA and there is no card, or
    when another live server of the process runs on another device)."""
    _claim_device(device)
    _resolve_env_config()
    return _DrainingHTTPServer(
        ("127.0.0.1", port),
        _Handler,
        queue_depth=queue_depth,
        coalesce_ms=coalesce_ms,
        pack_window_ms=pack_window_ms,
        default_deadline_ms=default_deadline_ms,
    )
