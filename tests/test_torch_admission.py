"""Admission control on the port (server/admission.py and its server
wiring) against the JAX package's, on the CPU: every case of
tests/test_admission.py, each driven through both packages' modules on the
same bodies. Tolerance: status codes, shed reasons, Retry-After and the
other time-independent headers, payloads, executor calls and metric deltas
are equal exactly.

The queue runs without its loop thread (`run_pending()`) under a manual
clock, so shedding and deadlines are checked without sleeping; the few
cases with a real worker synchronise on Events.
"""

import json
import threading
import types
import urllib.error
import urllib.request

import pytest
import torch

from open_simulator_tpu.resilience import faults as jfaults
from open_simulator_tpu.server import admission as jadmission
from open_simulator_tpu.server import server as jserver
from open_simulator_tpu.utils import metrics as jmetrics
from open_simulator_tpu_torch.resilience import faults as tfaults
from open_simulator_tpu_torch.server import admission as tadmission
from open_simulator_tpu_torch.server import server as tserver
from open_simulator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention

J = types.SimpleNamespace(name="jax", adm=jadmission, srv=jserver, metrics=jmetrics,
                          faults=jfaults, kw={})
T = types.SimpleNamespace(name="torch", adm=tadmission, srv=tserver, metrics=tmetrics,
                          faults=tfaults, kw={"device": "cpu"})


def both(scenario):
    """Run `scenario(pkg)` for the JAX package and the port; the records
    must be equal. Returns the port's record."""
    want = scenario(J)
    got = scenario(T)
    assert got == want
    return got


class ManualClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _recorder():
    calls = []

    def execute(bodies):
        calls.append(list(bodies))
        return [{"echo": b} for b in bodies]

    return execute, calls


def _ticket(t):
    """The time-independent outcome of a ticket."""
    return (t.done.is_set(), t.code, t.shed_reason, dict(t.headers), t.payload, t.key)


def _queue(p, execute, **kw):
    kw.setdefault("clock", ManualClock())
    return p.adm.AdmissionQueue(execute, **kw)


# ---------------------------------------------------------------------------
# queue-full shedding + Retry-After
# ---------------------------------------------------------------------------


def test_queue_full_shed_has_retry_after_from_service_time():
    def scenario(p):
        execute, _ = _recorder()
        q = _queue(p, execute, depth=2, coalesce_ms=0.0, default_deadline_ms=0.0,
                   service_time_s=2.0)
        before = p.metrics.REQUESTS_SHED.value(reason="queue_full")
        t1, t2, t3 = (q.submit({"a": i}, key=f"k{i}") for i in (1, 2, 3))
        rec = [_ticket(t) for t in (t1, t2, t3)]
        shed = p.metrics.REQUESTS_SHED.value(reason="queue_full") - before
        q.run_pending()
        return rec, shed, [_ticket(t) for t in (t1, t2)]

    rec, shed, after = both(scenario)
    assert not rec[0][0] and not rec[1][0] and rec[2][0]
    assert rec[2][1:4] == (429, "queue_full", {"Retry-After": "6"})
    assert shed == 1
    assert after[0][1] == after[1][1] == 200


def test_queue_depth_resolved_from_env_at_construction(monkeypatch):
    monkeypatch.setenv("OSIM_SERVER_QUEUE_DEPTH", "3")
    monkeypatch.setenv("OSIM_SERVER_COALESCE_MS", "25")
    monkeypatch.setenv("OSIM_SERVER_DEFAULT_DEADLINE_MS", "1500")

    def scenario(p):
        q = _queue(p, lambda b: [])
        return q.depth, q.coalesce_s, q.default_deadline_ms

    depth, window, deadline = both(scenario)
    assert depth == 3 and window == pytest.approx(0.025) and deadline == 1500.0


def test_queue_depth_gauge_tracks_backlog():
    def scenario(p):
        execute, _ = _recorder()
        q = _queue(p, execute, depth=4, coalesce_ms=0.0)
        q.submit({"a": 1}, key="k1")
        q.submit({"a": 2}, key="k2")
        queued = p.metrics.ADMISSION_QUEUE_DEPTH.value()
        q.run_pending()
        return queued, p.metrics.ADMISSION_QUEUE_DEPTH.value()

    assert both(scenario) == (2, 0)


# ---------------------------------------------------------------------------
# deadline propagation
# ---------------------------------------------------------------------------


def test_expired_deadline_shed_at_dequeue_never_enters_execute():
    def scenario(p):
        execute, calls = _recorder()
        clk = ManualClock()
        q = _queue(p, execute, depth=4, coalesce_ms=0.0, clock=clk)
        before = p.metrics.REQUESTS_SHED.value(reason="deadline")
        t = q.submit({"a": 1}, key="k", deadline_ms=50.0)
        clk.advance(0.1)
        q.run_pending()
        return _ticket(t), calls, p.metrics.REQUESTS_SHED.value(reason="deadline") - before

    rec, calls, shed = both(scenario)
    assert rec[1:3] == (429, "deadline") and "Retry-After" in rec[3]
    assert calls == [] and shed == 1


def test_default_deadline_applies_when_request_has_none():
    def scenario(p):
        clk = ManualClock()
        q = _queue(p, lambda b: [{"ok": 1}] * len(b), depth=4, coalesce_ms=0.0,
                   default_deadline_ms=200.0, clock=clk)
        t = q.submit({"a": 1}, key="k")
        deadline_at = t.deadline_at
        clk.advance(0.3)
        q.run_pending()
        return deadline_at, t.shed_reason

    deadline_at, reason = both(scenario)
    assert deadline_at == pytest.approx(0.2) and reason == "deadline"


def test_midflight_deadline_aborts_via_watchdog_as_504():
    def scenario(p):
        clk = ManualClock()
        release = threading.Event()
        entered = []

        def execute(bodies):
            entered.append(len(bodies))
            clk.advance(10.0)  # the simulate pass "takes" 10 s
            release.wait(10.0)
            return [{"ok": 1}] * len(bodies)

        q = _queue(p, execute, depth=4, coalesce_ms=0.0, clock=clk, watchdog_poll_s=0.001)
        fired = p.metrics.WATCHDOG_FIRED.value(stage="serve-simulate")
        t = q.submit({"a": 1}, key="k", deadline_ms=500.0)
        q.run_pending()
        release.set()
        return (entered, _ticket(t),
                p.metrics.WATCHDOG_FIRED.value(stage="serve-simulate") - fired)

    entered, rec, fired = both(scenario)
    assert entered == [1] and rec[1] == 504 and "deadline" in rec[4]["error"]
    assert fired == 1 and rec[2] == ""  # an abort is not a shed


def _budget_spy(p, monkeypatch, budgets):
    real = p.adm.guarded_call

    def spy(stage, fn, deadline_s, **kw):
        budgets.append((stage, deadline_s))
        return real(stage, fn, deadline_s, **kw)

    monkeypatch.setattr(p.adm, "guarded_call", spy)


def test_watchdog_budget_is_most_generous_live_deadline(monkeypatch):
    def scenario(p):
        budgets = []
        _budget_spy(p, monkeypatch, budgets)
        q = _queue(p, lambda bodies: [{"ok": 1}] * len(bodies), depth=4, coalesce_ms=0.0)
        q.submit({"a": 1}, key="k1", deadline_ms=300.0)
        q.submit({"a": 2}, key="k2", deadline_ms=900.0)
        q.run_pending()
        return budgets

    assert both(scenario) == [("serve-simulate", pytest.approx(0.9))]


def test_watchdog_budget_unguarded_when_a_waiter_has_no_deadline(monkeypatch):
    monkeypatch.delenv("OSIM_CALL_DEADLINE_S", raising=False)

    def scenario(p):
        budgets = []
        _budget_spy(p, monkeypatch, budgets)
        q = _queue(p, lambda bodies: [{"ok": 1}] * len(bodies), depth=4, coalesce_ms=0.0)
        t1 = q.submit({"a": 1}, key="k1", deadline_ms=300.0)
        t2 = q.submit({"a": 2}, key="k2")
        q.run_pending()
        return budgets, t1.code, t2.code

    assert both(scenario) == ([("serve-simulate", 0.0)], 200, 200)


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------


def test_coalesced_batch_fans_out_per_request_results():
    def scenario(p):
        execute, calls = _recorder()
        q = _queue(p, execute, depth=8, coalesce_ms=0.0)
        _, sum0, count0 = p.metrics.COALESCED_BATCH.child_state(mode="fanout")
        body = {"apps": [{"name": "web"}]}
        ts = [q.submit(body, key="same"), q.submit(dict(body), key="same"),
              q.submit({"apps": []}, key="other")]
        q.run_pending()
        _, sum1, count1 = p.metrics.COALESCED_BATCH.child_state(mode="fanout")
        return calls, [_ticket(t) for t in ts], count1 - count0, sum1 - sum0

    calls, recs, groups, size = both(scenario)
    body = {"apps": [{"name": "web"}]}
    assert calls == [[body, {"apps": []}]]
    assert [r[1] for r in recs] == [200] * 3
    assert recs[0][4] == recs[1][4] == {"echo": body}
    assert recs[2][4] == {"echo": {"apps": []}}
    assert (groups, size) == (2, 3)


def test_per_key_execute_failure_only_fails_that_keys_waiters():
    def scenario(p):
        def execute(bodies):
            return [ValueError("bad spec") if b.get("bad") else {"ok": 1} for b in bodies]

        q = _queue(p, execute, depth=8, coalesce_ms=0.0)
        ts = [q.submit({"a": 1}, key="good"), q.submit({"bad": 1}, key="bad"),
              q.submit({"bad": 1}, key="bad")]
        q.run_pending()
        return [_ticket(t) for t in ts]

    good, bad1, bad2 = both(scenario)
    assert good[1] == 200 and bad1[1] == bad2[1] == 400
    assert "bad spec" in bad1[4]["error"]


def test_executor_wide_failure_answers_every_waiter_400():
    def scenario(p):
        def execute(bodies):
            raise RuntimeError("engine fell over")

        q = _queue(p, execute, depth=8, coalesce_ms=0.0)
        ts = [q.submit({"a": 1}, key="k1"), q.submit({"a": 2}, key="k2")]
        q.run_pending()
        return [_ticket(t) for t in ts]

    t1, t2 = both(scenario)
    assert t1[1] == t2[1] == 400 and "engine fell over" in t1[4]["error"]


def test_result_count_mismatch_is_a_definite_400():
    def scenario(p):
        q = _queue(p, lambda bodies: [], depth=4, coalesce_ms=0.0)
        t = q.submit({"a": 1}, key="k")
        q.run_pending()
        return _ticket(t)

    rec = both(scenario)
    assert rec[1] == 400 and "0 results" in rec[4]["error"]


def test_coalesce_key_folds_path_body_and_generation():
    def scenario(p):
        ck = p.adm.coalesce_key
        body = {"apps": [{"name": "a"}]}
        return [ck("/api/deploy-apps", dict(body)), ck("/api/deploy-apps", body),
                ck("/api/scale-apps", body), ck("/api/deploy-apps", {"apps": []}),
                ck("/api/deploy-apps", body, generation=1),
                ck("/api/deploy-apps", body, generation=2)]

    same, again, scale, other, g1, g2 = both(scenario)
    assert again == same and scale != same and other != same
    assert g1 != g2 and g1 != same


def test_coalesce_window_holds_batch_open_for_late_arrivals():
    def scenario(p):
        execute, calls = _recorder()
        q = _queue(p, execute, depth=8, coalesce_ms=50.0)
        q.submit({"a": 1}, key="k1")
        q.submit({"a": 2}, key="k2")
        q.run_pending()  # both arrivals land in one batch
        return calls

    assert both(scenario) == [[{"a": 1}, {"a": 2}]]


# ---------------------------------------------------------------------------
# drain semantics
# ---------------------------------------------------------------------------


def test_drain_sheds_queued_but_not_in_flight_work():
    def scenario(p):
        started, release = threading.Event(), threading.Event()

        def execute(bodies):
            started.set()
            assert release.wait(10.0)
            return [{"ok": 1}] * len(bodies)

        q = p.adm.AdmissionQueue(execute, depth=8, coalesce_ms=0.0).start()
        before = p.metrics.REQUESTS_SHED.value(reason="draining")
        inflight = q.submit({"a": 1}, key="k1")
        assert started.wait(10.0)
        queued = [q.submit({"a": 2}, key="k2"), q.submit({"a": 3}, key="k3")]
        q.shutdown()
        queued_rec = [_ticket(t) for t in queued]
        shed = p.metrics.REQUESTS_SHED.value(reason="draining") - before
        release.set()
        q.wait(inflight)
        q.join(10.0)
        alive = q._worker.is_alive()
        late = q.submit({"a": 4}, key="k4")
        return queued_rec, shed, inflight.code, alive, late.shed_reason

    queued, shed, inflight, alive, late = both(scenario)
    for rec in queued:
        assert rec[0] and rec[1:3] == (503, "draining") and "Retry-After" in rec[3]
    assert shed == 2 and inflight == 200 and not alive and late == "draining"


def test_wait_answers_500_dropped_if_worker_died():
    def scenario(p):
        q = _queue(p, lambda b: [{"ok": 1}] * len(b), depth=4)
        q._worker = threading.Thread(target=lambda: None)  # never started
        before = p.metrics.REQUESTS_DROPPED.value()
        t = q.submit({"a": 1}, key="k")
        q.wait(t, poll_s=0.001)
        return _ticket(t), p.metrics.REQUESTS_DROPPED.value() - before

    rec, dropped = both(scenario)
    assert rec[1] == 500 and "dropped" in rec[4]["error"] and dropped == 1


# ---------------------------------------------------------------------------
# fault injection (target=admission)
# ---------------------------------------------------------------------------


def _plan(p, kind: str, op: str, **kw):
    return p.faults.FaultPlan(
        seed=0, rules=[p.faults.FaultRule(target="admission", kind=kind, op=op, **kw)])


def test_fault_queue_full_sheds_even_with_room():
    def scenario(p):
        execute, calls = _recorder()
        q = _queue(p, execute, depth=8, coalesce_ms=0.0)
        with p.faults.injected(_plan(p, "queue_full", "submit", times=1)):
            t1 = q.submit({"a": 1}, key="k1")
            t2 = q.submit({"a": 2}, key="k2")
        pending = t2.done.is_set()
        q.run_pending()
        return _ticket(t1), pending, t2.code, calls

    t1, pending, t2, calls = both(scenario)
    assert t1[1:3] == (429, "queue_full") and not pending and t2 == 200
    assert calls == [[{"a": 2}]]


def test_fault_deadline_storm_expires_at_dequeue():
    def scenario(p):
        execute, calls = _recorder()
        q = _queue(p, execute, depth=8, coalesce_ms=0.0)
        with p.faults.injected(_plan(p, "deadline_storm", "submit", times=1)):
            t = q.submit({"a": 1}, key="k")
            q.run_pending()
        return t.shed_reason, calls

    assert both(scenario) == ("deadline", [])


def test_fault_slow_drain_injects_before_execute():
    def scenario(p):
        execute, _ = _recorder()
        q = _queue(p, execute, depth=8, coalesce_ms=0.0)
        with p.faults.injected(_plan(p, "slow_drain", "drain", latency_s=0.0)) as injector:
            t = q.submit({"a": 1}, key="k")
            q.run_pending()
        return t.code, injector.summary()[0]["injected"]

    assert both(scenario) == (200, 1)


# ---------------------------------------------------------------------------
# server wiring (env read at serve/make_server time + the HTTP front door)
# ---------------------------------------------------------------------------


def test_request_timeout_env_resolved_at_make_server_time(monkeypatch):
    monkeypatch.setenv("OSIM_SERVER_REQUEST_TIMEOUT_S", "7")

    def scenario(p):
        srv = p.srv.make_server(0, **p.kw)
        srv.server_close()
        return p.srv.REQUEST_TIMEOUT_S

    assert both(scenario) == 7.0


def test_monkeypatched_timeout_survives_when_env_absent(monkeypatch):
    monkeypatch.delenv("OSIM_SERVER_REQUEST_TIMEOUT_S", raising=False)

    def scenario(p):
        monkeypatch.setattr(p.srv, "REQUEST_TIMEOUT_S", 0.25)
        srv = p.srv.make_server(0, **p.kw)
        srv.server_close()
        return p.srv.REQUEST_TIMEOUT_S

    assert both(scenario) == 0.25


def test_resync_env_resolved_at_serve_time(monkeypatch):
    monkeypatch.setenv("OSIM_SERVER_RESYNC_S", "5")

    def scenario(p):
        monkeypatch.setattr(p.srv, "_resync_s", p.srv.RESYNC_SECONDS)
        srv = p.srv.make_server(0, **p.kw)
        srv.server_close()
        return p.srv._resync_s, p.srv.RESYNC_SECONDS

    assert both(scenario) == (5.0, 30.0)


def test_make_server_on_cuda_without_a_card_raises():
    """The port's server runs on its device and never moves to the CPU: a
    CUDA server on a machine without a card refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.make_server(0)


def _post(port, body, headers=None, timeout=10.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/deploy-apps", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _gated_server(p, monkeypatch, **kw):
    """An embedded server whose simulate blocks until `release` is set."""
    release, started = threading.Event(), threading.Event()

    def slow_simulate(body):
        started.set()
        assert release.wait(10.0)
        return {"placements": {}, "unscheduled": []}

    monkeypatch.setattr(p.srv, "_simulate_request", slow_simulate)
    srv = p.srv.make_server(0, coalesce_ms=0.0, **kw, **p.kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, release, started


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def test_http_burst_gets_definite_answers_and_retry_after(monkeypatch):
    """Four clients against queue depth 1, ordered by Events: one in
    flight, one queued, two shed with 429 + Retry-After; every answer is
    definite."""
    def scenario(p):
        srv, release, started = _gated_server(p, monkeypatch, queue_depth=1)
        port = srv.server_address[1]
        held = []
        threads = [threading.Thread(target=lambda i=i: held.append(_post(port, {"apps": [], "i": i})))
                   for i in range(2)]
        threads[0].start()
        assert started.wait(10.0)  # one request is in flight...
        threads[1].start()
        while len(srv.admission._queue) < 1:  # ...and one queued
            threading.Event().wait(0.005)
        shed = [_post(port, {"apps": [], "i": i}) for i in (2, 3)]
        release.set()
        for t in threads:
            t.join(10.0)
        _stop(srv)
        return (sorted(code for code, _, _ in held),
                [(code, headers.get("Retry-After"), payload) for code, headers, payload in shed])

    held, shed = both(scenario)
    assert held == [200, 200]
    for code, retry, payload in shed:
        assert code == 429 and int(retry) >= 1 and payload["reason"] == "queue_full"


def test_http_invalid_deadline_header_is_400(monkeypatch):
    def scenario(p):
        srv, release, _ = _gated_server(p, monkeypatch, queue_depth=1)
        release.set()
        code, _, payload = _post(srv.server_address[1], {"apps": []},
                                 headers={"X-Osim-Deadline-Ms": "soon"})
        _stop(srv)
        return code, payload

    code, payload = both(scenario)
    assert code == 400 and "X-Osim-Deadline-Ms" in payload["error"]


def test_server_close_sheds_queued_with_draining(monkeypatch):
    def scenario(p):
        srv, release, started = _gated_server(p, monkeypatch, queue_depth=4)
        port = srv.server_address[1]
        results, lock = [], threading.Lock()

        def client(i):
            res = _post(port, {"apps": [], "i": i})
            with lock:
                results.append(res)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        threads[0].start()
        assert started.wait(10.0)
        for t in threads[1:]:
            t.start()
        while len(srv.admission._queue) < 2:
            threading.Event().wait(0.005)

        def release_when_draining():
            while not srv.admission.draining:
                threading.Event().wait(0.01)
            release.set()

        helper = threading.Thread(target=release_when_draining)
        helper.start()
        _stop(srv)
        helper.join(10.0)
        for t in threads:
            t.join(10.0)
        return sorted((code, payload.get("reason"), "Retry-After" in headers)
                      for code, headers, payload in results)

    got = both(scenario)
    assert got == [(200, None, False), (503, "draining", True), (503, "draining", True)]


@pytest.fixture(autouse=True, scope="module")
def _untraced_allocations():
    """Pause tracemalloc for this file: an earlier file in the same worker
    may have left it tracing (a heap-profile test does), which slows
    Python-heavy tests tens of times."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start()
