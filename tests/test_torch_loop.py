"""The continuous-batching scheduler loop on the port (server/loop.py and
the warm scenario sessions) against the JAX package's, on the CPU: every
case of tests/test_scheduler_loop.py, each driven through both packages'
modules on the same bodies, plus two simulate() calls on two threads held
to their serial results. Tolerance: codes, Retry-After, executor calls,
re-keyed coalesce keys, session call counts and response bytes are equal
exactly (the workload-name RNG reset in both packages before each run).
"""

import json
import threading
import types
import urllib.request

import pytest
import torch

from open_simulator_tpu.core import workloads as jworkloads
from open_simulator_tpu.core.objects import Node as JNode
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.server import admission as jadmission
from open_simulator_tpu.server import loop as jloop
from open_simulator_tpu.server import server as jserver
from open_simulator_tpu.utils import metrics as jmetrics
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.core import workloads as tworkloads
from open_simulator_tpu_torch.core.objects import Node as TNode
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.server import admission as tadmission
from open_simulator_tpu_torch.server import loop as tloop
from open_simulator_tpu_torch.server import server as tserver
from open_simulator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention

J = types.SimpleNamespace(adm=jadmission, loop=jloop, srv=jserver, metrics=jmetrics,
                          sim=jsim, wl=jworkloads, Node=JNode, fast=jfast, kw={})
T = types.SimpleNamespace(adm=tadmission, loop=tloop, srv=tserver, metrics=tmetrics,
                          sim=tsim, wl=tworkloads, Node=TNode, fast=tfast,
                          kw={"device": "cpu"})


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


# ---------------------------------------------------------------------------
# pack heuristic
# ---------------------------------------------------------------------------


def test_pack_ready_lone_and_full_dispatch_immediately():
    def scenario(p):
        pr = p.loop.pack_ready
        return ([pr(n, depth=16, pack_lanes=8) for n in range(0, 13)],
                pr(4, depth=4, pack_lanes=8))

    verdicts, depth_bound = both(scenario)
    assert verdicts == [False, True] + [False] * 6 + [True] * 5
    assert depth_bound


def test_pack_ready_lone_holds_under_saturation():
    def scenario(p):
        pr = p.loop.pack_ready
        return [pr(1, depth=16, pack_lanes=8, saturated=True),
                pr(1, depth=16, pack_lanes=8, saturated=False),
                pr(8, depth=16, pack_lanes=8, saturated=True),
                pr(4, depth=16, pack_lanes=8, saturated=True)]

    assert both(scenario) == [False, True, True, False]


def test_default_pack_lanes_is_the_scenario_bucket():
    assert both(lambda p: (p.loop.default_pack_lanes(), p.fast.SCENARIO_BUCKET)) == (8, 8)


def test_lone_request_does_not_wait_out_the_pack_window():
    def scenario(p):
        execute, calls = _recorder()
        q = p.adm.AdmissionQueue(execute, depth=8, pack_window_ms=60_000.0).start()
        try:
            t = q.submit({"a": 1}, key="k")
            assert t.done.wait(10.0)  # would time out under a window floor
            return t.code, calls
        finally:
            q.shutdown()
            q.join(10.0)

    assert both(scenario) == (200, [[{"a": 1}]])


# ---------------------------------------------------------------------------
# continuous batching: mid-flight arrivals join the NEXT pack
# ---------------------------------------------------------------------------


def test_midflight_arrivals_land_in_the_very_next_pack():
    def scenario(p):
        calls = []
        first_entered, release = threading.Event(), threading.Event()

        def execute(bodies):
            calls.append(list(bodies))
            if len(calls) == 1:
                first_entered.set()
                assert release.wait(10.0)
            return [{"ok": 1} for _ in bodies]

        q = p.adm.AdmissionQueue(execute, depth=8, pack_window_ms=0.0).start()
        try:
            q.submit({"a": 1}, key="k1")
            assert first_entered.wait(10.0)
            t2 = q.submit({"a": 2}, key="k2")
            t3 = q.submit({"a": 3}, key="k3")
            release.set()
            q.wait(t2)
            q.wait(t3)
            return calls
        finally:
            q.shutdown()
            q.join(10.0)

    assert both(scenario) == [[{"a": 1}], [{"a": 2}, {"a": 3}]]


# ---------------------------------------------------------------------------
# per-pack fence re-keying
# ---------------------------------------------------------------------------


def test_fence_moved_tickets_rekeyed_before_coalescing():
    def scenario(p):
        execute, calls = _recorder()
        epoch = {"v": 1}
        q = p.adm.AdmissionQueue(execute, depth=8, pack_window_ms=0.0, clock=ManualClock(),
                                 fence=lambda: epoch["v"])
        t1 = q.submit({"a": 1}, key="k", fence_epoch=1)
        t2 = q.submit({"a": 1}, key="k", fence_epoch=1)
        epoch["v"] = 2  # the snapshot moved while the pack was queued
        q.run_pending()
        t3 = q.submit({"a": 1}, key="k2", fence_epoch=2)
        q.run_pending()
        return [(t.key, t.code) for t in (t1, t2, t3)], calls

    keys, calls = both(scenario)
    assert keys == [("k@fence2", 200), ("k@fence2", 200), ("k2", 200)]
    assert calls == [[{"a": 1}], [{"a": 1}]]


# ---------------------------------------------------------------------------
# pack of one == serial simulate(), warm call after warm call
# ---------------------------------------------------------------------------


def digest(result) -> str:
    doc = {
        "placements": {st.node.name: sorted(pd.key for pd in st.pods) for st in result.node_status},
        "unscheduled": sorted((u.pod.key, u.reason) for u in result.unscheduled),
    }
    return json.dumps(doc, sort_keys=True)


def _node_dict(name, cpu="8", memory="16Gi"):
    res = {"cpu": cpu, "memory": memory, "pods": "110"}
    return {"kind": "Node", "apiVersion": "v1",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": dict(res), "capacity": dict(res)}}


def _deploy(name, replicas, cpu, memory):
    return {"kind": "Deployment", "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {"containers": [{"name": "c", "image": "img", "resources": {
                    "requests": {"cpu": cpu, "memory": memory}}}]}}}}


def _fixture(p):
    cluster = p.sim.ClusterResource(nodes=[p.Node.from_dict(_node_dict(f"node-{i}"))
                                           for i in range(4)])
    apps = [p.sim.AppResource(name="app", objects=[
        _deploy("web", 10, "1", "1Gi"), _deploy("db", 3, "2", "2Gi")])]
    return cluster, apps


def test_session_pack_of_one_byte_identical_to_serial_simulate():
    def scenario(p):
        cluster, apps = _fixture(p)
        p.wl.reset_name_rng()
        want = digest(p.sim.simulate(cluster, apps, **p.kw))
        p.wl.reset_name_rng()
        sess = p.sim.ScenarioSession(cluster, apps, **p.kw)
        got = []
        for _ in range(3):
            results = sess.run([p.sim.Scenario(name="req-0")])
            got.append(digest(results[0]))
        return want, got, sess.calls

    want, got, calls = both(scenario)
    assert got == [want] * 3 and calls == 3


def test_session_lanes_match_serial_across_reused_calls():
    spread = {"least_allocated": 100}

    def scenario(p):
        cluster, apps = _fixture(p)
        p.wl.reset_name_rng()
        want_default = digest(p.sim.simulate(cluster, apps, **p.kw))
        p.wl.reset_name_rng()
        want_spread = digest(p.sim.simulate(cluster, apps, weights=spread, **p.kw))
        p.wl.reset_name_rng()
        sess = p.sim.ScenarioSession(cluster, apps, **p.kw)
        got = []
        for _ in range(2):  # the second call reuses the session's state
            results = sess.run([p.sim.Scenario(name="default"),
                                p.sim.Scenario(name="spread", weights=spread)])
            got.append([digest(r) for r in results])
        return (want_default, want_spread), got

    want, got = both(scenario)
    assert got == [list(want)] * 2


def test_server_scenario_group_reuses_one_warm_session(monkeypatch):
    monkeypatch.delenv("OSIM_SERVER_LOOP", raising=False)
    body = {"cluster": {"objects": [_node_dict(f"node-{i}") for i in range(3)]},
            "apps": [{"name": "app", "objects": [_deploy("web", 4, "1", "1Gi")]}]}
    bodies = [dict(body), dict(body, weights={"least_allocated": 100})]

    def scenario(p):
        if p is T:
            monkeypatch.setattr(p.srv, "_device", "cpu")
        with p.srv._sessions_lock:
            p.srv._sessions.clear()
        p.wl.reset_name_rng()
        out1 = p.srv._execute_bodies(list(bodies))
        with p.srv._sessions_lock:
            ent = next(iter(p.srv._sessions.values()))
            first = (len(p.srv._sessions), ent["session"].calls, ent["busy"])
        out2 = p.srv._execute_bodies(list(bodies))
        with p.srv._sessions_lock:
            second = next(iter(p.srv._sessions.values()))["session"].calls
            p.srv._sessions.clear()
        return json.dumps(out1), json.dumps(out2), first, second

    out1, out2, first, second = both(scenario)
    assert out2 == out1 and first == (1, 1, False) and second == 2


def test_loop_dead_requests_served_per_request_on_handler_thread(monkeypatch):
    def scenario(p):
        monkeypatch.setattr(p.srv, "_simulate_request",
                            lambda body: {"placements": {}, "unscheduled": []})
        srv = p.srv.make_server(0, queue_depth=2, coalesce_ms=0.0, **p.kw)
        real_worker = srv.admission._worker
        srv.admission._worker = threading.Thread(target=lambda: None)  # dead
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        before = p.metrics.LOOP_FALLBACKS.value()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/api/deploy-apps", data=b"{}",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                out = (r.status, r.read())
            return out, p.metrics.LOOP_FALLBACKS.value() - before
        finally:
            srv.admission._worker = real_worker
            srv.shutdown()
            srv.server_close()

    out, fallbacks = both(scenario)
    assert out == (200, b'{"placements": {}, "unscheduled": []}') and fallbacks == 1


# ---------------------------------------------------------------------------
# Retry-After: loop-iteration EWMA x queue depth
# ---------------------------------------------------------------------------


def test_retry_after_cold_start_is_flat_default_not_backlog_scaled():
    def scenario(p):
        q = p.adm.AdmissionQueue(lambda b: [{"ok": 1}] * len(b), depth=2,
                                 pack_window_ms=0.0, clock=ManualClock())
        q.submit({"a": 1}, key="k1")
        q.submit({"a": 2}, key="k2")
        shed = q.submit({"a": 3}, key="k3")
        return shed.code, shed.headers["Retry-After"], p.adm.DEFAULT_SERVICE_TIME_S

    code, retry, default = both(scenario)
    assert code == 429 and retry == str(max(1, int(default)))


def test_retry_after_tracks_loop_iteration_ewma_times_depth():
    def scenario(p):
        clk = ManualClock()

        def execute(bodies):
            clk.advance(2.0)  # each loop iteration "takes" 2 s
            return [{"ok": 1}] * len(bodies)

        q = p.adm.AdmissionQueue(execute, depth=2, pack_window_ms=0.0, clock=clk)
        q.submit({"a": 1}, key="k1")
        q.run_pending()
        q.submit({"a": 2}, key="k2")
        q.submit({"a": 3}, key="k3")
        shed = q.submit({"a": 4}, key="k4")

        def fast(bodies):
            clk.advance(0.5)
            return [{"ok": 1}] * len(bodies)

        q._execute = fast
        q.run_pending()
        q2 = q.submit({"a": 5}, key="k5")
        with q._cv:
            hint = q._retry_hint_locked()
        q.run_pending()
        return shed.code, shed.headers["Retry-After"], hint, q2.code

    # 2 queued + this one at 2 s; then EWMA 0.3*0.5 + 0.7*2.0 = 1.55 over 2
    assert both(scenario) == (429, "6", 4, 200)


def test_pack_window_env_precedence_and_deprecated_alias(monkeypatch):
    def scenario(p):
        monkeypatch.setenv("OSIM_SERVER_PACK_WINDOW_MS", "40")
        monkeypatch.setenv("OSIM_SERVER_COALESCE_MS", "90")
        a = p.adm.AdmissionQueue(lambda b: [], clock=ManualClock()).coalesce_s
        monkeypatch.delenv("OSIM_SERVER_PACK_WINDOW_MS")
        b = p.adm.AdmissionQueue(lambda b: [], clock=ManualClock()).coalesce_s
        c = p.adm.AdmissionQueue(lambda b: [], pack_window_ms=10.0, clock=ManualClock()).coalesce_s
        return a, b, c

    a, b, c = both(scenario)
    assert (a, b, c) == (pytest.approx(0.040), pytest.approx(0.090), pytest.approx(0.010))


# ---------------------------------------------------------------------------
# thread safety: simulate() on two threads at once
# ---------------------------------------------------------------------------


def test_two_threads_simulate_like_serial():
    """The server may run simulate() on its loop while a worker abandoned by
    a deadline is still inside another simulate(). Two concurrent calls on
    different clusters give the serial results (held by the name-free
    census, since both threads draw names from the one process-wide RNG),
    and the route counters add up to the two serial runs'."""
    specs = [sc.plan_spec(300, 12), sc.plan_spec(120, 30)]

    def run(spec):
        cluster, apps = sc.build(spec, TNode, tsim.ClusterResource, tsim.AppResource)
        return tsim.simulate(cluster, apps, device="cpu")

    def census(result):
        return sc.response_census(tserver._format_result(result))

    def counts():
        return dict(tfast.PATH_COUNTS)

    c0 = counts()
    serial = [census(run(s)) for s in specs]
    c1 = counts()
    out, errors = [None, None], []

    def worker(i):
        try:
            out[i] = census(run(specs[i]))
        except BaseException as e:  # noqa: B036 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    c2 = counts()
    assert not errors and out == serial
    assert {k: c2[k] - c1[k] for k in c0} == {k: c1[k] - c0[k] for k in c0}
    # and each equals the JAX package's serial result
    for spec, want in zip(specs, serial):
        cluster, apps = sc.build(spec, JNode, jsim.ClusterResource, jsim.AppResource)
        assert sc.response_census(jserver._format_result(jsim.simulate(cluster, apps))) == want


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
