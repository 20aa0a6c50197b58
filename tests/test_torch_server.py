"""The port's REST server (server/server.py) against the JAX package's, on
the CPU: the fence and server cases of tests/test_resident.py, the server
cases of tests/test_e2e.py (the RSS soak at 20 requests),
tests/test_tracing.py's /debug/timings case, async jobs, live snapshots
behind a stub apiserver (tools/stubs.py), and the identities that give
sim_configs.SERVE_DIGESTS its full-size constants. Each case drives both
packages' servers on the same bodies with the workload-name RNG reset in
both before each request. Tolerance: status codes, time-independent headers
and response bytes are equal exactly.
"""

import contextlib
import copy
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from unittest import mock

import pytest
import torch
import yaml

from open_simulator_tpu.core import workloads as jworkloads
from open_simulator_tpu.core.objects import Node as JNode
from open_simulator_tpu.core.objects import Pod as JPod
from open_simulator_tpu.engine import resident as jresident
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.resilience import faults as jfaults
from open_simulator_tpu.server import admission as jadmission
from open_simulator_tpu.server import server as jserver
from open_simulator_tpu.utils import kubeclient as jkube
from open_simulator_tpu.utils import metrics as jmetrics
from open_simulator_tpu.utils import tracing as jtracing
from open_simulator_tpu.utils.yamlio import walk_files
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.core import workloads as tworkloads
from open_simulator_tpu_torch.core.objects import Node as TNode
from open_simulator_tpu_torch.core.objects import Pod as TPod
from open_simulator_tpu_torch.engine import resident as tresident
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.resilience import faults as tfaults
from open_simulator_tpu_torch.server import admission as tadmission
from open_simulator_tpu_torch.server import server as tserver
from open_simulator_tpu_torch.tools import stubs
from open_simulator_tpu_torch.utils import kubeclient as tkube
from open_simulator_tpu_torch.utils import metrics as tmetrics
from open_simulator_tpu_torch.utils import tracing as ttracing

torch.set_num_threads(1)  # tiny tensors: threads only add contention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

J = types.SimpleNamespace(name="jax", srv=jserver, adm=jadmission, metrics=jmetrics,
                          wl=jworkloads, sim=jsim, Node=JNode, Pod=JPod, res=jresident,
                          faults=jfaults, kube=jkube, tracing=jtracing, kw={}, dev={})
T = types.SimpleNamespace(name="torch", srv=tserver, adm=tadmission, metrics=tmetrics,
                          wl=tworkloads, sim=tsim, Node=TNode, Pod=TPod, res=tresident,
                          faults=tfaults, kube=tkube, tracing=ttracing,
                          kw={"device": "cpu"}, dev={"device": "cpu"})


def both(scenario):
    """Run `scenario(pkg)` for the JAX package and the port; the records
    must be equal. Returns the port's record."""
    want = scenario(J)
    got = scenario(T)
    assert got == want
    return got


@contextlib.contextmanager
def served(p, **kw):
    """An embedded server of package `p` on an ephemeral port."""
    srv = p.srv.make_server(0, **kw, **p.kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def _request(port, path, body=None, headers=None, raw=None, timeout=120.0):
    """(status, headers, body bytes) of one request; POST when a body is
    given."""
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(p, port, path, body, **kw):
    """A POST after resetting package p's name RNG."""
    p.wl.reset_name_rng()
    code, headers, data = _request(port, path, body, **kw)
    return code, data


@contextlib.contextmanager
def live(p, monkeypatch, api_url, resync_s=3600.0):
    """Point package p's server module at a live apiserver with a clean
    snapshot cache."""
    monkeypatch.setattr(p.srv, "_master", api_url)
    monkeypatch.setattr(p.srv, "_kubeconfig", None)
    monkeypatch.setattr(p.srv, "_snapshot", None)
    monkeypatch.setattr(p.srv, "_snapshot_at", 0.0)
    monkeypatch.setattr(p.srv, "_resident", None)
    monkeypatch.setattr(p.srv, "_snapshot_stale", False)
    monkeypatch.setattr(p.srv, "_resync_s", resync_s)
    with p.srv._sessions_lock:
        p.srv._sessions.clear()
    yield
    with p.srv._sessions_lock:
        p.srv._sessions.clear()


def _fixture_objects(sub):
    objs = []
    for f in walk_files(os.path.join(FIXTURES, sub), (".yaml", ".yml")):
        with open(f) as fh:
            objs.extend(d for d in yaml.safe_load_all(fh) if d)
    return objs


def mknode(name, cpu="8", mem="16Gi"):
    res = {"cpu": cpu, "memory": mem, "pods": "110"}
    return {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": dict(res), "capacity": dict(res)}}


def mkpod(name, node, cpu="1", mem="1Gi"):
    return {"metadata": {"name": name, "namespace": "rt"},
            "spec": {"nodeName": node, "containers": [
                {"name": "c", "image": "img", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}}


# ---------------------------------------------------------------------------
# the generation fence and the live snapshot (tests/test_resident.py)
# ---------------------------------------------------------------------------


def test_fence_rekeys_ticket_when_epoch_moves(tmp_path):
    def scenario(p):
        nodes = [p.Node.from_dict(mknode("a")), p.Node.from_dict(mknode("b"))]
        res = p.res.ResidentCluster(journal_dir=str(tmp_path / p.name), **p.dev)
        res.sync(nodes, [])
        q = p.adm.AdmissionQueue(lambda bodies: [{"ok": True} for _ in bodies], depth=8,
                                 coalesce_ms=0, default_deadline_ms=0, fence=res.fence_epoch)
        current = p.metrics.ADMISSION_FENCE.value(outcome="current")
        rekeyed = p.metrics.ADMISSION_FENCE.value(outcome="rekeyed")
        e0 = res.epoch
        t1 = q.submit({"a": 1}, key=f"k:gen{res.epoch}", fence_epoch=res.epoch)
        res.sync(nodes, [p.Pod.from_dict(mkpod("p1", "a"))])  # the epoch moves
        t2 = q.submit({"a": 1}, key=f"k:gen{res.epoch}", fence_epoch=res.epoch)
        t3 = q.submit({"b": 2}, key="unfenced")
        q.run_pending()
        # epochs are process-wide counters: name them by their role
        keys = [t.key.replace(f"gen{e0}", "genE0").replace(f"fence{res.epoch}", "fenceE1")
                .replace(f"gen{res.epoch}", "genE1") for t in (t1, t2, t3)]
        return ([t.code for t in (t1, t2, t3)], keys,
                p.metrics.ADMISSION_FENCE.value(outcome="rekeyed") - rekeyed,
                p.metrics.ADMISSION_FENCE.value(outcome="current") - current)

    codes, keys, rekeyed, current = both(scenario)
    assert codes == [200] * 3
    assert keys == ["k:genE0@fenceE1", "k:genE1", "unfenced"]
    assert (rekeyed, current) == (1, 1)


def test_stale_generation_chaos_forces_rekey(tmp_path):
    def scenario(p):
        res = p.res.ResidentCluster(journal_dir=str(tmp_path / p.name), **p.dev)
        res.sync([p.Node.from_dict(mknode("a"))], [])
        q = p.adm.AdmissionQueue(lambda bodies: [{"ok": True} for _ in bodies], depth=8,
                                 coalesce_ms=0, default_deadline_ms=0, fence=res.fence_epoch)
        t = q.submit({"a": 1}, key=f"k:gen{res.epoch}", fence_epoch=res.epoch)
        plan = p.faults.FaultPlan(seed=0, rules=[p.faults.FaultRule(
            target="resident", kind="stale_generation", op="fence")])
        with p.faults.injected(plan):
            q.run_pending()
        return t.code, t.key.endswith("@fence-1")

    assert both(scenario) == (200, True)


def test_coalesce_key_stale_dimension():
    def scenario(p):
        ck = p.adm.coalesce_key
        body = {"apps": []}
        return (ck("/api/deploy-apps", body, generation=7),
                ck("/api/deploy-apps", body, generation=7, stale=True),
                ck("/p", body) == ck("/p", body, stale=True))

    fresh, stale, same = both(scenario)
    assert fresh != stale and stale.endswith(":stale") and same


def test_server_refresh_creates_and_fences_resident(monkeypatch):
    def scenario(p):
        snap = p.sim.ClusterResource(nodes=[p.Node.from_dict(mknode("l0")),
                                            p.Node.from_dict(mknode("l1"))], pods=[])
        if p is T:
            monkeypatch.setattr(p.srv, "_device", "cpu")
        monkeypatch.setattr(p.srv, "_kubeconfig", "fake")
        monkeypatch.setattr(p.srv, "_master", "")
        monkeypatch.setattr(p.srv, "_snapshot", None)
        monkeypatch.setattr(p.srv, "_snapshot_at", 0.0)
        monkeypatch.setattr(p.srv, "_resident", None)
        monkeypatch.setattr(p.srv, "_snapshot_stale", False)
        kc = p.kube
        with mock.patch.object(kc, "create_cluster_resource_from_kubeconfig", return_value=snap):
            p.srv._live_snapshot()
        made = p.srv._resident is not None
        gen, stale = p.srv._snapshot_generation()
        key, fence = p.srv._coalesce_key_for("/api/deploy-apps", {"apps": []})
        key2, fence2 = p.srv._coalesce_key_for(
            "/api/deploy-apps", {"cluster": {"objects": [{"kind": "Node"}]}})
        monkeypatch.setattr(p.srv, "_snapshot_at", -1e9)
        with mock.patch.object(kc, "create_cluster_resource_from_kubeconfig",
                               side_effect=kc.KubeClientError("boom")):
            p.srv._live_snapshot()
        key3, _ = p.srv._coalesce_key_for("/api/deploy-apps", {"apps": []})
        with mock.patch.object(kc, "create_cluster_resource_from_kubeconfig", return_value=snap):
            p.srv._live_snapshot()
        recovered = p.srv._snapshot_generation()[1]
        return (made, gen == p.srv._resident.epoch, stale, f":gen{gen}" in key, fence == gen,
                "gen" not in key2, fence2, key3.endswith(":stale"), recovered)

    assert both(scenario) == (True, True, False, True, True, True, None, True, False)


# ---------------------------------------------------------------------------
# the server's routes (tests/test_e2e.py, tests/test_tracing.py)
# ---------------------------------------------------------------------------


def test_server_roundtrip():
    body = {"cluster": {"objects": _fixture_objects("cluster")},
            "apps": [{"name": "shop", "objects": _fixture_objects("app")}]}

    def scenario(p):
        with served(p) as port:
            health = _request(port, "/healthz")
            out = _post(p, port, "/api/deploy-apps", body)
            bad = _request(port, "/api/deploy-apps", raw=b"{not-json")
        return health[0], health[2], out, bad[0]

    h_code, h_body, (code, data), bad = both(scenario)
    payload = json.loads(data)
    assert (h_code, json.loads(h_body), code, bad) == (200, {"status": "ok"}, 200, 400)
    assert payload["unscheduled"] == [] and len(payload["placements"]) >= 11


def test_server_pprof_endpoints():
    import tracemalloc

    try:
        with served(T) as port:
            prof = json.loads(_request(port, "/debug/pprof/profile?seconds=0.3")[2])
            heap1 = json.loads(_request(port, "/debug/pprof/heap")[2])
            blob = ["x" * 1024 for _ in range(1000)]
            heap2 = json.loads(_request(port, "/debug/pprof/heap")[2])
            del blob
    finally:
        # tracing slows every allocation of the process: turn it back off
        tracemalloc.stop()
        tserver._tracemalloc_on = False
    assert prof["polls"] > 0 and isinstance(prof["stacks"], list)
    assert heap1["note"] and not heap2["note"]
    assert heap2["traced_current_bytes"] > 0 and heap2["top"]
    assert set(prof) == {"seconds", "polls", "stacks"}
    assert set(heap2) == {"note", "traced_current_bytes", "traced_peak_bytes", "top"}


def test_server_scale_apps_roundtrip():
    nodes = [dict(mknode(f"s{i}"), kind="Node") for i in range(2)]
    bound = [{
        "kind": "Pod",
        "metadata": {"name": f"web-{i}", "namespace": "d", "labels": {"app": "web"},
                     "ownerReferences": [{"kind": "ReplicaSet", "name": "web-abc123"}],
                     "annotations": {"simon/workload-kind": "Deployment",
                                     "simon/workload-name": "web",
                                     "simon/workload-namespace": "d"}},
        "spec": {"nodeName": f"s{i}", "containers": [
            {"name": "c", "image": "i", "resources": {"requests": {"cpu": "7"}}}]},
    } for i in range(2)]
    scaled = {"kind": "Deployment", "metadata": {"name": "web", "namespace": "d"},
              "spec": {"replicas": 3, "template": {"metadata": {"labels": {"app": "web"}},
                       "spec": {"containers": [{"name": "c", "image": "img", "resources": {
                           "requests": {"cpu": "4", "memory": "128Mi"}}}]}}}}
    removal = [{"kind": "Deployment", "name": "web", "namespace": "d"}]
    raw_bound = []
    for i in range(2):
        pd = copy.deepcopy(bound[i])
        del pd["metadata"]["annotations"]
        pd["metadata"]["ownerReferences"] = (
            [{"kind": "Workflow", "name": "nightly"}] if i == 0 else []
        ) + [{"kind": "ReplicaSet", "name": "web-abc123"}]
        raw_bound.append(pd)
    rs = {"kind": "ReplicaSet", "apiVersion": "apps/v1",
          "metadata": {"name": "web-abc123", "namespace": "d",
                       "ownerReferences": [{"kind": "Deployment", "name": "web"}]}}
    bodies = [
        ("/api/scale-apps", {"cluster": {"objects": nodes + bound},
                             "apps": [{"name": "web", "objects": [scaled]}],
                             "removeWorkloads": removal}),
        ("/api/deploy-apps", {"cluster": {"objects": nodes + bound},
                              "apps": [{"name": "web", "objects": [scaled]}]}),
        ("/api/scale-apps", {"cluster": {"objects": nodes + raw_bound + [rs]},
                             "apps": [{"name": "web", "objects": [scaled]}],
                             "removeWorkloads": removal}),
    ]

    def scenario(p):
        with served(p) as port:
            return [_post(p, port, path, body) for path, body in bodies]

    outs = [json.loads(data) for code, data in both(scenario)]
    for out in (outs[0], outs[2]):
        assert out["unscheduled"] == [] and len(out["placements"]) == 3
        assert "d/web-0" not in out["placements"] and "d/web-1" not in out["placements"]
    assert len(outs[1]["unscheduled"]) == 3


def test_server_goroutine_dump():
    def scenario(p):
        with served(p) as port:
            dump = json.loads(_request(port, "/debug/pprof/goroutine")[2])
            idx = json.loads(_request(port, "/debug/pprof/")[2])
            cmdline = json.loads(_request(port, "/debug/pprof/cmdline")[2])
            test = _request(port, "/test")
        frames = [f for th in dump["threads"] for f in th["stack"]]
        return (idx, isinstance(cmdline["cmdline"], list), dump["count"] >= 2,
                dump["count"] == len(dump["threads"]), any("do_GET" in f for f in frames),
                all(isinstance(th["name"], str) and th["id"] for th in dump["threads"]),
                test[0], test[2], test[1]["Content-Type"])

    got = both(scenario)
    assert set(got[0]["profiles"]) >= {"goroutine", "heap", "profile", "cmdline"}
    assert got[1:] == (True, True, True, True, True, 200, b"test", "text/plain")


def test_server_resync_period_matches_reference():
    assert both(lambda p: p.srv.RESYNC_SECONDS) == 30.0


def test_server_snapshot_cache(monkeypatch):
    app = {"name": "a", "objects": [{
        "kind": "Deployment", "metadata": {"name": "d", "namespace": "x"},
        "spec": {"replicas": 1, "template": {"metadata": {"labels": {"app": "d"}},
                 "spec": {"containers": [{"name": "c", "image": "i",
                                          "resources": {"requests": {"cpu": "1"}}}]}}}}]}
    api = stubs.StubApiServer(sc.live_apis([dict(mknode(f"s{i}"), kind="Node")
                                            for i in range(2)]))
    extra = dict(mknode("extra"), kind="Node")

    def scenario(p):
        if p is T:
            monkeypatch.setattr(p.srv, "_device", "cpu")
        with live(p, monkeypatch, api.url):
            f0 = p.srv._snapshot_fetches
            p.wl.reset_name_rng()
            out1 = p.srv._simulate_request({"apps": [app]})
            lists = len(api.auth_seen)
            out2 = p.srv._simulate_request({"apps": [app]})
            cached = len(api.auth_seen) == lists
            fetches = p.srv._snapshot_fetches - f0
            monkeypatch.setattr(p.srv, "_snapshot_at", -10_000.0)
            p.srv._simulate_request({"apps": [app]})
            refetched = (p.srv._snapshot_fetches - f0, len(api.auth_seen) > lists)
            before = len(p.srv._snapshot.nodes)
            p.srv._simulate_request({"apps": [app], "newNodes": [extra]})
            return (out1, out2, cached, fetches, refetched,
                    len(p.srv._snapshot.nodes) == before)

    try:
        out1, out2, cached, fetches, refetched, pristine = both(scenario)
    finally:
        api.close()
    assert len(out1["placements"]) == len(out2["placements"]) == 1
    assert cached and fetches == 1 and refetched == (2, True) and pristine


def test_server_rss_soak():
    """20 sequential deploy-apps requests on the port's server must not grow
    RSS without bound: after 5 warm requests the other 15 add < 120 MB (the
    reference's bound for its 90). The first response equals the JAX
    server's."""
    def rss_mb() -> float:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    body = {"cluster": {"objects": _fixture_objects("cluster")},
            "apps": [{"name": "soak", "objects": _fixture_objects("app")}]}
    with served(J) as port:
        want = _post(J, port, "/api/deploy-apps", body)
    curve = []
    with served(T) as port:
        for i in range(20):
            code, data = _post(T, port, "/api/deploy-apps", body)
            assert code == 200 and json.loads(data)["unscheduled"] == []
            if i == 0:
                assert (code, data) == want
            if i in (4, 19):
                curve.append(rss_mb())
    growth = curve[1] - curve[0]
    assert growth < 120.0, f"RSS grew {growth:.1f} MB over 15 warm requests"


def test_server_debug_timings_endpoint():
    def scenario(p):
        with served(p) as port:
            with p.tracing.span("server-visible"):
                pass
            code, headers, data = _request(port, "/debug/timings")
        return code, any(r["name"] == "server-visible" for r in json.loads(data)["timings"])

    assert both(scenario) == (200, True)


def test_server_debug_profile_endpoint(tmp_path, monkeypatch):
    """GET /debug/profile on the CPU: a torch.profiler capture written as
    Chrome-trace JSON under the runs root, with the reference's report keys."""
    monkeypatch.setenv("OSIM_RUNS_DIR", str(tmp_path))
    with served(T) as port:
        code, _, data = _request(port, "/debug/profile?ms=50")
    report = json.loads(data)
    assert code == 200 and report["ok"] and report["seconds"] >= 0.05
    assert report["trace_dir"] == str(tmp_path / "device-profile")
    with open(report["trace_file"]) as fh:
        assert "traceEvents" in json.load(fh)


def test_profile_primes_on_the_serving_thread(tmp_path, monkeypatch):
    """The profiler's one-time prime is not paid at start-up: the first CUDA
    capture hands it to the thread inside serve_forever, once, and captures
    on the handler thread after it."""
    from open_simulator_tpu_torch.utils import profiling

    monkeypatch.setenv("OSIM_RUNS_DIR", str(tmp_path))
    primes, captures, state = [], [], {"primed": False}

    def fake_prime(device):
        primes.append((threading.current_thread().name, str(device)))
        state["primed"] = True

    def fake_capture(out_dir, duration_ms, device):
        captures.append((threading.current_thread().name, str(device)))
        return {"ok": True, "trace_dir": out_dir, "trace_file": "", "seconds": 0.0}

    monkeypatch.setattr(profiling, "prime", fake_prime)
    monkeypatch.setattr(profiling, "primed", lambda: state["primed"])
    monkeypatch.setattr(profiling, "capture_device_trace", fake_capture)
    srv = T.srv.make_server(0, device="cpu")
    monkeypatch.setattr(T.srv, "_device", torch.device("cuda"))  # no device call is made
    t = threading.Thread(target=srv.serve_forever, name="serving", daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        assert primes == []
        codes = [_request(port, "/debug/profile?ms=1")[0] for _ in range(2)]
    finally:
        srv.shutdown()
        srv.server_close()
    assert codes == [200, 200] and primes == [("serving", "cuda")]
    assert len(captures) == 2 and all(n != "serving" and d == "cuda" for n, d in captures)


def test_second_server_on_another_device_is_refused(monkeypatch):
    """The servers of a process share one snapshot, resident state and set
    of warm sessions, so they share one device: a server on another device
    than a live one's is refused, and allowed once the live one is closed."""
    monkeypatch.setattr(T.srv, "_device", T.srv._device)
    monkeypatch.setattr(T.srv, "resolve_device", torch.device)  # "cuda" without a card
    first = T.srv.make_server(0, device="cpu")
    try:
        with pytest.raises(ValueError, match="a server on cpu is live"):
            T.srv.make_server(0, device="cuda")
        second = T.srv.make_server(0, device="cpu")
        second.server_close()
    finally:
        first.server_close()
    assert T.srv._device == torch.device("cpu")
    T.srv._claim_device("cuda")
    assert T.srv._device == torch.device("cuda")


def test_server_unknown_routes_and_test_page():
    def scenario(p):
        with served(p) as port:
            return [(c, d) for c, _, d in (_request(port, "/nope"),
                                           _request(port, "/api/nope", {"apps": []}),
                                           _request(port, "/v1/jobs/a/b"))]

    assert both(scenario) == [(404, b'{"error": "not found"}')] * 3


# ---------------------------------------------------------------------------
# async jobs (POST /v1/jobs) on the run journal
# ---------------------------------------------------------------------------


def _wait(pred, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _job_body(replicas):
    nodes, apps = sc.capacity_sweep_spec(2, replicas)
    return {"cluster": {"objects": [dict(n, kind="Node") for n in nodes]},
            "apps": [{"name": name, "objects": objs} for name, objs in apps],
            "newNode": dict(sc.template_spec(), kind="Node"), "job": f"cap-{replicas}"}


@pytest.mark.parametrize("replicas", [12, 20])
def test_job_runs_to_its_outcome_like_jax(tmp_path, monkeypatch, replicas):
    """A capacity job journals its batched plan and completes with the JAX
    server's outcome.json and progress records; `runs list` and GET /v1/jobs
    list it."""
    def scenario(p):
        root = tmp_path / p.name
        monkeypatch.setenv("OSIM_RUNS_DIR", str(root))
        with served(p) as port:
            code, data = _post(p, port, "/v1/jobs", _job_body(replicas))
            sub = json.loads(data)

            def done():
                st = json.loads(_request(port, f"/v1/jobs/{sub['job']}?after=-1")[2])
                return st["status"] in ("completed", "failed")

            assert _wait(done)
            st = json.loads(_request(port, f"/v1/jobs/{sub['job']}?after=-1")[2])
            index = json.loads(_request(port, "/v1/jobs")[2])
            again = _request(port, "/v1/jobs/unknown")
        return (code, sub["job"], sub["run_dir"] == str(root / sub["job"]), st["status"],
                st["outcome"], [len(pr["counts"] or ()) for pr in st["progress"]],
                [j["name"] for j in index["jobs"]], again[0])

    want = scenario(J)
    got = scenario(T)
    assert got == want
    assert got[0] == 202 and got[2] and got[3] == "completed"
    assert got[4]["nodes_added"] == replicas - 2 and got[4]["batched_calls"] > 0
    assert got[6] == [f"cap-{replicas}"] and got[7] == 404
    from open_simulator_tpu_torch import cli

    rc = cli.main(["runs", "list", "--root", str(tmp_path / "torch"), "--format", "json"])
    assert rc == 0


def test_job_rejections_like_jax(tmp_path, monkeypatch):
    def scenario(p):
        monkeypatch.setenv("OSIM_RUNS_DIR", str(tmp_path / p.name))
        before = p.metrics.JOBS.value(outcome="rejected")
        with served(p) as port:
            outs = [_post(p, port, "/v1/jobs", body) for body in (
                {"kind": "other"}, {"apps": []}, {"newNode": {}, "job": "a/b"},
            )]
        return outs, p.metrics.JOBS.value(outcome="rejected") - before

    outs, rejected = both(scenario)
    assert [c for c, _ in outs] == [400, 400, 400] and rejected == 3


# ---------------------------------------------------------------------------
# live snapshots and the identities behind SERVE_DIGESTS
# ---------------------------------------------------------------------------


def test_response_digest_is_result_digest(monkeypatch):
    """A live-cluster request through either server answers bytes whose
    response_digest is result_digest of simulate() on the same cluster and
    apps: SERVE_DIGESTS["full"] is SIM_DIGESTS["plan"] by this identity. The
    same request again is served from the cached snapshot and the resident,
    with the same bytes."""
    nodes, _ = sc.plan_spec(600, 24)
    body = sc.serve_full_body(600, 24)
    api = stubs.StubApiServer(sc.live_apis(nodes))

    def scenario(p):
        with live(p, monkeypatch, api.url), served(p) as port:
            first = _post(p, port, "/api/deploy-apps", body)
            second = _post(p, port, "/api/deploy-apps", body)
        p.wl.reset_name_rng()
        cluster, apps = sc.build(sc.plan_spec(600, 24), p.Node, p.sim.ClusterResource,
                                 p.sim.AppResource)
        direct = sc.result_digest(p.sim.simulate(cluster, apps, **p.dev))
        return first, second, direct

    try:
        first, second, direct = both(scenario)
    finally:
        api.close()
    assert first == second and first[0] == 200
    assert sc.response_digest(json.loads(first[1])) == direct
    assert sc.SERVE_DIGESTS["full"] == sc.SIM_DIGESTS["plan"]


def test_live_rounds_response_is_resident_digest(monkeypatch):
    """The resync leg at small size: the stub moves by resident_rounds(); a
    refresh lands as a resident delta sync (no fallback), moves the fence
    epoch, and the response's response_digest is result_digest of simulate()
    on ResidentWalk's nodes and pods, the identity that makes
    SERVE_DIGESTS["resync"] RESIDENT_SIM_DIGEST. Both servers answer the same
    bytes."""
    nodes, _ = sc.plan_spec(400, 40)
    body = sc.serve_full_body(400, 40)
    rounds = list(sc.resident_rounds(nodes, n_rounds=4, per_round=8))
    moved, pods = list(nodes), []
    for changed, pods in rounds:
        for i, d in changed.items():
            if i < len(moved):
                moved[i] = d
            else:
                moved.append(d)

    def scenario(p):
        api = stubs.StubApiServer(sc.live_apis(nodes))
        try:
            with live(p, monkeypatch, api.url), served(p) as port:
                before = _post(p, port, "/api/deploy-apps", body)
                gen0 = p.srv._snapshot_generation()[0]
                deltas = sum(p.metrics.RESIDENT_DELTAS.value(kind=k)
                             for k in ("node_row", "node_added", "pod_usage"))
                falls = p.metrics.RESIDENT_FALLBACKS.snapshot()
                api.apis = sc.live_apis(moved, pods)
                monkeypatch.setattr(p.srv, "_resync_s", 0.0)
                after = _post(p, port, "/api/deploy-apps", body)
                moved_deltas = sum(p.metrics.RESIDENT_DELTAS.value(kind=k)
                                   for k in ("node_row", "node_added", "pod_usage")) - deltas
                stayed = p.metrics.RESIDENT_FALLBACKS.snapshot() == falls
                epoch_moved = p.srv._snapshot_generation()[0] != gen0
        finally:
            api.close()
        walk = sc.ResidentWalk(p.Node, p.Pod, nodes)
        for changed, pod_dicts in rounds:
            n, pd = walk.apply(changed, pod_dicts)
        p.wl.reset_name_rng()
        _, apps = sc.build(sc.plan_spec(400, 40), p.Node, p.sim.ClusterResource,
                           p.sim.AppResource)
        direct = sc.result_digest(p.sim.simulate(
            p.sim.ClusterResource(nodes=list(n), pods=list(pd)), apps, **p.dev))
        return before, after, moved_deltas > 0, stayed, epoch_moved, direct

    before, after, delta_synced, no_fallback, epoch_moved, direct = both(scenario)
    assert before[0] == after[0] == 200 and before != after
    assert delta_synced and no_fallback and epoch_moved
    assert sc.response_digest(json.loads(after[1])) == direct
    assert sc.SERVE_DIGESTS["resync"] == sc.RESIDENT_SIM_DIGEST


def test_response_census_ignores_names():
    a = {"placements": {"ns/web-aaa": "n0", "ns/web-bbb": "n1", "ns/low-tier-ccc": "n0"},
         "unscheduled": [{"pod": "ns/web-ddd", "reason": "r"}]}
    b = {"placements": {"ns/web-xxx": "n1", "ns/web-yyy": "n0", "ns/low-tier-zzz": "n0"},
         "unscheduled": [{"pod": "ns/web-www", "reason": "r"}]}
    c = {"placements": {"ns/web-xxx": "n1", "ns/web-yyy": "n1", "ns/low-tier-zzz": "n0"},
         "unscheduled": [{"pod": "ns/web-www", "reason": "r"}]}
    assert sc.response_census(a) == sc.response_census(b) != sc.response_census(c)
    assert sc.response_digest(a) != sc.response_digest(b)


@pytest.mark.slow
def test_serve_digests_match_jax(monkeypatch):
    """SERVE_DIGESTS' small-request lanes and the inline body, recomputed
    with each package's server on plan_spec()'s 10,000 nodes behind a stub
    apiserver: the 8 small bodies as one scenario pack, the lone small body
    with lane 3's weights (served by the pack's warm session), then the
    inline body (~1 min in JAX, ~40 s in the port)."""
    nodes, _ = sc.plan_spec()
    api = stubs.StubApiServer(sc.live_apis(nodes))

    def scenario(p):
        if p is T:
            monkeypatch.setattr(p.srv, "_device", "cpu")
        with live(p, monkeypatch, api.url):
            p.wl.reset_name_rng()
            outs = p.srv._execute_bodies([sc.serve_small_body(w) for w in sc.SERVE_WEIGHTS])
            got = {f"small/{i}": sc.response_digest(o) for i, o in enumerate(outs)}
            p.wl.reset_name_rng()
            lone = p.srv._execute_bodies([sc.serve_small_body(sc.SERVE_WEIGHTS[3])])[0]
            p.wl.reset_name_rng()
            got["inline"] = sc.response_digest(p.srv._execute_bodies([sc.serve_inline_body()])[0])
        return got, sc.response_digest(lone)

    try:
        got, lone = both(scenario)
    finally:
        api.close()
    assert got == {k: v for k, v in sc.SERVE_DIGESTS.items() if k in got}
    assert lone == got["small/3"]


def test_capacity_sweep_job_matches_jax(tmp_path, monkeypatch):
    """The serve phase's job on the port's server (capacity_sweep, the
    batched sweep) ends with SERVE_JOB_OUTCOME, whose numbers and placement
    digest are the JAX package's plan_capacity on the same input; `runs
    list` shows the job."""
    from open_simulator_tpu.engine.apply import placement_digest
    from open_simulator_tpu.engine.capacity import plan_capacity
    from open_simulator_tpu_torch import cli

    monkeypatch.setenv("OSIM_RUNS_DIR", str(tmp_path))
    with served(T) as port:
        code, data = _post(T, port, "/v1/jobs", sc.serve_job_body("capacity-sweep"))
        assert code == 202

        def status():
            return json.loads(_request(port, "/v1/jobs/capacity-sweep")[2])

        assert _wait(lambda: status()["status"] in ("completed", "failed"))
        st = status()
    assert st["status"] == "completed" and st["outcome"] == sc.SERVE_JOB_OUTCOME
    jworkloads.reset_name_rng()
    cluster, apps = sc.build(sc.capacity_sweep_spec(), JNode, jsim.ClusterResource,
                             jsim.AppResource)
    plan = plan_capacity(cluster, apps, JNode.from_dict(sc.template_spec()), sweep_mode="batched")
    assert placement_digest(plan.result) == sc.SERVE_JOB_OUTCOME["placement_digest"]
    want = sc.CAPACITY_DIGESTS["capacity_sweep/batched"]
    assert (plan.nodes_added, plan.attempts, plan.batched_calls, sc.result_digest(plan.result)) == want
    assert (plan.nodes_added, plan.attempts, plan.batched_calls) == tuple(
        sc.SERVE_JOB_OUTCOME[k] for k in ("nodes_added", "attempts", "batched_calls"))
    rows = json.loads(_cli_out(cli, ["runs", "list", "--root", str(tmp_path), "--format", "json"]))
    assert [r["name"] for r in rows] == ["capacity-sweep"]


def _cli_out(cli, argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def test_cli_server_verb_serves_and_drains(tmp_path):
    """`python -m open_simulator_tpu_torch.cli server`: without a card it
    refuses the default CUDA device (exit 1); with `--device cpu` it serves
    /healthz and the inline body with the JAX server's bytes, and SIGTERM
    drains it to exit 0."""
    import signal
    import socket
    import subprocess
    import sys

    from open_simulator_tpu_torch import cli

    if not torch.cuda.is_available():
        assert cli.main(["server", "--port", "0"]) == 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OSIM_FLIGHT_DIR=str(tmp_path), OSIM_RUNS_DIR=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "open_simulator_tpu_torch.cli", "server", "--port", str(port),
         "--device", "cpu"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert _wait(lambda: _try_health(port), timeout_s=120.0)
        body = sc.serve_inline_body()
        got = _request(port, "/api/deploy-apps", body)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with served(J) as jport:
        want = _post(J, jport, "/api/deploy-apps", body)
    assert (got[0], got[2]) == want
    assert sc.response_digest(json.loads(got[2])) == sc.SERVE_DIGESTS["inline"]
    assert proc.returncode == 0, out
    assert "received SIGTERM, draining" in out


def _try_health(port):
    try:
        return _request(port, "/healthz", timeout=2.0)[0] == 200
    except OSError:
        return False
