"""Trace identity on the port (utils/tracing.py TraceContext and its
plumbing) against the JAX package's, on the CPU: the OSIM_TRACE_FILE export
cases of tests/test_metrics.py (a simulate() round trip, no file without
the variable, the event cap's oldest-first rotation and its one warning, a
bad cap value), then the traceparent cases of
tests/test_trace_propagation.py (round trip, invalid headers, no context
outside a trace, activation on another thread, the pack span's parent and
links, the loop thread, an untraced submit, the server continuing an
incoming trace and echoing its id) and its extender cases, which now see a
`traceparent` header on both transports. Tolerance: headers, parent ids and
link sets equal exactly; each case runs through both packages. Last, the
port's own phase spans of one simulate() and one Simulator(...).run() on
one clock (construct, expand / pod-names / pod-clones / validate / order,
bind-placed / reasons, setup, signature and a group per route with its
phases),
each child inside its parent exactly, with the names, the name generator
and the bind order held equal to the JAX package's; and on a GPU-share
app the light scan's dynamics on its `select.scan` span.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from open_simulator_tpu.core.objects import Node as JNode
from open_simulator_tpu.engine import extenders as jext
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.models.profiles import ExtenderConfig as JExtenderConfig
from open_simulator_tpu.server import admission as jadmission
from open_simulator_tpu.server import server as jserver
from open_simulator_tpu.utils import httppool as jhttppool
from open_simulator_tpu.utils import tracing as jtracing
from open_simulator_tpu_torch.core.objects import Node as TNode
from open_simulator_tpu_torch.engine import extenders as text
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.models.profiles import ExtenderConfig as TExtenderConfig
from open_simulator_tpu_torch.server import admission as tadmission
from open_simulator_tpu_torch.server import server as tserver
from open_simulator_tpu_torch.utils import httppool as thttppool
from open_simulator_tpu_torch.utils import tracing as ttracing

torch.set_num_threads(1)  # tiny tensors: threads only add contention

J = types.SimpleNamespace(tracing=jtracing, adm=jadmission, srv=jserver, sim=jsim, Node=JNode,
                          ext=jext, Ext=JExtenderConfig, pool=jhttppool, kw={})
T = types.SimpleNamespace(tracing=ttracing, adm=tadmission, srv=tserver, sim=tsim, Node=TNode,
                          ext=text, Ext=TExtenderConfig, pool=thttppool, kw={"device": "cpu"})


def both(scenario):
    """Run `scenario(pkg)` for the JAX package and the port; the records
    must be equal. Returns the port's record."""
    want = scenario(J)
    got = scenario(T)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def _fresh_pools():
    for p in (J, T):
        p.pool.reset_pools()
    yield
    for p in (J, T):
        p.pool.reset_pools()


def _recent(p, name):
    return [r for r in p.tracing.recent_timings() if r["name"] == name]


def _wait_for(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ---------------------------------------------------------------------------
# TraceContext / traceparent primitives
# ---------------------------------------------------------------------------


def test_traceparent_round_trip():
    def scenario(p):
        with p.tracing.span("origin") as s:
            ctx = p.tracing.current_context()
            header = p.tracing.current_traceparent()
        back = p.tracing.TraceContext.from_traceparent(header)
        return (ctx == p.tracing.TraceContext(s.trace_id, s.span_id),
                header == f"00-{s.trace_id}-{s.span_id}-01", back == ctx, len(header))

    assert both(scenario) == (True, True, True, 55)


@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-zz-zz-01",
    "00-" + "0" * 32 + "-" + "ab12ab12ab12ab12" + "-01",  # zero trace
    "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",           # zero span
    "ff-" + "ab" * 16 + "-" + "ab12ab12ab12ab12" + "-01",  # bad version
])
def test_traceparent_invalid_headers_return_none(header):
    assert both(lambda p: p.tracing.TraceContext.from_traceparent(header)) is None


def test_traceparent_valid_header_parses_like_jax():
    header = " 00-" + "AB" * 16 + "-1234123412341234-01 "
    got = both(lambda p: p.tracing.TraceContext.from_traceparent(header).to_dict())
    assert got == {"trace_id": "ab" * 16, "span_id": "1234123412341234"}


def test_outside_any_trace_no_context_is_minted():
    def scenario(p):
        return (p.tracing.current_context(), p.tracing.current_trace_id(),
                p.tracing.current_traceparent())

    assert both(scenario) == (None, None, None)


def test_activate_makes_thread_root_a_child_by_id():
    def scenario(p):
        with p.tracing.span("submitter") as parent:
            ctx = p.tracing.current_context()
        seen = {}

        def worker():
            with p.tracing.activate(ctx):
                with p.tracing.span("far-side") as s:
                    seen["ids"] = (s.trace_id == parent.trace_id, s.parent_id == parent.span_id)
            seen["after"] = p.tracing.current_context()

        t = threading.Thread(target=worker)
        t.start()
        t.join(10.0)
        far = _recent(p, "far-side")[-1]
        return seen["ids"], seen["after"], far["parent_id"] == parent.span_id

    assert both(scenario) == ((True, True), None, True)


# ---------------------------------------------------------------------------
# admission queue -> scheduler loop: the pack span
# ---------------------------------------------------------------------------


def test_pack_span_parents_first_lane_and_links_the_rest():
    def scenario(p):
        q = p.adm.AdmissionQueue(lambda bodies: [{"ok": 1} for _ in bodies], depth=8,
                                 coalesce_ms=0.0, default_deadline_ms=0.0)
        with p.tracing.span("req-a") as a:
            ta = q.submit({"a": 1}, key="ka")
        with p.tracing.span("req-b") as b:
            tb = q.submit({"a": 2}, key="kb")
        captured = (ta.trace_ctx == a.context(), tb.trace_ctx == b.context())
        q.run_pending()
        pack = _recent(p, "loop-pack")[-1]
        return (captured, pack["trace_id"] == a.trace_id, pack["parent_id"] == a.span_id,
                pack["links"] == [{"trace_id": b.trace_id, "span_id": b.span_id}],
                ta.pack_ctx == tb.pack_ctx, ta.pack_ctx.trace_id == a.trace_id,
                ta.pack_ctx.span_id == pack["span_id"], pack["meta"])

    assert both(scenario) == ((True, True), True, True, True, True, True, True, {"lanes": 2})


def test_pack_span_connected_across_the_loop_thread():
    def scenario(p):
        q = p.adm.AdmissionQueue(lambda bodies: [{"ok": 1} for _ in bodies], depth=8,
                                 pack_window_ms=0.0).start()
        try:
            with p.tracing.span("request") as root:
                t = q.submit({"a": 1}, key="k")
            q.wait(t)
            joined = _wait_for(lambda: any(
                r["trace_id"] == root.trace_id for r in _recent(p, "loop-pack")))
            pack = [r for r in _recent(p, "loop-pack") if r["trace_id"] == root.trace_id][-1]
            return t.code, joined, pack["parent_id"] == root.span_id
        finally:
            q.shutdown()
            q.join(10.0)

    assert both(scenario) == (200, True, True)


def test_untraced_submit_still_packs_with_fresh_trace():
    def scenario(p):
        q = p.adm.AdmissionQueue(lambda bodies: [{"ok": 1} for _ in bodies], depth=8,
                                 coalesce_ms=0.0, default_deadline_ms=0.0)
        t = q.submit({"a": 1}, key="k")
        ctx = t.trace_ctx
        q.run_pending()
        pack = _recent(p, "loop-pack")[-1]
        return ctx, t.code, len(pack["trace_id"]), "parent_id" in pack

    assert both(scenario) == (None, 200, 32, False)


# ---------------------------------------------------------------------------
# extenders: outbound traceparent
# ---------------------------------------------------------------------------


def _nodes(p, n, cpu="16"):
    return [p.Node.from_dict({
        "metadata": {"name": f"n{i}", "labels": {"kubernetes.io/hostname": f"n{i}"}},
        "status": {"allocatable": {"cpu": cpu, "memory": "32Gi", "pods": "110"}},
    }) for i in range(n)]


def _sts(replicas=1, cpu="1", name="w"):
    return {"kind": "StatefulSet", "metadata": {"name": name, "namespace": "x"},
            "spec": {"replicas": replicas, "template": {"metadata": {"labels": {"app": name}},
                     "spec": {"containers": [{"name": "c", "image": "img",
                                              "resources": {"requests": {"cpu": cpu}}}]}}}}


def _ext(p, url):
    return p.Ext(url_prefix=url, filter_verb="filter", prioritize_verb="prioritize")


def _trace_ids(stub):
    """The trace id each recorded request carried, None where it had no
    valid traceparent."""
    out = []
    for hdr in stub.request_headers:
        ctx = ttracing.TraceContext.from_traceparent(hdr.get("traceparent"))
        out.append(ctx.trace_id if ctx is not None else None)
    return out


def test_extender_wave_chains_stay_in_the_simulate_trace(stub_factory, monkeypatch):
    """Chains run on pool threads; their spans are roots that are children by
    id of the simulate trace, and every extender request carries that
    trace's traceparent."""
    monkeypatch.setenv("OSIM_EXTENDER_WAVE", "4")

    def scenario(p):
        stub = stub_factory({})
        with p.tracing.span("wave-request") as root:
            p.sim.simulate(p.sim.ClusterResource(nodes=_nodes(p, 4)),
                           [p.sim.AppResource(name="a", objects=[_sts(replicas=4)])],
                           extenders=[_ext(p, stub.url)], **p.kw)
        chains = [r for r in _recent(p, "extender-chain") if r["trace_id"] == root.trace_id]
        tree_ids = set()

        def collect(d):
            tree_ids.add(d["span_id"])
            for c in d.get("children", ()):
                collect(c)

        for r in p.tracing.recent_timings():
            if r.get("trace_id") == root.trace_id:
                collect(r)
        return (len(chains) > 0, all(ch["parent_id"] in tree_ids for ch in chains),
                all(any(c["name"] == "extender-http" for c in ch.get("children", ()))
                    for ch in chains),
                len(stub.request_headers) > 0,
                set(_trace_ids(stub)) == {root.trace_id})

    assert both(scenario) == (True, True, True, True, True)


def test_serial_extender_sends_traceparent_on_both_transports(stub_factory, monkeypatch):
    def scenario(p):
        out = []
        for keepalive in ("1", "0"):
            monkeypatch.setenv("OSIM_EXTENDER_KEEPALIVE", keepalive)
            monkeypatch.setenv("OSIM_EXTENDER_WAVE", "0")
            p.pool.reset_pools()
            stub = stub_factory({})
            with p.tracing.span("serial-request") as root:
                p.sim.simulate(p.sim.ClusterResource(nodes=_nodes(p, 2)),
                               [p.sim.AppResource(name="a", objects=[_sts(replicas=1)])],
                               extenders=[_ext(p, stub.url)], **p.kw)
            out.append((len(stub.request_headers), set(_trace_ids(stub)) == {root.trace_id}))
        return out

    got = both(scenario)
    assert all(n > 0 and same for n, same in got)


def test_untraced_extender_call_sends_no_traceparent(stub_factory):
    def scenario(p):
        stub = stub_factory({})
        ext = p.ext.HTTPExtender(_ext(p, stub.url))
        outside = p.tracing.current_context()
        ext._roundtrip(f"{stub.url}/filter", "filter", b"{}", 5.0)
        untraced = all("traceparent" not in h for h in stub.request_headers)
        with p.tracing.span("outer") as root:
            ext._roundtrip(f"{stub.url}/filter", "filter", b"{}", 5.0)
        return outside, untraced, _trace_ids(stub)[-1] == root.trace_id

    assert both(scenario) == (None, True, True)


# ---------------------------------------------------------------------------
# HTTP server: an incoming traceparent, the X-Osim-Trace-Id echo
# ---------------------------------------------------------------------------


def _post(port, body, headers=None, timeout=10.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/deploy-apps", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def test_server_continues_incoming_trace_and_echoes_trace_id(monkeypatch):
    upstream = "ab" * 16

    def scenario(p):
        monkeypatch.setattr(p.srv, "_execute_bodies", lambda bodies: [{"ok": True} for _ in bodies])
        srv = p.srv.make_server(0, queue_depth=4, coalesce_ms=0.0, **p.kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            port = srv.server_address[1]
            code, headers, _ = _post(port, {"apps": []},
                                     headers={"traceparent": f"00-{upstream}-1234123412341234-01"})
            joined = _wait_for(lambda: any(r["trace_id"] == upstream
                                           for r in _recent(p, "http-request")))
            roots = [r for r in _recent(p, "http-request") if r["trace_id"] == upstream]
            packs = [r for r in _recent(p, "loop-pack") if r["trace_id"] == upstream]
            code2, headers2, _ = _post(port, {"apps": [], "n": 2})
            fresh = headers2["X-Osim-Trace-Id"]
            return (code, headers["X-Osim-Trace-Id"], joined, roots[-1]["parent_id"],
                    roots[-1]["links"] == [{"trace_id": upstream,
                                            "span_id": packs[-1]["span_id"]}],
                    code2, len(fresh), fresh != upstream)
        finally:
            srv.shutdown()
            srv.server_close()

    assert both(scenario) == (200, upstream, True, "1234123412341234", True, 200, 32, True)


# ---------------------------------------------------------------------------
# OSIM_TRACE_FILE export
# ---------------------------------------------------------------------------

_NODE = {
    "kind": "Node",
    "metadata": {"name": "n0", "labels": {"kubernetes.io/hostname": "n0"}},
    "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"}},
}
_DEPLOY = {
    "kind": "Deployment",
    "metadata": {"name": "d", "namespace": "x"},
    "spec": {
        "replicas": 2,
        "template": {
            "metadata": {"labels": {"app": "d"}},
            "spec": {"containers": [{"name": "c", "image": "i",
                                     "resources": {"requests": {"cpu": "1"}}}]},
        },
    },
}


def test_trace_file_round_trip(monkeypatch, tmp_path):
    """One simulate() -> valid JSON, every event a complete event inside the
    root's window, the root's meta as args, and one connected tree: every
    non-root event's parent id is another event's span id of the same
    trace. The port's tree holds every (parent, child) edge of the JAX
    export's (the port adds a `bind` span under `simulate`)."""

    def scenario(p):
        path = tmp_path / f"trace-{id(p)}.json"
        monkeypatch.setenv("OSIM_TRACE_FILE", str(path))
        p.tracing.reset_trace_events()
        try:
            p.sim.simulate(p.sim.ClusterResource(nodes=[p.Node.from_dict(_NODE)]),
                           [p.sim.AppResource(name="a", objects=[_DEPLOY])], **p.kw)
        finally:
            monkeypatch.delenv("OSIM_TRACE_FILE")
            payload = json.loads(path.read_text())
            p.tracing.reset_trace_events()
        events = payload["traceEvents"]
        roots = [e for e in events if e["name"] == "simulate"]
        assert len(roots) == 1
        root = roots[0]
        by_span = {e["args"]["span_id"]: e for e in events}
        for e in events:
            assert e["ph"] == "X" and e["pid"] and e["tid"]
            assert isinstance(e["ts"], float) and e["ts"] > 0
            assert isinstance(e["dur"], float) and e["dur"] >= 0
            assert e["ts"] >= root["ts"] - 1e3
            assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e3
            assert e["args"]["trace_id"] == root["args"]["trace_id"]
            if e is not root:
                assert e["args"]["parent_id"] in by_span
        assert root["args"]["nodes"] == 1

        return {(by_span[e["args"]["parent_id"]]["name"], e["name"])
                for e in events if e is not root}

    want, got = scenario(J), scenario(T)
    assert want <= got, sorted(want - got)
    assert {child for _, child in want} >= {
        "expand-workloads", "encode-cluster", "encode", "schedule", "decode-result"}


def test_trace_file_not_written_when_env_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("OSIM_TRACE_FILE", raising=False)
    ttracing.reset_trace_events()
    with ttracing.span("no-export"):
        pass
    assert list(tmp_path.iterdir()) == []


def test_trace_file_event_cap_rotates_oldest(monkeypatch, tmp_path, caplog):
    import logging

    path = tmp_path / "trace.json"
    monkeypatch.setenv("OSIM_TRACE_FILE", str(path))
    monkeypatch.setenv("OSIM_TRACE_MAX_EVENTS", "5")
    ttracing.reset_trace_events()
    try:
        with caplog.at_level(logging.WARNING, logger=ttracing.log.name):
            for i in range(9):
                with ttracing.span(f"rotate-{i}"):
                    pass
        payload = json.loads(path.read_text())
    finally:
        ttracing.reset_trace_events()
    assert [e["name"] for e in payload["traceEvents"]] == [f"rotate-{i}" for i in range(4, 9)]
    warnings = [r for r in caplog.records if "event cap 5 reached" in r.getMessage()]
    assert len(warnings) == 1  # once, not once per export


def test_trace_event_cap_bad_value_falls_back(monkeypatch, tmp_path):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("OSIM_TRACE_FILE", str(path))
    monkeypatch.setenv("OSIM_TRACE_MAX_EVENTS", "not-a-number")
    ttracing.reset_trace_events()
    try:
        with ttracing.span("cap-fallback"):
            pass
        payload = json.loads(path.read_text())
    finally:
        ttracing.reset_trace_events()
    assert [e["name"] for e in payload["traceEvents"]] == ["cap-fallback"]


# ---------------------------------------------------------------------------
# The port's phase spans: one clock, construct, expansion, bind, routes
# ---------------------------------------------------------------------------

def _zone_nodes(p, n):
    return [p.Node.from_dict({
        "metadata": {"name": f"n{i}", "labels": {"kubernetes.io/hostname": f"n{i}",
                                                 "topology.kubernetes.io/zone": f"z{i % 3}"}},
        "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "110"}},
    }) for i in range(n)]


def _workload(kind, name, n, cpu="100m", spread=False):
    spec = {"containers": [{"name": "c", "image": "i", "resources": {"requests": {"cpu": cpu}}}]}
    if spread:
        spec["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule", "labelSelector": {"matchLabels": {"app": name}}}]
    template = {"metadata": {"labels": {"app": name}}, "spec": spec}
    count = "completions" if kind == "Job" else "replicas"
    return {"kind": kind, "metadata": {"name": name, "namespace": "x"},
            "spec": {count: n, "template": template}}


def _phase_apps(p):
    """Two apps: a Deployment of 70 (the sort route), a spread Deployment
    of 66 (the domain route), a pod no node fits (the grouped route,
    unschedulable); then a StatefulSet and a Job."""
    return [
        p.sim.AppResource(name="a", objects=[
            _workload("Deployment", "web", 70), _workload("Deployment", "zonal", 66, spread=True),
            _workload("Deployment", "huge", 1, cpu="64")]),
        p.sim.AppResource(name="b", objects=[
            _workload("StatefulSet", "db", 3), _workload("Job", "batch", 4, cpu="200m")]),
    ]


def _walk(node, parent=None):
    yield parent, node
    for c in node.get("children", ()):
        yield from _walk(c, node)


def _children(node, name=None):
    return [c for c in node.get("children", ()) if name is None or c["name"] == name]


def _traced_call(entry, mesh=None):
    """(the roots this call recorded, the PATH_COUNTS delta, the result) of
    one port call on the phase apps."""
    from open_simulator_tpu_torch.ops import fast as tfast

    ttracing._history.clear()
    before = dict(tfast.PATH_COUNTS)
    cluster = T.sim.ClusterResource(nodes=_zone_nodes(T, 6))
    kw = dict(T.kw, mesh=mesh) if mesh is not None else T.kw
    if entry == "simulate":
        res = T.sim.simulate(cluster, _phase_apps(T), **kw)
    else:
        res = T.sim.Simulator(cluster, **kw).run(_phase_apps(T))
    delta = {k: v - before[k] for k, v in tfast.PATH_COUNTS.items() if v != before[k]}
    return ttracing.recent_timings(), delta, res


@pytest.fixture(scope="module", params=["simulate", "run"])
def traced(request):
    """One port call by each entry: simulate(), and Simulator(...).run()."""
    roots, delta, res = _traced_call(request.param)
    return request.param, roots, delta, res


def test_one_simulate_root_and_construct_first(traced):
    entry, roots, _, _ = traced
    assert [r["name"] for r in roots] == ["simulate"]
    names = [c["name"] for c in _children(roots[0])]
    want = ["expand-workloads", "encode-cluster"] + ["encode", "schedule", "bind"] * 2 + [
        "decode-result"]
    assert names == (["construct"] + want if entry == "simulate" else want)
    assert roots[0]["meta"] == {"nodes": 6, "apps": 2}


def test_expand_validate_order_per_app(traced):
    _, roots, _, _ = traced
    (ew,) = _children(roots[0], "expand-workloads")
    assert [c["name"] for c in _children(ew)] == ["expand", "validate", "order"] * 2
    a_expand, b_expand = _children(ew, "expand")
    assert [c["meta"]["pods"] for c in _children(ew)] == [137, 137, 137, 7, 7, 7]
    # a replica kind gives its names, then its clones; the prototype is the
    # first pod, so n - 1 of each. The collector is held off while the
    # clones are built, so none of its passes lands in pod-clones
    assert [(c["name"], c["meta"]) for c in _children(a_expand)] == [
        ("pod-names", {"pods": 69, "kind": "Deployment"}),
        ("pod-clones", {"pods": 69, "kind": "Deployment", "gc_passes": 0}),
        ("pod-names", {"pods": 65, "kind": "Deployment"}),
        ("pod-clones", {"pods": 65, "kind": "Deployment", "gc_passes": 0}),
        ("pod-names", {"pods": 0, "kind": "Deployment"}),
        ("pod-clones", {"pods": 0, "kind": "Deployment", "gc_passes": 0}),
    ]
    assert [c["meta"]["gc_passes"] for c in _children(b_expand, "pod-clones")] == [0, 0]
    # the passes that the pause defers land in validate, which counts them
    for v in _children(ew, "validate"):
        assert type(v["meta"]["gc_passes"]) is int and v["meta"]["gc_passes"] >= 0
    assert [c["meta"]["kind"] for c in _children(b_expand)] == ["StatefulSet"] * 2 + ["Job"] * 2


def test_bind_splits_placed_and_reasons(traced):
    _, roots, _, res = traced
    binds = _children(roots[0], "bind")
    assert [[c["name"] for c in _children(b)] for b in binds] == [["bind-placed", "reasons"]] * 2
    a_placed, a_reasons = _children(binds[0])
    assert (a_placed["meta"], a_reasons["meta"]) == ({"pods": 136}, {"pods": 1})
    assert [u.pod.meta.name.split("-")[0] for u in res.unscheduled] == ["huge"]


def test_group_spans_match_path_counts(traced):
    _, roots, delta, _ = traced
    groups, fallbacks = {}, {}
    for sched in _children(roots[0], "schedule"):
        kids = _children(sched)
        assert [c["name"] for c in kids[:2]] == ["setup", "signature"]
        assert {c["name"] for c in kids[2:]} == {"group"}
        for g in kids[2:]:
            route = g["meta"]["route"]
            folded = "domain" if route == "domain_affinity" else route
            groups[folded] = groups.get(folded, 0) + 1
            for f in g["meta"].get("fallback", ()):
                key = ("domain" if f == "domain_affinity" else f) + "_fallback"
                fallbacks[key] = fallbacks.get(key, 0) + 1
            names = [c["name"] for c in _children(g)]
            if route == "grouped":
                assert names == ["select.grouped"] and g["meta"]["steps"] == g["meta"]["pods"]
            else:
                assert names[0] == "trajectory" and names[-2:] == [f"select.{route}", "tail"]
                j = g["meta"]["j_steps"]
                assert j >= 8 and j & (j - 1) == 0
    counted = {k: v for k, v in delta.items()
               if k in ("sort", "domain", "scan", "micro", "grouped")}
    assert groups == counted
    assert fallbacks == {k: v for k, v in delta.items() if k.endswith("_fallback")}
    assert {"sort", "domain", "grouped"} <= set(groups)


def test_children_lie_inside_parents_exactly(traced):
    """One clock: each child's [start, start + duration_s] inside its
    parent's, and siblings one after another, in exact float arithmetic."""
    _, roots, _, _ = traced
    edges = 0
    for parent, node in _walk(roots[0]):
        kids = _children(node)
        for a, b in zip(kids, kids[1:]):
            assert a["start"] + a["duration_s"] <= b["start"]
        if parent is None:
            continue
        edges += 1
        assert node["start"] >= parent["start"], (parent["name"], node["name"])
        assert (node["start"] + node["duration_s"]
                <= parent["start"] + parent["duration_s"]), (parent["name"], node["name"])
    assert edges > 40


def test_trace_file_children_inside_parents_exactly(monkeypatch, tmp_path):
    """The OSIM_TRACE_FILE export of one simulate(): every event inside its
    parent's event, in epoch microseconds, exactly."""
    path = tmp_path / "trace.json"
    monkeypatch.setenv("OSIM_TRACE_FILE", str(path))
    ttracing.reset_trace_events()
    try:
        _traced_call("simulate")
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        ttracing.reset_trace_events()
    by_span = {e["args"]["span_id"]: e for e in events}
    inner = [e for e in events if "parent_id" in e["args"]]
    assert len(inner) == len(events) - 1 > 40
    for e in inner:
        p = by_span[e["args"]["parent_id"]]
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"], e["name"]


def test_route_split_reads_groups_and_selects(traced):
    from open_simulator_tpu_torch.tools.route_profile import route_split

    _, roots, delta, _ = traced
    split = route_split(roots[0])
    assert {r: v["groups"] for r, v in split.items() if v["groups"]} == {
        k: v for k, v in delta.items() if k in ("sort", "domain", "grouped")}
    # the grouped scan runs a step per pod: huge 1, db 3, batch 4
    assert split["grouped"]["steps"] == 8 and split["sort"]["steps"] == 0
    assert all(v["select_s"] > 0 for v in split.values())


def test_names_rng_state_and_bind_order_match_jax():
    """Names drawn before the clones, and the bind split into two passes,
    leave the pod names, the name generator's state after the call and the
    bind order as the JAX package's engine gives them."""

    def scenario(p):
        p.wl.reset_name_rng()
        sim = p.sim.Simulator(p.sim.ClusterResource(nodes=_zone_nodes(p, 6)), **p.kw)
        res = sim.run(_phase_apps(p))
        return ([(pod.meta.name, node) for pod, node in sim._bound],
                [(u.pod.meta.name, u.reason) for u in res.unscheduled], p.wl._rng.getstate())

    from open_simulator_tpu.core import workloads as jwl
    from open_simulator_tpu_torch.core import workloads as twl

    J.wl, T.wl = jwl, twl
    bound, unscheduled, _ = both(scenario)
    assert len(bound) == 143 and len(unscheduled) == 1


@pytest.mark.parametrize("where", ["pods_from_workload", "mesh"])
def test_phase_spans_open_no_stray_roots(where):
    """Outside a trace the expansion opens no span; under a mesh the slot
    threads open none, and `schedule` times the whole."""
    from open_simulator_tpu_torch.core.workloads import pods_from_workload
    from open_simulator_tpu_torch.parallel import mesh as tmesh

    if where == "pods_from_workload":
        ttracing._history.clear()
        assert len(pods_from_workload(_workload("Deployment", "d", 5))) == 5
        assert ttracing.recent_timings() == []
        return
    roots, _, _ = _traced_call("simulate", mesh=tmesh.product_mesh(2, device="cpu"))
    assert [r["name"] for r in roots] == ["simulate"]
    scheds = _children(roots[0], "schedule")
    assert len(scheds) == 2 and all(not _children(s) for s in scheds)


GPU = {"alibabacloud.com/gpu-count": "2", "alibabacloud.com/gpu-mem": "32Gi"}
SHARE = {"alibabacloud.com/gpu-mem": "4Gi", "alibabacloud.com/gpu-count": "1"}


def _gpu_nodes(n):
    """Nodes of two 16 GiB GPUs: four 4 GiB shares a GPU, 8 a node."""
    alloc = {"cpu": "16", "memory": "64Gi", "pods": "110", **GPU}
    return [{"metadata": {"name": f"g{i}", "labels": {"kubernetes.io/hostname": f"g{i}"}},
             "status": {"allocatable": dict(alloc), "capacity": dict(alloc)}} for i in range(n)]


def _share_workload(name, n):
    d = _workload("Deployment", name, n, cpu="1")
    d["spec"]["template"]["metadata"]["annotations"] = dict(SHARE)
    return d


@pytest.fixture(scope="module")
def gpu_share_call():
    """One simulate() of a GPU-share Deployment of 80 pods (the light scan)
    and a plain one of 5 (the grouped scan) on 6 nodes of 8 shares: 48 of
    the 80 place."""
    ttracing._history.clear()
    cluster = T.sim.ClusterResource(nodes=[T.Node.from_dict(d) for d in _gpu_nodes(6)])
    app = T.sim.AppResource(name="s", objects=[
        _share_workload("share", 80), _workload("Deployment", "plain", 5)])
    res = T.sim.simulate(cluster, [app], **T.kw)
    (root,) = ttracing.recent_timings()
    return root, res


def test_scan_select_names_its_gpu_dynamics(gpu_share_call):
    root, _ = gpu_share_call
    (sched,) = _children(root, "schedule")
    scans = [(g, c) for g in _children(sched, "group") for c in _children(g, "select.scan")]
    (group, select), = scans
    assert group["meta"]["route"] == "scan" and group["meta"]["pods"] == 80
    assert group["meta"]["steps"] == 80 and select["meta"] == {"dyn": ["gpu"], "kernel": 0}
    # the grouped select carries no scan counters
    assert all("meta" not in c for g in _children(sched, "group")
               for c in _children(g, "select.grouped"))


def test_bind_placed_holds_the_pods_given_a_gpu_index(gpu_share_call):
    root, res = gpu_share_call
    (bind,) = _children(root, "bind")
    placed, reasons = _children(bind)
    on_gpu = [p for st in res.node_status for p in st.pods
              if "alibabacloud.com/gpu-index" in p.meta.annotations]
    assert len(on_gpu) == 48 and all(p.meta.name.startswith("share") for p in on_gpu)
    assert placed["meta"] == {"pods": 53}
    assert reasons["meta"] == {"pods": 32}


def test_route_split_shows_each_scan_groups_dynamics(gpu_share_call):
    from open_simulator_tpu_torch.tools.route_profile import route_split

    root, _ = gpu_share_call
    split = route_split(root)
    assert split["scan"]["groups"] == 1 and split["scan"]["dyn"] == {"gpu": 1}
    assert "dyn" not in split["grouped"]


@pytest.mark.parametrize("chunk", [32, 64])
def test_chunked_scan_is_one_select(chunk):
    """A group longer than max_group_chunk runs the light scan in chunks,
    all under one select span; its group counts the steps of all of them."""
    from open_simulator_tpu_torch.core import objects as tobj
    from open_simulator_tpu_torch.ops import encode as tenc
    from open_simulator_tpu_torch.ops import fast as tfast
    from open_simulator_tpu_torch.ops import state as tstate
    from open_simulator_tpu_torch.ops.kernels import weights_array
    from open_simulator_tpu_torch.ops.tile import tile_pod_batch

    pod = tobj.Pod.from_dict({**_share_workload("share", 1)["spec"]["template"],
                              "metadata": {"name": "share", "namespace": "x",
                                           "labels": {"app": "share"},
                                           "annotations": dict(SHARE)}})
    enc = tenc.Encoder()
    enc.register_pods([pod])
    table = tenc.encode_nodes(enc, [tobj.Node.from_dict(d) for d in _gpu_nodes(6)])
    ns = tstate.node_static_from_table(enc, table, device="cpu")
    carry = tstate.carry_from_table(table, tenc.initial_selector_counts(enc, table, []),
                                    device="cpu")
    batch = tile_pod_batch(tenc.encode_pods(enc, [pod]), [100])
    ttracing._history.clear()
    with ttracing.span("chunks"):
        out = tfast.schedule_batch_fast(ns, carry, batch, weights_array(device="cpu"),
                                        max_group_chunk=chunk, device="cpu")
    (root,) = ttracing.recent_timings()
    (group,) = _children(root, "group")
    (select,) = _children(group, "select.scan")
    assert select["meta"] == {"dyn": ["gpu"], "kernel": 0} and group["meta"]["steps"] == 100
    assert int((out[1][:100] >= 0).sum()) == 48


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
