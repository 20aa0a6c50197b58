"""Trace identity on the port (utils/tracing.py TraceContext and its
plumbing) against the JAX package's, on the CPU: the traceparent cases of
tests/test_trace_propagation.py (round trip, invalid headers, no context
outside a trace, activation on another thread, the pack span's parent and
links, the loop thread, an untraced submit, the server continuing an
incoming trace and echoing its id) and its extender cases, which now see a
`traceparent` header on both transports. Tolerance: headers, parent ids and
link sets equal exactly; each case runs through both packages.
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
