"""The port's metrics text exposition against the JAX registry's, on the
CPU: tests/test_metrics.py's rendering cases (label escaping, a counter
that never fired, the default registry, the /metrics endpoint after a
simulated request, format compliance, the single trailing newline) and
`apply --metrics-file`; the two registries declare the same families (name,
type, labels, buckets), and `osim_fast_path_total` and
`osim_encode_stamped_rows_total` render the same after the same
schedule_batch_fast and the same stamped encode (the port of
tests/test_node_bucket.py's stamped-rows case). Tolerance: rendered text
equal byte for byte, on the metrics both packages declare.
"""

import json
import re
import threading
import types
import urllib.request

import pytest
import torch
import yaml

from open_simulator_tpu.cli.main import main as jmain
from open_simulator_tpu.server import server as jserver
from open_simulator_tpu.utils import metrics as jmetrics
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.server import server as tserver
from open_simulator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention

J = types.SimpleNamespace(metrics=jmetrics, srv=jserver, kw={})
T = types.SimpleNamespace(metrics=tmetrics, srv=tserver, kw={"device": "cpu"})

_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(\\.|[^\"\\])*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(\\.|[^\"\\])*\")*\})?"
    r" (\+Inf|-Inf|NaN|-?[0-9.e+-]+)$"
)

# the families the server, its queue and its loop increment
SERVING = (
    "osim_http_requests_total", "osim_admission_queue_depth", "osim_coalesced_batch_size",
    "osim_server_request_duration_seconds", "osim_admission_fence_total",
    "osim_loop_iteration_seconds", "osim_pack_latency_seconds", "osim_loop_fallbacks_total",
    "osim_jobs_total", "osim_requests_shed_total", "osim_requests_dropped_total",
    "osim_snapshot_stale_total",
)


def assert_valid_prometheus_text(text: str) -> None:
    assert text.endswith("\n")
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        assert _SAMPLE_RE.match(line), f"malformed sample line: {line!r}"


def families(text: str) -> dict:
    """{family name: its lines}, a family being the HELP/TYPE pair and the
    samples after it."""
    out, name = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name = line.split()[2]
            out[name] = []
        out[name].append(line)
    return out


def _increments(m):
    """The same increments on a fresh registry of package metrics module m."""
    reg = m.MetricsRegistry()
    c = reg.counter("t_total", "help with \\ and\nnewline", labelnames=("k",))
    c.inc(k='a"b\\c\nd')
    c.inc(2.5, k="plain")
    reg.counter("never_fired_total", "h")
    g = reg.gauge("depth", "g", labelnames=("q",))
    g.set(3, q="x")
    g.dec(0.5, q="x")
    h = reg.histogram("lat_seconds", "h", labelnames=("mode",), buckets=(1, 2, 4, 8))
    for v, mode in ((0.5, "fanout"), (3, "fanout"), (9, "scenarios"), (1e-9, "fanout")):
        h.observe(v, mode=mode)
    return reg


@pytest.mark.parametrize("case", ["escaping", "empty", "increments"])
def test_render_equals_jax_registry(case):
    def render(m):
        if case == "empty":
            return m.MetricsRegistry().render()
        reg = _increments(m)
        if case == "escaping":
            reg = m.MetricsRegistry()
            reg.counter("t_total", "", labelnames=("k",)).inc(k='a"b\\c\nd')
        return reg.render()

    got, want = render(tmetrics), render(jmetrics)
    assert got == want
    assert_valid_prometheus_text(got)
    if case == "escaping":
        assert 't_total{k="a\\"b\\\\c\\nd"} 1' in got
    if case == "empty":
        assert got == "\n"


def test_render_unlabeled_counter_reports_zero():
    texts = []
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        reg.counter("never_fired_total", "h")
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert "# TYPE never_fired_total counter" in texts[1]
    assert "never_fired_total 0" in texts[1]


def test_render_always_ends_with_single_newline():
    reg = tmetrics.MetricsRegistry()
    assert reg.render().endswith("\n")
    reg.counter("fmt_probe_total", "h").inc()
    out = reg.render()
    assert out.endswith("\n") and not out.endswith("\n\n")


def test_serving_metrics_declared_like_jax():
    """The serving families render byte-equal after the same increments, and
    every family both packages declare has the same type, labels and
    buckets."""
    for m in (jmetrics, tmetrics):
        m.REGISTRY.reset()  # earlier tests of this process moved them apart
        m.HTTP_REQUESTS.inc(path="/api/deploy-apps", code="200")
        m.COALESCED_BATCH.observe(4, mode="fanout")
        m.COALESCED_BATCH.observe(8, mode="scenarios")
        m.ADMISSION_FENCE.inc(outcome="rekeyed")
        m.JOBS.inc(outcome="completed")
    for name in SERVING:
        assert tmetrics.REGISTRY._metrics[name].render() == jmetrics.REGISTRY._metrics[name].render()
    shared = set(tmetrics.REGISTRY._metrics) & set(jmetrics.REGISTRY._metrics)
    assert set(SERVING) <= shared
    for name in shared:
        a, b = jmetrics.REGISTRY._metrics[name], tmetrics.REGISTRY._metrics[name]
        assert (type(a).__name__, a.labelnames, getattr(a, "buckets", None)) == (
            type(b).__name__, b.labelnames, getattr(b, "buckets", None)), name


def test_default_registry_renders_valid_text():
    assert_valid_prometheus_text(tmetrics.REGISTRY.render())


_NODE = {"kind": "Node", "metadata": {"name": "n0", "labels": {"kubernetes.io/hostname": "n0"}},
         "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"}}}
_DEPLOY = {"kind": "Deployment", "metadata": {"name": "d", "namespace": "x"},
           "spec": {"replicas": 2, "template": {"metadata": {"labels": {"app": "d"}},
                    "spec": {"containers": [{"name": "c", "image": "i",
                                             "resources": {"requests": {"cpu": "1"}}}]}}}}


def _scrape(p, body=None):
    """(deploy-apps response, /metrics status, content type, text) of one
    embedded server of package p."""
    srv = p.srv.make_server(0, **p.kw)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    out = None
    try:
        if body is not None:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/deploy-apps", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json.loads(resp.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
            return out, resp.status, resp.headers["Content-Type"], resp.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()


def test_metrics_endpoint_after_simulated_request():
    body = {"cluster": {"objects": [_NODE]}, "apps": [{"name": "a", "objects": [_DEPLOY]}]}
    jmetrics.REGISTRY.reset()
    tmetrics.REGISTRY.reset()
    _, _, jtype, jtext = _scrape(J, body)
    out, status, ctype, text = _scrape(T, body)
    assert len(out["placements"]) == 2 and status == 200 and ctype == jtype
    assert ctype.startswith("text/plain")
    assert_valid_prometheus_text(text)
    assert "# TYPE osim_e2e_scheduling_duration_seconds histogram" in text
    assert 'osim_e2e_scheduling_duration_seconds_bucket{le="+Inf"}' in text
    m = re.search(r'^osim_schedule_result_total\{result="scheduled"\} (\d+)$', text, re.M)
    assert m and int(m.group(1)) >= 2
    m = re.search(r"^osim_pod_scheduling_attempts_total (\d+)$", text, re.M)
    assert m and int(m.group(1)) >= 2
    assert 'path="/api/deploy-apps"' in text
    # the counts both servers keep (not their timings) render alike
    jf, tf = families(jtext), families(text)
    for name in ("osim_http_requests_total", "osim_schedule_result_total",
                 "osim_pod_scheduling_attempts_total", "osim_requests_shed_total",
                 "osim_requests_dropped_total", "osim_loop_fallbacks_total"):
        assert tf[name] == jf[name], name
    for name in ("osim_coalesced_batch_size", "osim_server_request_duration_seconds"):
        assert [ln for ln in tf[name] if "_count" in ln] == [ln for ln in jf[name] if "_count" in ln]


def test_metrics_exposition_format_compliance():
    _, _, ctype, text = _scrape(T)
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    assert text.endswith("\n") and not text.endswith("\n\n")
    assert_valid_prometheus_text(text)
    seen_type = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            seen_type.add(line.split()[2])
        elif line and not line.startswith("#"):
            fam = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
            base = re.sub(r"_(bucket|count|sum)$", "", fam)
            assert fam in seen_type or base in seen_type, line


def test_metrics_file_cli_flag(tmp_path, monkeypatch):
    """`simon apply --metrics-file` writes the registry snapshot as JSON, with
    the families the JAX CLI's file has for the same run."""
    monkeypatch.setenv("OSIM_COMPILE_CACHE", "")
    cfg_dir = tmp_path / "cluster"
    cfg_dir.mkdir()
    (cfg_dir / "node.yaml").write_text(yaml.safe_dump(_NODE))
    app_dir = tmp_path / "app"
    app_dir.mkdir()
    (app_dir / "deploy.yaml").write_text(yaml.safe_dump(_DEPLOY))
    cfg = {"apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "t"},
           "spec": {"cluster": {"customConfig": str(cfg_dir)},
                    "appList": [{"name": "a", "path": str(app_dir)}]}}
    cfg_path = tmp_path / "simon.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    snaps = []
    for name, run in (("jax", jmain), ("torch", cli.main)):
        metrics_path = tmp_path / f"metrics-{name}.json"
        argv = ["apply", "-f", str(cfg_path), "--output-file", str(tmp_path / f"{name}.txt"),
                "--metrics-file", str(metrics_path)]
        if name == "torch":
            argv += ["--device", "cpu"]
        (jmetrics if name == "jax" else tmetrics).REGISTRY.reset()
        assert run(argv) == 0
        snaps.append(json.loads(metrics_path.read_text()))
    jsnap, tsnap = snaps
    assert "osim_schedule_result_total" in tsnap and "osim_apply_total" in tsnap
    for name in ("osim_schedule_result_total", "osim_apply_total",
                 "osim_pod_scheduling_attempts_total"):
        assert tsnap[name]["samples"] == jsnap[name]["samples"], name


def test_registries_declare_the_same_families():
    import open_simulator_tpu_torch.ops.fast  # noqa: F401  (every declaring module loaded)

    assert set(tmetrics.REGISTRY._metrics) == set(jmetrics.REGISTRY._metrics)
    for name, a in jmetrics.REGISTRY._metrics.items():
        b = tmetrics.REGISTRY._metrics[name]
        assert (type(a).__name__, a.labelnames, getattr(a, "buckets", None)) == (
            type(b).__name__, b.labelnames, getattr(b, "buckets", None)), name


def test_fast_path_and_stamped_rows_render_like_jax():
    from open_simulator_tpu.core import objects as jobj
    from open_simulator_tpu.ops import encode as jenc
    from open_simulator_tpu.ops import fast as jfast
    from open_simulator_tpu.ops.kernels import weights_array as jax_weights
    from open_simulator_tpu_torch.core import objects as tobj
    from open_simulator_tpu_torch.ops import encode as tenc
    from open_simulator_tpu_torch.ops import fast as tfast
    from open_simulator_tpu_torch.ops.kernels import weights_array as torch_weights
    from tests.test_torch_fast import encode_both, pod_dict, spread, zone_nodes

    for m in (jmetrics, tmetrics):
        m.REGISTRY.reset()  # earlier tests of this process moved them apart
    pods = [pod_dict(name="plain"),
            pod_dict(labels={"app": "s"}, name="spread",
                     spec_extra={"topologySpreadConstraints": [
                         spread("topology.kubernetes.io/zone", 1, True, "s")]}),
            pod_dict(cpu="64", name="huge")]
    jstate, tstate = encode_both(zone_nodes(12), pods, [120, 60, 8])
    jfast.schedule_batch_fast(*jstate, jax_weights(), force_fast=True)
    tfast.schedule_batch_fast(*tstate, torch_weights(device="cpu"), force_fast=True,
                              device="cpu")
    stamped0 = tmetrics.ENCODE_STAMPED_ROWS.value()
    for objs, enc in ((jobj, jenc), (tobj, tenc)):
        nodes = [objs.Node.from_dict({
            "metadata": {"name": f"m-{i}", "labels": {"kubernetes.io/hostname": f"m-{i}"}},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"}},
        }) for i in range(10)]
        enc.encode_nodes(enc.Encoder(), nodes, stamp=True)
    for name in ("osim_fast_path_total", "osim_encode_stamped_rows_total"):
        got = tmetrics.REGISTRY._metrics[name].render()
        assert got == jmetrics.REGISTRY._metrics[name].render(), name
    assert tmetrics.ENCODE_STAMPED_ROWS.value() == stamped0 + 9  # 1 template, 9 clones
    assert tmetrics.FAST_PATH.value(path="sort") >= 1
    assert tmetrics.FAST_PATH.value(path="domain") >= 1


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
