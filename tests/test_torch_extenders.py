"""Scheduler extenders, their retries and the extender wave engine on the
port (`engine/extenders.py`, `engine/extender_wave.py`,
`kernels.probe_many` / `commit_wave`, the simulator's extender path,
`call_preempt_extenders`, the capacity search's transient-retry path)
against the JAX package.

Each case runs the same cluster and workload through the JAX `simulate()`
and the port's `simulate(device="cpu")` against the same local stub
extender on 127.0.0.1 (`tools/stubs.py`), with the name RNG reset first.
Tolerance: exact. Placements (pod -> node), every unscheduled pod's reason
string and transient flag, the preemption victims, and the multiset of
HTTP requests the stub received (path and JSON body) must be identical.
The cases follow tests/test_extenders.py and tests/test_extender_wave.py
kind by kind.
"""

import copy
import json

import pytest
import torch

import open_simulator_tpu.core.objects as jobj
import open_simulator_tpu.core.workloads as jwl
import open_simulator_tpu.engine.capacity as jcap
import open_simulator_tpu.engine.simulator as jsim
import open_simulator_tpu.models.profiles as jprof
import open_simulator_tpu.resilience.faults as jfaults
import open_simulator_tpu.resilience.policy as jpolicy
import open_simulator_tpu.utils.httppool as jpool
import open_simulator_tpu_torch.core.objects as tobj
import open_simulator_tpu_torch.core.workloads as twl
import open_simulator_tpu_torch.engine.capacity as tcap
import open_simulator_tpu_torch.engine.simulator as tsim
import open_simulator_tpu_torch.models.profiles as tprof
import open_simulator_tpu_torch.resilience.faults as tfaults
import open_simulator_tpu_torch.resilience.policy as tpolicy
import open_simulator_tpu_torch.utils.httppool as tpool
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.engine import extenders as text
from open_simulator_tpu_torch.tools.stubs import StubExtender
from open_simulator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

PKGS = {
    "jax": dict(sim=jsim, obj=jobj, prof=jprof, wl=jwl, cap=jcap, faults=jfaults,
                policy=jpolicy, pool=jpool, kw={}),
    "torch": dict(sim=tsim, obj=tobj, prof=tprof, wl=twl, cap=tcap, faults=tfaults,
                  policy=tpolicy, pool=tpool, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _fresh_state():
    """Breakers, fault plans and keep-alive pools are process-wide in both
    packages: clear them around every case."""
    for m in PKGS.values():
        m["policy"].reset_breakers()
        m["faults"].uninstall_plan()
        m["pool"].reset_pools()
    yield
    for m in PKGS.values():
        m["policy"].reset_breakers()
        m["faults"].uninstall_plan()
        m["pool"].reset_pools()


@pytest.fixture
def stubs():
    made = []

    def make(behavior):
        made.append(StubExtender(behavior))
        return made[-1]

    yield make
    for s in made:
        s.close()


def nodes(n, cpu="16"):
    return [
        {"metadata": {"name": f"n{i}", "labels": {"kubernetes.io/hostname": f"n{i}"}},
         "status": {"allocatable": {"cpu": cpu, "memory": "32Gi", "pods": "110"}}}
        for i in range(n)
    ]


def workload(kind="Deployment", replicas=1, cpu="1", name="d", priority=None, extra=None):
    spec = {"containers": [{"name": "c", "image": "img",
                            "resources": {"requests": {"cpu": cpu, **(extra or {})},
                                          **({"limits": extra} if extra else {})}}]}
    if priority is not None:
        spec["priority"] = priority
    return {"kind": kind, "metadata": {"name": name, "namespace": "x"},
            "spec": {"replicas": replicas,
                     "template": {"metadata": {"labels": {"app": name}}, "spec": spec}}}


def bound_pods(n, cpu="3"):
    """Low-priority pods pre-bound on n0..n{n-1}."""
    return [{"metadata": {"name": f"low-{i}", "namespace": "p", "labels": {"app": "low"}},
             "spec": {"nodeName": f"n{i}", "priority": 0,
                      "containers": [{"name": "c", "image": "i",
                                      "resources": {"requests": {"cpu": cpu}}}]}}
            for i in range(n)]


def ext_cfg(m, url, verbs=("filter", "prioritize"), **kw):
    names = {"filter": "filter_verb", "prioritize": "prioritize_verb", "preempt": "preempt_verb"}
    return m["prof"].ExtenderConfig(url_prefix=url, **{names[v]: v for v in verbs}, **kw)


def outcome(res):
    return (
        sorted((p.meta.namespace, p.meta.name, st.node.name)
               for st in res.node_status for p in st.pods),
        sorted((u.pod.meta.namespace, u.pod.meta.name, u.reason, u.transient)
               for u in res.unscheduled),
        sorted((p.pod.meta.name, p.node, p.by) for p in res.preempted),
    )


def requests(stub_list):
    return [sorted((p, json.dumps(b, sort_keys=True)) for p, b in s.calls) for s in stub_list]


def simulate_both(node_dicts, objects, exts, pods=(), stub_list=(), plan=None):
    """simulate() through both packages; `exts` is [(url, verbs, kwargs)].
    Returns {pkg: (outcome, requests per stub)}."""
    out = {}
    for pkg, m in PKGS.items():
        m["wl"].reset_name_rng()
        m["policy"].reset_breakers()
        m["pool"].reset_pools()
        for s in stub_list:
            s.calls.clear()
        cluster = m["sim"].ClusterResource(
            nodes=[m["obj"].Node.from_dict(copy.deepcopy(d)) for d in node_dicts],
            pods=[m["obj"].Pod.from_dict(copy.deepcopy(p)) for p in pods],
        )
        cfgs = [ext_cfg(m, url, verbs, **kw) for url, verbs, kw in exts]
        apps = [m["sim"].AppResource(name="a", objects=copy.deepcopy(objects))]
        if plan is not None:
            m["faults"].install_plan(m["faults"].FaultPlan.from_dict(plan))
        try:
            res = m["sim"].simulate(cluster, apps, extenders=cfgs, **m["kw"])
        finally:
            m["faults"].uninstall_plan()
        out[pkg] = (outcome(res), requests(stub_list))
    return out


def assert_same(out):
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    return out["torch"][0]


FG = ("filter", "prioritize")
PREEMPT = ("preempt",)

# (name, stub behavior, node dicts, workload objects, bound pods, ext verbs,
#  ext kwargs, env) -- one case per kind of tests/test_extenders.py and
# tests/test_extender_wave.py that simulate() covers
CASES = [
    ("filter_changes_placement", {"allow": {"n3"}}, nodes(5), [workload(replicas=3)], (), FG, {}, {}),
    ("prioritize_changes_placement", {"scores": {"n2": 10}}, nodes(4),
     [workload(replicas=2, cpu="100m")], (), FG, {"weight": 3}, {}),
    ("filter_failed_nodes_reason", {"allow": set(), "failed": {"n0": "out of quota", "n1": "out of quota"}},
     nodes(2), [workload()], (), FG, {}, {}),
    ("extender_error_fails_pod", {"error": "backend exploded"}, nodes(2), [workload()], (), FG, {}, {}),
    ("extender_error_ignorable", {"error": "backend exploded"}, nodes(2), [workload()], (), FG,
     {"ignorable": True}, {}),
    ("managed_resources_gating", {"allow": set()}, nodes(2), [workload()], (), FG,
     {"managed_resources": ["example.com/widget"]}, {}),
    ("node_cache_capable_wire", {"allow": {"n1"}}, nodes(3), [workload()], (), FG,
     {"node_cache_capable": True}, {}),
    ("noop_many_workloads", {}, nodes(6, cpu="4"),
     [workload(replicas=9, cpu="500m"), workload(replicas=4, cpu="2", name="e")], (), FG, {}, {}),
    ("ignored_by_scheduler", {"allow": {"n1"}}, nodes(3),
     [workload(extra={"example.com/widget": "1"}, name="w")], (), ("filter",),
     {"managed_resources": ["example.com/widget"], "ignored_resources": ["example.com/widget"]}, {}),
    ("managed_resource_fit_checked", {"allow": {"n1"}}, nodes(3),
     [workload(extra={"example.com/widget": "1"}, name="w")], (), ("filter",),
     {"managed_resources": ["example.com/widget"]}, {}),
    ("preempt_vetoes_host_pick", {"preempt_allow": {"n1"}}, nodes(2, cpu="4"),
     [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT, {}, {}),
    ("preempt_meta_victims_wire", {"preempt_allow": {"n1"}}, nodes(2, cpu="4"),
     [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT,
     {"node_cache_capable": True}, {}),
    ("preempt_empty_map", {"preempt_allow": set()}, nodes(2, cpu="4"),
     [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT, {}, {}),
    ("preempt_error", {"http_error": 500}, nodes(2, cpu="4"),
     [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT, {}, {}),
    ("preempt_error_ignorable", {"http_error": 500}, nodes(2, cpu="4"),
     [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT, {"ignorable": True}, {}),
    ("preempt_interest_gating", {"preempt_allow": set()}, nodes(2, cpu="4"),
     [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT,
     {"managed_resources": ["example.com/widget"]}, {}),
    ("preempt_unknown_victim", {"preempt_raw": {"n1": {"Pods": [{"UID": "p/ghost"}], "NumPDBViolations": 0}}},
     nodes(2, cpu="4"), [workload(name="high", cpu="3", priority=100)], bound_pods(2), PREEMPT, {}, {}),
    ("preempt_podfree_node", {"preempt_raw": {"n2": {"Pods": [], "NumPDBViolations": 0}}},
     nodes(2, cpu="4") + nodes(3, cpu="1")[2:], [workload(name="high", cpu="3", priority=100)],
     bound_pods(2), PREEMPT, {}, {}),
    ("preemption_retry_honors_filter", {"allow": {"n1"}}, nodes(2, cpu="4"),
     [workload(name="low", replicas=2, cpu="3"), workload(name="high", cpu="3", priority=100)],
     (), FG, {}, {}),
    # the wave engine (StatefulSets: ordinal names), at several wave sizes
    ("wave_scores", {"scores": {"n2": 9, "n4": 3}}, nodes(5),
     [workload("StatefulSet", replicas=7, name="w")], (), FG, {}, {"OSIM_EXTENDER_WAVE": "8"}),
    ("wave_respill", {}, nodes(8, cpu="1"), [workload("StatefulSet", replicas=8, name="w")],
     (), FG, {}, {"OSIM_EXTENDER_WAVE": "8"}),
    ("wave_failures", {"allow": {"n1"}, "failed": {"n0": "quota"}}, nodes(3),
     [workload("StatefulSet", replicas=4, cpu="8", name="w")], (), FG, {}, {"OSIM_EXTENDER_WAVE": "8"}),
    ("serial_loop_failures", {"allow": {"n1"}, "failed": {"n0": "quota"}}, nodes(3),
     [workload("StatefulSet", replicas=4, cpu="8", name="w")], (), FG, {}, {"OSIM_EXTENDER_WAVE": "0"}),
    ("wave_ignorable_under_pool", {"http_error": 500}, nodes(3),
     [workload("StatefulSet", replicas=6, name="w")], (), FG, {"ignorable": True},
     # the breaker's trip point depends on thread timing: parked here
     {"OSIM_EXTENDER_WAVE": "16", "OSIM_RETRY_BASE_S": "0", "OSIM_BREAKER_THRESHOLD": "1000"}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_simulate_with_extender_matches_jax(stubs, monkeypatch, case):
    name, behavior, node_dicts, objects, pods, verbs, kw, env = case
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stub = stubs(behavior)
    got = assert_same(simulate_both(node_dicts, objects, [(stub.url, verbs, kw)], pods, [stub]))
    placed, unsched, preempted = got
    if name == "filter_changes_placement":
        assert {n for _, _, n in placed} == {"n3"} and not unsched
    elif name == "filter_failed_nodes_reason":
        assert unsched[0][2] == "0/2 nodes are available: 2 node(s) out of quota."
    elif name == "managed_resources_gating":
        assert not stub.calls and not unsched
    elif name == "preempt_vetoes_host_pick":
        assert [(v, n) for v, n, _ in preempted] == [("low-1", "n1")]
    elif name == "preempt_unknown_victim":
        assert "not found on node" in unsched[0][2]


def test_unreachable_ignorable_extender():
    """A dead ignorable endpoint (connection refused) is skipped."""
    out = simulate_both(nodes(2), [workload()],
                        [("http://127.0.0.1:9", FG, {"ignorable": True, "http_timeout_s": 0.5})])
    assert not assert_same(out)[1]


def test_two_extenders_chain_in_order(stubs):
    """A non-ignorable and an ignorable extender: the ignorable one runs
    last, whatever the config order, and failedNodes attribution is
    first-wins."""
    a = stubs({"allow": {"n1", "n2"}, "failed": {"n0": "first"}})
    b = stubs({"allow": {"n2"}, "failed": {"n1": "second"}, "scores": {"n2": 5}})
    out = simulate_both(nodes(3), [workload(replicas=3, cpu="6")],
                        [(b.url, FG, {"ignorable": True}), (a.url, FG, {})], stub_list=[a, b])
    assert assert_same(out)[1]


def test_fault_plan_keyed_and_deterministic(stubs, monkeypatch):
    """A probabilistic keyed fault plan on the filter verb: both packages
    inject into the same pods, with the same reasons, at wave 16 and pool 8
    as on the serial loop."""
    monkeypatch.setenv("OSIM_RETRY_BASE_S", "0")
    monkeypatch.setenv("OSIM_BREAKER_THRESHOLD", "1000")
    stub = stubs({})
    plan = {"seed": 7, "rules": [{"target": "extender", "op": "filter",
                                   "kind": "connection_error", "probability": 0.5}]}
    outs = []
    for pool, wave in (("8", "16"), ("1", "0")):
        monkeypatch.setenv("OSIM_EXTENDER_POOL", pool)
        monkeypatch.setenv("OSIM_EXTENDER_WAVE", wave)
        outs.append(assert_same(simulate_both(
            nodes(4), [workload("StatefulSet", replicas=12, name="w")], [(stub.url, FG, {})],
            stub_list=[stub], plan=plan)))
    assert outs[0] == outs[1]
    assert any(u[3] for u in outs[0][1])   # some pods failed transiently


def test_breaker_fail_fast_under_pool(stubs, monkeypatch):
    """A dead non-ignorable extender trips its breaker; later chains fail
    fast without HTTP (pool width 1, so the trip order is deterministic)."""
    monkeypatch.setenv("OSIM_RETRY_BASE_S", "0")
    monkeypatch.setenv("OSIM_EXTENDER_POOL", "1")
    monkeypatch.setenv("OSIM_EXTENDER_WAVE", "64")
    stub = stubs({"http_error": 500})
    _, unsched, _ = assert_same(simulate_both(
        nodes(4), [workload("StatefulSet", replicas=20, name="w")], [(stub.url, FG, {})],
        stub_list=[stub]))
    assert len(unsched) == 20 and any("failing fast" in u[2] for u in unsched)
    assert len(stub.calls) < 20 * 3


def _capacity_both(stub, plan=None, env=None):
    template = {"metadata": {"name": "new", "labels": {"kubernetes.io/hostname": "new"}},
                "status": {"allocatable": {"cpu": "8", "memory": "32Gi", "pods": "110"}}}
    out = {}
    for pkg, m in PKGS.items():
        m["wl"].reset_name_rng()
        m["policy"].reset_breakers()
        m["pool"].reset_pools()
        stub.calls.clear()
        if plan is not None:
            m["faults"].install_plan(m["faults"].FaultPlan.from_dict(plan))
        try:
            p = m["cap"].plan_capacity(
                m["sim"].ClusterResource(nodes=[m["obj"].Node.from_dict(d) for d in nodes(2)]),
                [m["sim"].AppResource(name="a", objects=[workload(replicas=4, cpu="4")])],
                m["obj"].Node.from_dict(copy.deepcopy(template)),
                extenders=[ext_cfg(m, stub.url)], **m["kw"],
            )
        finally:
            m["faults"].uninstall_plan()
        out[pkg] = ((p.nodes_added, p.attempts, p.retries, p.batched_calls), outcome(p.result),
                    requests([stub]))
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_capacity_plan_honors_extender(stubs):
    """The capacity search runs every probe through the extender chain: an
    extender that admits only the clones forces nodes for every pod."""
    stub = stubs({"allow": {f"simon-{i:05d}" for i in range(16)}})
    (added, attempts, retries, batched), (placed, unsched, _), _ = _capacity_both(stub)
    assert added >= 2 and not unsched and retries == 0 and batched == 0
    assert all(n.startswith("simon-") for _, _, n in placed)


def test_capacity_plan_retries_transient_trial(stubs, monkeypatch):
    """One transient extender blip (each pod's first three filter calls
    refused: the extender's own retries run out) fails the first probe
    transiently; the search re-runs that probe once, so retries == 1."""
    monkeypatch.setenv("OSIM_RETRY_BASE_S", "0")
    monkeypatch.setenv("OSIM_BREAKER_THRESHOLD", "1000")
    stub = stubs({"allow": {f"simon-{i:05d}" for i in range(16)}})
    plan = {"seed": 1, "rules": [{"target": "extender", "op": "filter",
                                   "kind": "connection_error", "times": 3}]}
    (added, attempts, retries, _), (_, unsched, _), _ = _capacity_both(stub, plan)
    assert retries == 1 and added >= 2 and not unsched


def test_probe_many_and_commit_wave_match_serial_step():
    """kernels.probe_many equals probe_step pod by pod; commit_wave with
    the masks probed at the wave-start carry commits the first pod and
    respills from the first pod whose live mask changed."""
    from open_simulator_tpu_torch.ops import kernels as k
    from open_simulator_tpu_torch.ops.encode import Encoder, encode_nodes, encode_pods
    from open_simulator_tpu_torch.ops.state import (carry_from_table, node_static_from_table,
                                                    pod_rows_from_batch)

    enc = Encoder()
    table = encode_nodes(enc, [tobj.Node.from_dict(d) for d in nodes(3, cpu="1")])
    wl = tsim.pods_from_workload(workload("StatefulSet", replicas=3, cpu="1", name="w"))
    batch = encode_pods(enc, wl)
    ns = node_static_from_table(enc, table, device="cpu")
    carry = carry_from_table(table, device="cpu")
    rows = pod_rows_from_batch(batch, device="cpu")
    w = k.weights_array(device="cpu")
    mask, score, ff = k.probe_many(ns, carry, rows, w)
    for i in range(3):
        m1, s1, f1 = k.probe_step(ns, carry, k.PodRow(*(a[i] for a in rows)), w)
        assert torch.equal(mask[i], m1) and torch.equal(score[i], s1) and torch.equal(ff[i], f1)
    P = rows.req.shape[0]
    allowed = torch.ones_like(mask)
    zero = torch.zeros(mask.shape, dtype=torch.float32)
    want = torch.arange(P) < 3
    new_carry, nodes_out, respill, *_ = k.commit_wave(ns, carry, rows, w, mask, ff, allowed, zero, want)
    assert nodes_out[0].item() == 0 and not respill[0]
    assert respill[1:3].all() and (nodes_out[1:] == -1).all()
    ref_carry, *_ = k.commit_step(ns, carry, k.PodRow(*(a[0] for a in rows)),
                                  torch.tensor(0, dtype=torch.int32))
    for f in k.Carry._fields:
        assert torch.equal(getattr(new_carry, f), getattr(ref_carry, f)), f


def test_build_extenders_order_and_interest():
    """Ignorable extenders move to the tail (factory.go:111-113); a pod
    naming a managed resource only under limits is still interesting."""
    cfgs = [tprof.ExtenderConfig(url_prefix=u, filter_verb="f", ignorable=ig)
            for u, ig in (("http://a", True), ("http://b", False), ("http://c", True), ("http://d", False))]
    assert [e.base for e in text.build_extenders(cfgs)] == ["http://b", "http://d", "http://a", "http://c"]
    ext = text.HTTPExtender(tprof.ExtenderConfig(url_prefix="http://x", filter_verb="filter",
                                                 managed_resources=["example.com/widget"]))
    limits_only = tobj.Pod.from_dict({"metadata": {"name": "p", "namespace": "d"}, "spec": {
        "containers": [{"name": "c", "resources": {"limits": {"example.com/widget": "1"}}}]}})
    plain = tobj.Pod.from_dict({"metadata": {"name": "q", "namespace": "d"},
                                "spec": {"containers": [{"name": "c"}]}})
    assert ext.is_interested(limits_only) and not ext.is_interested(plain)


def test_fault_rules_of_unported_targets_name_their_item():
    """No target is unported any more: `admission` (the server's) loads like
    the durability and resident targets, in every kind it takes."""
    for target, kind in (("device", "device_lost"), ("journal", "kill"), ("backend", "error"),
                         ("resident", "torn_delta"), ("admission", "error"),
                         ("admission", "queue_full"), ("admission", "slow_drain"),
                         ("admission", "deadline_storm")):
        plan = tfaults.FaultPlan.from_dict({"rules": [{"target": target, "kind": kind}]})
        assert [r.target for r in plan.rules] == [target]


def test_extender_wave_metrics_move(stubs, monkeypatch):
    """The wave engine's respill counter and wave-size histogram move."""
    monkeypatch.setenv("OSIM_EXTENDER_WAVE", "8")
    stub = stubs({})
    before = tmetrics.EXTENDER_WAVE_RESPILL.value()
    _, _, n0 = tmetrics.EXTENDER_WAVE_SIZE.child_state()
    simulate_both(nodes(8, cpu="1"), [workload("StatefulSet", replicas=8, name="w")],
                  [(stub.url, FG, {})], stub_list=[stub])
    assert tmetrics.EXTENDER_WAVE_RESPILL.value() > before
    assert tmetrics.EXTENDER_WAVE_SIZE.child_state()[2] > n0


def _phase_run(m, stub):
    m["wl"].reset_name_rng()
    stub.calls.clear()
    res = sc.extender_simulate(m["sim"], m["obj"], m["prof"], stub.url, **m["kw"])
    return sc.result_digest(res), stub.verb_counts()


def _phase_capacity(m, stub):
    m["wl"].reset_name_rng()
    stub.calls.clear()
    m["faults"].install_plan(m["faults"].FaultPlan.from_dict(sc.EXTENDER_FAULT_PLAN))
    try:
        plan = sc.extender_capacity(m["sim"], m["obj"], m["prof"], m["cap"], stub.url, **m["kw"])
    finally:
        m["faults"].uninstall_plan()
    return (plan.nodes_added, plan.attempts, plan.retries, sc.result_digest(plan.result),
            stub.verb_counts())


def test_extender_phase_simulate_equals_constant():
    """chip_smoke.py's extender simulate() (two full waves of 64 and a
    preemption through the preempt verb) on the port's CPU path gives
    sim_configs.EXTENDER_DIGESTS["simulate"], the JAX package's answer."""
    stub = StubExtender(sc.EXTENDER_BEHAVIOR)
    try:
        assert _phase_run(PKGS["torch"], stub) == sc.EXTENDER_DIGESTS["simulate"]
    finally:
        stub.close()


@pytest.mark.slow
def test_extender_phase_constants_equal_jax(monkeypatch):
    """The JAX package recomputes EXTENDER_DIGESTS; the port's capacity
    search with the transient blip reproduces its entry (retries == 1)."""
    monkeypatch.setenv("OSIM_RETRY_BASE_S", "0")
    monkeypatch.setenv("OSIM_BREAKER_THRESHOLD", "1000")
    stub = StubExtender(sc.EXTENDER_BEHAVIOR)
    cstub = StubExtender(sc.EXTENDER_CAPACITY_BEHAVIOR)
    try:
        assert _phase_run(PKGS["jax"], stub) == sc.EXTENDER_DIGESTS["simulate"]
        for pkg in ("jax", "torch"):
            assert _phase_capacity(PKGS[pkg], cstub) == sc.EXTENDER_DIGESTS["capacity"]
    finally:
        stub.close()
        cstub.close()


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
