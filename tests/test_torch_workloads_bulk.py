"""Replica expansion in bulk on the port (core/workloads.py): the n - 1 pod
names drawn in one read of the name stream (`_rand_suffixes`) and the
clones built without `__init__` (`_clone_pods`) with the cyclic collector
held off (`_collector_paused`).

Names: the bulk draw equals `_rand_suffix` drawn one name at a time, for
counts that the first read covers and counts that it has to top up, and
leaves the generator in the state those draws leave; an app of every kind
expands to the names of per-name draws, and of the JAX package. Clones:
equal to the `dataclasses.replace` clone the port built before, with every
field stored, each per-clone dict fresh, the spec structures shared, and
one row signature for all. Collector: restored after an exception, and left disabled where
the caller disabled it. Tolerance: exact equality throughout.
"""

import dataclasses
import gc

import pytest

from open_simulator_tpu_torch.core import workloads as wl
from open_simulator_tpu_torch.core.objects import Node, ObjectMeta, Pod


def _per_name(count):
    return [wl._rand_suffix() for _ in range(count)]


def _replace_clone(proto: Pod, name: str) -> Pod:
    """The clone as the port built it before: two `dataclasses.replace`."""
    raw = dict(proto.raw)
    raw_meta = dict(raw.get("metadata") or {})
    raw_meta["name"] = name
    raw["metadata"] = raw_meta
    meta = dataclasses.replace(
        proto.meta, name=name, labels=dict(proto.meta.labels),
        annotations=dict(proto.meta.annotations),
    )
    return dataclasses.replace(
        proto, meta=meta, requests=dict(proto.requests), limits=dict(proto.limits), raw=raw,
    )


def _reads(monkeypatch):
    """Count the `getrandbits` reads of the name stream."""
    calls = []
    real = wl._rng.getrandbits

    def counting(k):
        calls.append(k)
        return real(k)

    monkeypatch.setattr(wl._rng, "getrandbits", counting)
    return calls


@pytest.mark.parametrize("count", [0, 1, 2, 35, 1000, 38249])
def test_bulk_names_equal_per_name_draws(count, monkeypatch):
    wl.reset_name_rng()
    want = _per_name(count)
    want_next = wl._rand_suffix()
    want_state = wl._rng.getstate()
    wl.reset_name_rng()
    reads = _reads(monkeypatch)
    got = wl._rand_suffixes(count)
    bulk_reads = len(reads)
    assert got == want
    assert wl._rand_suffix() == want_next
    assert wl._rng.getstate() == want_state
    # 0 draws nothing; the largest counts always top up their first read
    assert bulk_reads == 0 if count == 0 else bulk_reads >= 1
    if count >= 1000:
        assert bulk_reads >= 2


def test_bulk_names_topped_up_at_small_counts(monkeypatch):
    """Over counts 1..200 from several stream positions, some first reads
    fall short and are topped up, and each count still matches."""
    reads = _reads(monkeypatch)
    topped = 0
    for start in range(3):
        for count in range(1, 201):
            wl.reset_name_rng()
            _per_name(start)
            want = _per_name(count)
            state = wl._rng.getstate()
            wl.reset_name_rng()
            _per_name(start)
            del reads[:]
            assert wl._rand_suffixes(count) == want
            assert wl._rng.getstate() == state
            topped += len(reads) > 1
    assert topped > 0


def test_bulk_names_reset():
    wl._rand_suffixes(500)
    wl.reset_name_rng()
    first = wl._rand_suffix()
    wl.reset_name_rng()
    assert wl._rand_suffixes(1) == [first]


def _container(cpu="100m"):
    return {"name": "c", "image": "x", "resources": {"requests": {"cpu": cpu, "memory": "64Mi"},
                                                     "limits": {"cpu": cpu}}}


def _template(app, **spec):
    return {"metadata": {"labels": {"app": app}, "annotations": {"note": app}},
            "spec": {"containers": [_container()], **spec}}


_AFFINITY = {"podAntiAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
    {"weight": 10, "podAffinityTerm": {"labelSelector": {"matchLabels": {"app": "web"}},
                                        "topologyKey": "kubernetes.io/hostname"}}]}}
_TOLERATIONS = [{"key": "pool", "operator": "Equal", "value": "web", "effect": "NoSchedule"}]
_SPREAD = [{"maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": {"matchLabels": {"app": "web"}}}]


def _mixed_app():
    web = {"apiVersion": "apps/v1", "kind": "Deployment",
           "metadata": {"name": "web", "namespace": "shop"},
           "spec": {"replicas": 40, "template": _template(
               "web", affinity=_AFFINITY, tolerations=_TOLERATIONS,
               topologySpreadConstraints=_SPREAD, nodeSelector={"pool": "web"},
               containers=[dict(_container(), ports=[{"containerPort": 80, "hostPort": 8080}])])}}
    db = {"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": {"name": "db"},
          "spec": {"replicas": 5, "template": _template("db")}}
    agent = {"apiVersion": "apps/v1", "kind": "DaemonSet", "metadata": {"name": "agent"},
             "spec": {"template": _template("agent")}}
    bare = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "bare"},
            "spec": {"containers": [_container()]}}
    cron = {"apiVersion": "batch/v1", "kind": "CronJob", "metadata": {"name": "nightly"},
            "spec": {"jobTemplate": {"spec": {"completions": 9, "template": _template("cron")}}}}
    job = {"apiVersion": "batch/v1", "kind": "Job", "metadata": {"name": "once"},
           "spec": {"completions": 3, "template": _template("job")}}
    return [web, db, agent, bare, cron, job, dict(web, metadata={"name": "web2"})]


def _nodes(node_cls):
    return [node_cls.from_dict({"metadata": {"name": f"n{i}", "labels": {"pool": "web"}},
                                "status": {"allocatable": {"cpu": "8", "memory": "16Gi",
                                                           "pods": "110"}}})
            for i in range(4)]


def _expand(module, node_cls):
    module.reset_name_rng()
    nodes = _nodes(node_cls)
    pods = [p for obj in _mixed_app() for p in module.pods_from_workload(obj, nodes=nodes)]
    return pods, module._rng.getstate()


def test_mixed_app_names_equal_per_name_draws(monkeypatch):
    got, got_state = _expand(wl, Node)
    monkeypatch.setattr(wl, "_rand_suffixes", _per_name)
    monkeypatch.setattr(wl, "_clone_pods", lambda proto, names: [
        _replace_clone(proto, name) for name in names])
    want, want_state = _expand(wl, Node)
    assert [p.meta.name for p in got] == [p.meta.name for p in want]
    assert got == want
    assert got_state == want_state
    assert len(got) == 40 + 5 + 4 + 1 + 9 + 3 + 40


def test_mixed_app_names_equal_jax_package():
    from open_simulator_tpu.core import workloads as jwl
    from open_simulator_tpu.core.objects import Node as JNode

    got, got_state = _expand(wl, Node)
    want, want_state = _expand(jwl, JNode)
    assert [p.meta.name for p in got] == [p.meta.name for p in want]
    assert got_state == want_state


@pytest.fixture
def proto():
    wl.reset_name_rng()
    (pod,) = wl.pods_from_workload(dict(_mixed_app()[0], spec=dict(
        _mixed_app()[0]["spec"], replicas=1)))
    return pod


def test_clones_equal_replace_clones(proto):
    names = ["web-a", "web-b", "web-c"]
    clones = wl._clone_pods(proto, names)
    assert clones == [_replace_clone(proto, name) for name in names]
    assert [type(c) for c in clones] == [Pod] * 3
    # every field stored, and nothing else
    assert {tuple(vars(c)) for c in clones} == {tuple(f.name for f in dataclasses.fields(Pod))}
    assert {tuple(vars(c.meta)) for c in clones} == {
        tuple(f.name for f in dataclasses.fields(ObjectMeta))}
    assert [c.meta.name for c in clones] == names
    assert [c.raw["metadata"]["name"] for c in clones] == names
    assert proto.meta.name.startswith("web-") and proto.meta.name not in names
    assert wl._clone_pods(proto, []) == []


def test_clone_dicts_fresh(proto):
    before = _replace_clone(proto, proto.meta.name)
    a, b = wl._clone_pods(proto, ["web-a", "web-b"])
    for pod in (a, b):
        assert pod.meta is not proto.meta
        for field in ("labels", "annotations"):
            assert getattr(pod.meta, field) is not getattr(proto.meta, field)
        for field in ("requests", "limits", "raw"):
            assert getattr(pod, field) is not getattr(proto, field)
        assert pod.raw["metadata"] is not proto.raw["metadata"]
    a.meta.labels["x"] = "1"
    a.meta.annotations["x"] = "1"
    a.requests["cpu"] = 1
    a.limits["cpu"] = 1
    a.raw["x"] = 1
    a.raw["metadata"]["x"] = 1
    a.meta.name = "renamed"
    assert proto == before
    assert b == _replace_clone(proto, "web-b")


def test_clone_spec_structures_shared(proto):
    from open_simulator_tpu_torch.ops.encode import _pod_row_sig

    clones = wl._clone_pods(proto, ["web-a", "web-b"])
    for pod in clones:
        for field in ("affinity", "tolerations", "spread_constraints", "host_ports",
                      "node_selector", "pvc_names"):
            assert getattr(pod, field) is getattr(proto, field)
    assert proto.host_ports and proto.tolerations and proto.spread_constraints
    assert _pod_row_sig(clones[0]) == _pod_row_sig(clones[1]) == _pod_row_sig(proto)


def _failing_clones(seen):
    def clone(proto, names):
        seen.append(gc.isenabled())
        raise RuntimeError("boom")
    return clone


def test_collector_restored_after_exception(monkeypatch):
    """A clone loop that raises leaves the collector as it found it."""
    assert gc.isenabled()
    seen = []
    monkeypatch.setattr(wl, "_clone_pods", _failing_clones(seen))
    with pytest.raises(RuntimeError, match="boom"):
        wl.pods_from_workload(_mixed_app()[0])
    assert seen == [False]
    assert gc.isenabled()


def test_collector_left_disabled(monkeypatch):
    seen = []
    gc.disable()
    try:
        wl.pods_from_workload(_mixed_app()[0])
        assert not gc.isenabled()
        monkeypatch.setattr(wl, "_clone_pods", _failing_clones(seen))
        with pytest.raises(RuntimeError, match="boom"):
            wl.pods_from_workload(_mixed_app()[0])
        assert not gc.isenabled()
    finally:
        gc.enable()
    assert seen == [False]


def test_paused_clone_loop_runs_no_collector_pass():
    from open_simulator_tpu_torch.utils.tracing import gc_passes

    wl.reset_name_rng()
    web = dict(_mixed_app()[0], spec=dict(_mixed_app()[0]["spec"], replicas=1))
    (proto,) = wl.pods_from_workload(web)
    names = [f"web-{i}" for i in range(20000)]
    with wl._collector_paused():
        before = gc_passes()
        clones = wl._clone_pods(proto, names)
        assert gc_passes() == before
    assert gc.isenabled()
    assert clones == [_replace_clone(proto, name) for name in names]
