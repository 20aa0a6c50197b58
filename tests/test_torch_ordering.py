"""The port's pod-ordering queues (core/ordering.py) against the JAX
package's, on the cases of tests/test_ordering.py and on seeded pod mixes:
the same node and pod dicts go through each package's objects, and the
orders, shares and totals must be equal. `use_greed` end to end compares
the port's simulate() on the CPU with the JAX simulate() by result digest.
Tolerance: exact."""

import numpy as np
import pytest
import torch

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import ordering as jord
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu_torch import sim_configs
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import ordering as tord
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import simulator as tsim

torch.set_num_threads(1)  # tiny tensors: threads only add contention


def node_dict(name, cpu="10", mem="100Gi"):
    return {
        "metadata": {"name": name},
        "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}},
    }


def pod_dict(name, cpu=None, mem=None, selector=None, tolerations=None, node=""):
    req = {}
    if cpu:
        req["cpu"] = cpu
    if mem:
        req["memory"] = mem
    spec = {"containers": [{"name": "c", "image": "img", "resources": {"requests": req}}]}
    if selector:
        spec["nodeSelector"] = selector
    if tolerations:
        spec["tolerations"] = tolerations
    if node:
        spec["nodeName"] = node
    return {"metadata": {"name": name, "namespace": "d"}, "spec": spec}


def both(node_dicts, pod_dicts):
    """((JAX nodes, JAX pods), (port nodes, port pods)) from the same dicts."""
    return tuple(
        ([objs.Node.from_dict(d) for d in node_dicts], [objs.Pod.from_dict(d) for d in pod_dicts])
        for objs in (jobj, tobj)
    )


def names(pods):
    return [p.meta.name for p in pods]


TOL = [{"key": "k", "operator": "Exists"}]

# (node dicts, pod dicts, function, expected names) per tests/test_ordering.py case
CASES = {
    "greed_sort": (
        [node_dict("n")],
        [pod_dict("small", cpu="1"), pod_dict("big", cpu="5"),
         pod_dict("pinned", cpu="1", node="n"), pod_dict("mid", cpu="3")],
        lambda mod, nodes, pods: mod.greed_sort(pods, nodes),
        ["pinned", "big", "mid", "small"],
    ),
    "affinity_sort": (
        [], [pod_dict("plain", cpu="1"), pod_dict("sel", cpu="1", selector={"zone": "a"})],
        lambda mod, nodes, pods: mod.affinity_sort(pods), ["sel", "plain"],
    ),
    "toleration_sort": (
        [], [pod_dict("plain", cpu="1"), pod_dict("tol", cpu="1", tolerations=TOL)],
        lambda mod, nodes, pods: mod.toleration_sort(pods), ["tol", "plain"],
    ),
    "order_pods": (
        [node_dict("n")],
        [pod_dict("big-plain", cpu="4"), pod_dict("big-tol", cpu="5", tolerations=TOL),
         pod_dict("small-plain", cpu="2"), pod_dict("small-tol", cpu="1", tolerations=TOL)],
        lambda mod, nodes, pods: mod.order_pods(pods, nodes),
        ["big-tol", "small-tol", "big-plain", "small-plain"],
    ),
    "order_pods_greed": (
        [node_dict("n")],
        [pod_dict("small-tol", cpu="1", tolerations=TOL), pod_dict("small-plain", cpu="2"),
         pod_dict("big-tol", cpu="5", tolerations=TOL), pod_dict("big-plain", cpu="4")],
        lambda mod, nodes, pods: mod.order_pods(pods, nodes, use_greed=True),
        ["big-tol", "small-tol", "big-plain", "small-plain"],
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ordering_cases_match_jax(case):
    node_dicts, pod_dicts, fn, want = CASES[case]
    (jn, jp), (tn, tp) = both(node_dicts, pod_dicts)
    assert names(fn(tord, tn, tp)) == names(fn(jord, jn, jp)) == want


@pytest.mark.parametrize("alloc,total,want", [(0, 0, 0.0), (5, 0, 1.0), (5, 10, 0.5)])
def test_share_matches_jax(alloc, total, want):
    assert tord.share(alloc, total) == jord.share(alloc, total) == want


@pytest.mark.parametrize("pod,want", [
    (pod_dict("p", cpu="2", mem="10Gi"), 0.2),  # 2/10 cpu vs 10/100 mem: cpu dominates
    (pod_dict("m", cpu="1", mem="50Gi"), 0.5),
    (pod_dict("empty"), 0.0),
])
def test_dominant_share_matches_jax(pod, want):
    (jn, jp), (tn, tp) = both([node_dict("n", cpu="10", mem="100Gi")], [pod])
    jt, tt = jord.cluster_totals(jn), tord.cluster_totals(tn)
    assert tt == jt
    assert tord.pod_dominant_share(tp[0], tt) == jord.pod_dominant_share(jp[0], jt) == want


def seeded_mix(seed, n=60):
    """Nodes and pods with seeded requests, selectors, tolerations and pins."""
    rng = np.random.default_rng(seed)
    nodes = [node_dict(f"n-{i}", cpu=str(int(rng.integers(4, 33))),
                       mem=f"{int(rng.integers(8, 129))}Gi") for i in range(5)]
    pods = []
    for i in range(n):
        cpu = f"{int(rng.integers(1, 4000))}m" if rng.random() < 0.9 else None
        mem = f"{int(rng.integers(1, 8192))}Mi" if rng.random() < 0.9 else None
        pods.append(pod_dict(
            f"p-{i}", cpu=cpu, mem=mem,
            selector={"zone": "a"} if rng.random() < 0.3 else None,
            tolerations=TOL if rng.random() < 0.3 else None,
            node=f"n-{int(rng.integers(0, 5))}" if rng.random() < 0.1 else "",
        ))
    return nodes, pods


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("use_greed", [False, True])
def test_seeded_order_matches_jax(seed, use_greed):
    (jn, jp), (tn, tp) = both(*seeded_mix(seed))
    assert names(tord.order_pods(tp, tn, use_greed=use_greed)) == names(
        jord.order_pods(jp, jn, use_greed=use_greed))
    assert names(tord.greed_sort(tp, tn)) == names(jord.greed_sort(jp, jn))
    jt, tt = jord.cluster_totals(jn), tord.cluster_totals(tn)
    assert tt == jt
    assert [tord.pod_dominant_share(p, tt) for p in tp] == [
        jord.pod_dominant_share(p, jt) for p in jp]


def test_use_greed_end_to_end_matches_jax():
    dep = {
        "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "d"},
        "spec": {
            "replicas": 3,
            "template": {"spec": {"containers": [
                {"name": "c", "image": "img", "resources": {"requests": {"cpu": "1"}}}]}},
        },
    }
    digests = []
    for objs, sim, wl, kw in ((jobj, jsim, jwl, {}), (tobj, tsim, twl, {"device": "cpu"})):
        wl.reset_name_rng()
        cluster = sim.ClusterResource(nodes=[objs.Node.from_dict(node_dict("w", "8", "16Gi"))])
        result = sim.simulate(cluster, [sim.AppResource("a", [dep])], use_greed=True, **kw)
        assert not result.unscheduled
        digests.append(sim_configs.result_digest(result))
    assert digests[0] == digests[1]
