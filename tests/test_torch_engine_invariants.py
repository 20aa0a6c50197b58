"""Engine-level invariant fuzz over the port's simulate(): the counterpart of
tests/test_invariants.py.

The same randomized clusters (priorities, PDBs, taints, selectors,
anti-affinity; the reference's seeds and trial counts) run through the
port's `simulate()` on the CPU, and each result must be physically valid by
the port's own predicates (core/matcher.py):

  1. conservation: placed + unscheduled + preempted == expected
  2. no overcommit: per-node cpu/mem/pod-count within allocatable
  3. placement legality: every placed pod tolerates its node's NoSchedule
     taints and matches its nodeSelector and node affinity
  4. eviction accounting: preempted pods are unbound, and no pod is both
     placed and unscheduled

and equal to the JAX `simulate()` on the same inputs (sim_configs
.result_digest: placements, reasons, victims, storage). Tolerance: exact.
"""

import random

import pytest
import torch

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.core.workloads import expected_pod_counts
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.models.profiles import ExtenderConfig as JExtender
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.core.matcher import match_node_affinity, untolerated_taint
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.models.profiles import ExtenderConfig as TExtender
from tests.factories import (
    make_daemonset,
    make_deployment,
    make_job,
    make_statefulset,
    taint,
    toleration,
)

torch.set_num_threads(1)  # tiny tensors: threads only add contention


def _node(name, cpu, memory, pods, labels, taints):
    """tests/factories.make_node's dict."""
    res = {"cpu": cpu, "memory": memory, "pods": pods}
    return {
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name, **labels},
                     "annotations": {}},
        "spec": {"taints": taints or []},
        "status": {"allocatable": dict(res), "capacity": dict(res)},
    }


def _rand_cluster(rng):
    """The reference test's _rand_cluster, as plain dicts (the same draws)."""
    nodes = []
    for i in range(rng.randint(2, 8)):
        labels = {}
        if rng.random() < 0.5:
            labels["pool"] = rng.choice(["a", "b"])
        nodes.append(_node(
            f"n{i}", cpu=str(rng.choice([2, 4, 8])), memory=f"{rng.choice([4, 8, 16])}Gi",
            pods=str(rng.choice([5, 110])), labels=labels,
            taints=[taint("ded", "x")] if rng.random() < 0.3 else None,
        ))
    return nodes


def _rand_workloads(rng, n):
    """The reference test's _rand_workloads (the same draws)."""
    objs = []
    for w in range(n):
        opts = dict(cpu=rng.choice(["250m", "500m", "1", "2"]),
                    memory=rng.choice(["256Mi", "1Gi"]), namespace="inv")
        if rng.random() < 0.4:
            opts["with_tolerations"] = [toleration("ded", operator="Exists")]
        if rng.random() < 0.3:
            opts["with_node_selector"] = {"pool": rng.choice(["a", "b"])}
        if rng.random() < 0.3:
            opts["with_priority"] = rng.choice([0, 10, 100])
        if rng.random() < 0.2:
            opts["with_affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {"matchLabels": {"app": f"w{w}"}},
                    "topologyKey": "kubernetes.io/hostname",
                }]}}
        kind = rng.choice(["Deployment", "StatefulSet", "Job"])
        if kind == "Deployment":
            objs.append(make_deployment(f"w{w}", replicas=rng.randint(1, 6), **opts))
        elif kind == "StatefulSet":
            objs.append(make_statefulset(f"w{w}", replicas=rng.randint(1, 6), **opts))
        else:
            objs.append(make_job(f"w{w}", completions=rng.randint(1, 6), parallelism=2,
                                 **opts))
    pdbs = []
    if rng.random() < 0.4:
        pdbs.append({
            "kind": "PodDisruptionBudget",
            "metadata": {"name": "pdb", "namespace": "inv"},
            "spec": {"minAvailable": rng.randint(0, 2),
                     "selector": {"matchLabels": {"app": "w0"}}},
        })
    return objs, pdbs


def _run(pkg, nodes, objs, pdbs, daemonsets=(), extenders=None):
    """simulate() of one package on fresh objects built from the dicts."""
    objects, workloads, sim = {"jax": (jobj, jwl, jsim), "torch": (tobj, twl, tsim)}[pkg]
    workloads.reset_name_rng()
    cluster = sim.ClusterResource(
        nodes=[objects.Node.from_dict(n) for n in nodes],
        daemonsets=[dict(d) for d in daemonsets],
        others={"PodDisruptionBudget": [dict(p) for p in pdbs]},
    )
    kw = {"extenders": extenders} if extenders else {}
    if pkg == "torch":
        kw["device"] = "cpu"
    result = sim.simulate(cluster, [sim.AppResource(name="inv", objects=[dict(o) for o in objs])],
                          **kw)
    return cluster, result


def _check_invariants(jcluster, objs, cluster, result):
    # 1. conservation (preempted victims are deleted from the cluster)
    expected = expected_pod_counts(objs + jcluster.daemonsets, jcluster.nodes)
    placed = sum(len(st.pods) for st in result.node_status)
    assert placed + len(result.unscheduled) + len(result.preempted) == sum(expected.values())
    placed_keys = set()
    for st in result.node_status:
        node = st.node
        cpu = mem = 0
        for p in st.pods:
            assert p.node_name == node.name and p.phase == "Running"
            assert p.key not in placed_keys, f"double-bound {p.key}"
            placed_keys.add(p.key)
            cpu += p.requests.get("cpu", 0)
            mem += p.requests.get("memory", 0)
            # 3. placement legality
            t = untolerated_taint(p.tolerations, node)
            assert t is None or t.effect != "NoSchedule", (p.key, node.name, t)
            for k, v in p.node_selector.items():
                assert node.meta.labels.get(k) == v, (p.key, k, v)
            assert match_node_affinity(p, node), f"{p.key} affinity"
        # 2. no overcommit
        assert cpu <= node.allocatable.get("cpu", 0), (node.name, "cpu")
        assert mem <= node.allocatable.get("memory", 0), (node.name, "mem")
        assert len(st.pods) <= node.allocatable.get("pods", 1 << 30)
    # 4. eviction accounting
    for pre in result.preempted:
        assert pre.pod.key not in placed_keys
        assert pre.pod.node_name == "" and pre.pod.phase == "Pending"
    assert not ({u.pod.key for u in result.unscheduled} & placed_keys)


def _both(nodes, objs, pdbs, daemonsets=(), extenders=None):
    jcluster, jres = _run("jax", nodes, objs, pdbs, daemonsets,
                          extenders and extenders["jax"])
    cluster, res = _run("torch", nodes, objs, pdbs, daemonsets,
                        extenders and extenders["torch"])
    _check_invariants(jcluster, objs, cluster, res)
    assert sc.result_digest(res) == sc.result_digest(jres)
    return res


@pytest.mark.parametrize("trial", range(12))
def test_engine_invariants_randomized(trial):
    rng = random.Random(20260730)
    for _ in range(trial + 1):    # the reference's sequence up to this trial
        nodes = _rand_cluster(rng)
        objs, pdbs = _rand_workloads(rng, rng.randint(1, 4))
    _both(nodes, objs, pdbs)


def test_engine_invariants_with_extender(stub_factory):
    """The per-pod extender path must uphold the same invariants as the
    fused scan: a pass-through extender routes every pod through it."""
    stub = stub_factory({})   # keep all nodes, score 0
    verbs = dict(url_prefix=stub.url, filter_verb="filter", prioritize_verb="prioritize",
                 preempt_verb="preempt")
    ext = {"jax": [JExtender(**verbs)], "torch": [TExtender(**verbs)]}
    rng = random.Random(51)
    for _ in range(4):
        nodes = _rand_cluster(rng)
        objs, pdbs = _rand_workloads(rng, rng.randint(1, 3))
        _both(nodes, objs, pdbs, extenders=ext)
    assert stub.calls


def test_engine_invariants_with_cluster_daemonset():
    rng = random.Random(77)
    for _ in range(4):
        nodes = _rand_cluster(rng)
        objs, _ = _rand_workloads(rng, 2)
        ds = make_daemonset("agent", namespace="kube-system", cpu="100m", memory="64Mi",
                            with_tolerations=[{"operator": "Exists"}])
        _both(nodes, objs, [], daemonsets=[ds])
