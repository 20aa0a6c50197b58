"""The plain reference against the port's CPU path, feature by feature, and
its incremental bookkeeping against a full re-evaluation per pod."""

import copy

import numpy as np
import pytest
import torch

from simbench import program
from simbench.reference import compare, sched

ZONE = "topology.kubernetes.io/zone"
RACK = "rack"
TYPE = "node.kubernetes.io/instance-type"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _node(i, rng, gpu):
    labels = {ZONE: f"z-{i % 3}", TYPE: ["small", "large"][i % 2]}
    if rng.random() < 0.7:
        labels[RACK] = f"r-{rng.integers(4)}"
    taints = []
    if rng.random() < 0.2:
        taints.append({"key": "dedicated", "value": "batch", "effect": "NoSchedule"})
    if rng.random() < 0.2:
        taints.append({"key": "spot", "value": "yes", "effect": "PreferNoSchedule"})
    alloc = {"cpu": str(int(rng.choice([4, 8, 16]))), "memory": f"{int(rng.choice([8, 16, 32]))}Gi",
             "pods": str(int(rng.choice([6, 12, 110])))}
    if gpu:
        n = int(rng.choice([2, 4, 8]))
        alloc.update({"alibabacloud.com/gpu-count": str(n),
                      "alibabacloud.com/gpu-mem": f"{16 * n}Gi"})
    return {"kind": "Node", "metadata": {"name": f"n-{i}", "labels": labels},
            "spec": {"taints": taints}, "status": {"allocatable": alloc, "capacity": dict(alloc)}}


def _deployment(name, replicas, rng, gpu):
    labels = {"app": name}
    req = {"cpu": str(rng.choice(["250m", "500m", "1", "2"])),
           "memory": str(rng.choice(["256Mi", "1Gi", "2Gi"]))}
    spec = {"containers": [{"name": "c", "image": "img", "resources": {"requests": req}}]}
    if rng.random() < 0.6:
        key = str(rng.choice([ZONE, RACK, "kubernetes.io/hostname"]))
        spec["topologySpreadConstraints"] = [{
            "maxSkew": int(rng.choice([1, 2, 5])), "topologyKey": key,
            "whenUnsatisfiable": str(rng.choice(["DoNotSchedule", "ScheduleAnyway"])),
            "labelSelector": {"matchLabels": labels}}]
        if rng.random() < 0.4:
            spec["topologySpreadConstraints"].append({
                "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
                "whenUnsatisfiable": "ScheduleAnyway", "labelSelector": {"matchLabels": labels}})
    if rng.random() < 0.3:
        spec["tolerations"] = [{"key": "dedicated", "operator": "Equal", "value": "batch",
                                "effect": "NoSchedule"}]
    if rng.random() < 0.2:
        spec["tolerations"] = spec.get("tolerations", []) + [{"key": "spot", "operator": "Exists"}]
    if rng.random() < 0.25:
        spec["nodeSelector"] = {TYPE: "large"}
    elif rng.random() < 0.25:
        op = str(rng.choice(["In", "NotIn", "Exists", "DoesNotExist"]))
        expr = {"key": RACK, "operator": op}
        if op in ("In", "NotIn"):
            expr["values"] = ["r-0", "r-1"]
        spec["affinity"] = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [expr]}]}}}
    meta = {"labels": labels}
    if gpu:
        meta["annotations"] = {"alibabacloud.com/gpu-mem": str(rng.choice(["4Gi", "8Gi", "16Gi"])),
                               "alibabacloud.com/gpu-count": str(rng.choice([1, 1, 1, 2]))}
    return {"kind": "Deployment", "metadata": {"name": name, "namespace": "t"},
            "spec": {"replicas": int(replicas), "template": {"metadata": meta, "spec": spec}}}


def scenario(seed, gpu=False, nodes=24):
    rng = np.random.default_rng(seed)
    node_list = [_node(i, rng, gpu) for i in range(nodes)]
    apps = []
    for a in range(int(rng.integers(2, 4))):
        objs = [_deployment(f"w{a}-{k}", rng.choice([3, 8, 20, 70, 90]), rng, gpu)
                for k in range(int(rng.integers(1, 3)))]
        apps.append((f"app{a}", objs))
    return node_list, apps


def _port_answer(nodes, apps):
    res = program.simulate(program.cluster(nodes), program.apps(copy.deepcopy(apps)), "cpu")
    return program.answer(res), res


@pytest.mark.parametrize("seed", range(8))
def test_reference_equals_port_on_mixed_features(seed):
    nodes, apps = scenario(seed)
    ans, res = _port_answer(nodes, apps)
    ref = sched.schedule(nodes, apps)
    assert compare.judge(ans, ref) == dict.fromkeys(compare.LIMITS, 0)
    assert len(res.node_status) == len(nodes)


@pytest.mark.parametrize("seed", range(4))
def test_reference_equals_port_on_gpu_share(seed):
    nodes, apps = scenario(100 + seed, gpu=True)
    ans, _ = _port_answer(nodes, apps)
    ref = sched.schedule(nodes, apps)
    assert compare.judge(ans, ref) == dict.fromkeys(compare.LIMITS, 0)
    assert any(g for node in ref.binds for _, g in node)


def test_scenarios_exercise_every_feature():
    kinds = set()
    for seed in range(8):
        nodes, apps = scenario(seed)
        ref = sched.schedule(nodes, apps)
        kinds.add("unschedulable" if any(n < 0 for _, n, _, _ in ref.pods) else "all placed")
        for _, objs in apps:
            for o in objs:
                ps = o["spec"]["template"]["spec"]
                for c in ps.get("topologySpreadConstraints", []):
                    kinds.add((c["topologyKey"] == "kubernetes.io/hostname", c["whenUnsatisfiable"]))
                kinds.update(k for k in ("tolerations", "nodeSelector", "affinity") if k in ps)
    assert {"unschedulable", (False, "DoNotSchedule"), (False, "ScheduleAnyway"),
            (True, "DoNotSchedule"), (True, "ScheduleAnyway"), "tolerations",
            "nodeSelector", "affinity"} <= kinds


def _naive(nodes, apps):
    """The same semantics re-evaluated over every node for every pod, with
    none of the reference's bookkeeping across pods."""
    r = sched.Reference(nodes)
    nd = r.nodes
    groups = []
    for _, objs in apps:
        groups += sched.order([sched.parse_workload(o) for o in objs])
    resources = ["cpu", "memory", "pods"]
    for spec, _ in groups:
        resources += [x for x in sorted(spec.requests) if x not in resources]
    r.resources = resources
    r.alloc = np.stack([nd.alloc(x) for x in resources], axis=1)
    r.free, r.gpu_free = r.alloc.copy(), nd.gpu_total.copy()
    res = sched.Result(node_names=list(nd.names), binds=[[] for _ in range(nd.n)])
    placed = []
    for spec, replicas in groups:
        first, elig, req, st = r._static(spec)
        mine = np.zeros(nd.n, np.int64)
        placed.append((spec, mine))
        for k in range(replicas):
            la, ba = r._la_ba(r.alloc[:, :2], r.free[:, :2], req[:2])
            parts = dict(st, least_allocated=la, balanced_allocation=ba)
            total = r._prefix(parts)
            ok = (first == sched.NONE) & ~r._fit_fail(r.free, req) & ~r._gpu_fail(
                r.gpu_free, nd.gpu_total, spec)
            raw = np.zeros(nd.n, np.float32)
            for key, skew, hard, sel in spec.spread:
                counts = sum((c for s, c in placed if s.namespace == spec.namespace
                              and sched._selector_matches(sel, s.labels)), np.zeros(nd.n, np.int64))
                row = sched._Row(key, skew, hard, counts, elig, nd, True, True)
                cnt, mn = row.cnt()
                if hard:
                    ok &= ((cnt + sched.ONE - mn) <= row.skew) & row.has_key
                else:
                    raw = raw + cnt
            mx = raw.max()
            sp = (np.clip((mx - raw) * sched.HUNDRED / max(mx, sched.TINY), 0, 100).astype(np.float32)
                  if mx > 0 else np.full(nd.n, sched.HUNDRED, np.float32))
            total = total + r.w["topology_spread"] * sp
            if not ok.any():
                res.pods += [(spec.workload, -1, "", None)] * (replicas - k)
                break
            n = int(np.argmax(np.where(ok, total, -np.inf)))
            take = r._gpu_take(r.gpu_free[n:n + 1], nd.gpu_total[n:n + 1], spec)[0]
            r.gpu_free[n] = r.gpu_free[n] - take * spec.gpu_mem
            r.free[n] = r.free[n] - req
            mine[n] += 1
            g = "-".join(str(d) for d in range(take.shape[0]) for _ in range(int(take[d])))
            res.pods.append((spec.workload, n, g, None))
            res.binds[n].append((spec.workload, g))
    return res, r.free, r.gpu_free


@pytest.mark.parametrize("seed,gpu", [(s, False) for s in range(4)] + [(200, True), (201, True)])
def test_incremental_bookkeeping_equals_full_reevaluation(seed, gpu):
    nodes, apps = scenario(seed, gpu=gpu)
    ref = sched.schedule(nodes, apps)
    naive, free, gfree = _naive(nodes, apps)
    assert [p[:3] for p in ref.pods] == [p[:3] for p in naive.pods]
    assert ref.binds == naive.binds
    assert np.array_equal(ref.free, free) and np.array_equal(ref.gpu_free, gfree)


def test_unsupported_features_are_refused():
    nodes, apps = scenario(0)
    obj = copy.deepcopy(apps[0][1][0])
    obj["spec"]["template"]["spec"]["affinity"] = {"podAntiAffinity": {"x": 1}}
    with pytest.raises(sched.Unsupported):
        sched.schedule(nodes, [("a", [obj])])
