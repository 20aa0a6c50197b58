"""Simulator inputs for the port's end-to-end checks, and a result digest.

Copies of the JAX package's `bench.py` workloads, driven through
`engine.simulator.simulate()` (workload expansion, validation, encode,
scheduling, preemption and decode):

  - `plan`: `bench.py:441 config_plan`'s cluster and apps (10,000 nodes of
    3 cpu / 6Gi in 3 zones; Deployments `web`, zone spread ScheduleAnyway,
    and `batch`, 100,000 pods in all), without its capacity search. The
    workload overflows the cluster: 70,000 pods place, 30,000 do not.
  - `preempt`: `bench.py:720 config_preempt` (60 nodes of 8 cpu; 400
    low-priority pods fill them, then 100 pods at priority 100 arrive and
    must evict through DefaultPreemption's batched device probe).

Each `*_spec` returns plain dicts, so the tests can build the same input for
both packages; `plan` / `preempt` build the port's ClusterResource and apps.
Pod names come from the shared name RNG: call `core.workloads.
reset_name_rng()` and rebuild the inputs before every run that a digest is
compared for.

`result_digest` reads only attributes of a SimulateResult, so it applies to
the JAX package's results too. `SIM_DIGESTS` holds the JAX package's
digests at the default sizes (recomputed by
`tests/test_torch_simulator.py::test_sim_digests_match_jax`, marked slow).
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from .core.objects import ANNO_GPU_INDEX, Node

# result_digest of the JAX package's simulate() after reset_name_rng()
SIM_DIGESTS = {
    "plan": "5a351d0ed4e8a47fb2e5b0326f4b65d1",
    "preempt": "9c7e12e28f97664b41ed1775aba5f6e2",
}
# (placed, unscheduled, preempted) of the same runs
SIM_COUNTS = {
    "plan": (70_000, 30_000, 0),
    "preempt": (380, 0, 120),
}


# The example configs through run_apply(auto_plan=False), from the JAX
# package after reset_name_rng(): (report_digest of the report,
# engine.apply.placement_digest, unscheduled pods).
APPLY_DIGESTS = {
    "example/simon-config.yaml": ("daca78a22a8bbec0e97413aa8559807c", "d82a6a5244751e5b", 2),
    "example/simon-gpushare-config.yaml": (
        "cd8f9a5384844aa76bd8e1b97064583a", "6241ba2541837f3f", 0,
    ),
}


def _mk_node(name, cpu, mem, labels=None) -> dict:
    res = {"cpu": cpu, "memory": mem, "pods": "110"}
    return {
        "metadata": {
            "name": name,
            "labels": {"kubernetes.io/hostname": name, **(labels or {})},
        },
        "status": {"allocatable": dict(res), "capacity": dict(res)},
    }


def _mk_deploy(name, replicas, cpu, mem, spec_extra=None) -> dict:
    spec = {
        "containers": [
            {"name": "c", "image": "img",
             "resources": {"requests": {"cpu": cpu, "memory": mem}}}
        ]
    }
    spec.update(spec_extra or {})
    return {
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": "bench"},
        "spec": {
            "replicas": replicas,
            "template": {
                "metadata": {"labels": {"app": name}, "annotations": {}},
                "spec": spec,
            },
        },
    }


Spec = Tuple[List[dict], List[Tuple[str, List[dict]]]]


def plan_spec(n_pods: int = 100_000, n_nodes: int = 10_000) -> Spec:
    """(node dicts, [(app name, workload dicts)]) of config_plan."""
    nodes = [
        _mk_node(f"n-{i}", "3", "6Gi", labels={"topology.kubernetes.io/zone": f"az-{i % 3}"})
        for i in range(n_nodes)
    ]
    spread = {
        "topologySpreadConstraints": [
            {
                "maxSkew": 50,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": {"app": "web"}},
            }
        ]
    }
    deploys = [
        _mk_deploy("web", n_pods // 2, "500m", "1Gi", spec_extra=spread),
        _mk_deploy("batch", n_pods - n_pods // 2, "250m", "512Mi"),
    ]
    return nodes, [("bench", deploys)]


def preempt_spec(n_nodes: int = 60, n_low: int = 400, n_high: int = 100) -> Spec:
    """(node dicts, [(app name, workload dicts)]) of config_preempt."""
    nodes = [_mk_node(f"n-{i}", "8", "32Gi") for i in range(n_nodes)]
    low = _mk_deploy("low-tier", n_low, "1", "1Gi")
    high = _mk_deploy("high-tier", n_high, "2", "1Gi", spec_extra={"priority": 100})
    return nodes, [("bench", [low, high])]


def build(spec: Spec, node_cls, cluster_cls, app_cls):
    """(cluster, apps) of a spec with one package's Node / ClusterResource /
    AppResource."""
    node_dicts, apps = spec
    cluster = cluster_cls(nodes=[node_cls.from_dict(d) for d in node_dicts])
    return cluster, [app_cls(name=name, objects=objs) for name, objs in apps]


def _port_build(spec: Spec):
    from .engine.simulator import AppResource, ClusterResource

    return build(spec, Node, ClusterResource, AppResource)


def plan(n_pods: int = 100_000, n_nodes: int = 10_000):
    return _port_build(plan_spec(n_pods, n_nodes))


def preempt(n_nodes: int = 60, n_low: int = 400, n_high: int = 100):
    return _port_build(preempt_spec(n_nodes, n_low, n_high))


def result_counts(result) -> Tuple[int, int, int]:
    """(placed, unscheduled, preempted) of a SimulateResult."""
    placed = sum(len(st.pods) for st in result.node_status)
    return placed, len(result.unscheduled), len(result.preempted)


def result_digest(result) -> str:
    """blake2b over, each in sorted order: every bound pod's key, node and
    gpu-index annotation; every unscheduled pod's key and reason; every
    preempted pod's key, node and preemptor; every node's storage state
    (VG requested, device allocated)."""
    lines = []
    lines += sorted(
        f"bound\t{p.key}\t{st.node.name}\t{p.meta.annotations.get(ANNO_GPU_INDEX, '')}"
        for st in result.node_status for p in st.pods
    )
    lines += sorted(f"unscheduled\t{u.pod.key}\t{u.reason}" for u in result.unscheduled)
    lines += sorted(f"preempted\t{v.pod.key}\t{v.node}\t{v.by}" for v in result.preempted)
    for name in sorted(result.storage):
        st = result.storage[name]
        lines.append(
            f"storage\t{name}\t"
            + ",".join(f"{vg.name}={vg.requested}" for vg in st.vgs) + "\t"
            + ",".join(f"{d.name}={int(d.is_allocated)}" for d in st.devices)
        )
    return hashlib.blake2b("\n".join(lines).encode(), digest_size=16).hexdigest()


def report_digest(text: str) -> str:
    """blake2b of an apply report without its `device:` line (the one line
    that names the backend)."""
    kept = "\n".join(line for line in text.splitlines() if not line.startswith("device:"))
    return hashlib.blake2b(kept.encode(), digest_size=16).hexdigest()
