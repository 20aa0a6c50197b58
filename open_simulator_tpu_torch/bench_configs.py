"""Three workloads that, with the headline, drive every scheduler route.

Each is a list of node dicts, a list of pod-template dicts and a replica
count per template; both packages' `Node.from_dict` / `Pod.from_dict` read
them, and `tile_pod_batch` repeats each template into one run of identical
pods, so the same encoded batch can go through either package.

- `spread_affinity`: the JAX package's bench.py `config_spread_affinity`
  at its own size, 10,000 pods on 1,000 nodes in three zones: a `front`
  tier under zone spread (DoNotSchedule, maxSkew 50) and a `back` tier
  with preferred zone pod affinity to `front`. Both take the domain path;
  `front` through the domain_pop kernel's hard variant, `back` through the
  affinity pop loop.
- `gpushare`: bench.py `config_gpushare` at its own size, 5,000 GPU-share
  pods (8 GiB and 4 GiB shares) on 320 nodes of 8 x 16 GiB devices. Both
  groups take the general light scan (GPU state evolves).
- `mixed`: the node and template shapes of the JAX package's fuzz test
  (tests/test_fuzz_parity.py: zones, racks, tiers, taints; spread, pod
  (anti-)affinity, selectors, tolerations, host ports), drawn with
  numpy.random.default_rng at 1,000 nodes and 24 templates of 3 to 1,000
  replicas, plus one 300-replica template with required hostname pod
  anti-affinity. Small groups take the grouped scan; the rest sort,
  domain (with and without affinity), the domain fallback to the micro
  scan, and the general scan.

`DIGESTS` holds `headline.placement_digest` of the JAX package's
`schedule_batch_fast` on each workload (computed on the CPU, default
weights, default chunking); `PATHS` the route counts that run gives, and
`DOMAIN_POP_GROUPS` how many groups enter the domain path spread-only (the
one that falls back included), i.e. launch the domain_pop kernel once each
on the card; `SCAN_KERNEL_GROUPS` how many take the light scan with no
coupled term, i.e. launch the light_scan kernel once each on the card (one
chunk each at the default chunking); `TRAJ_KERNEL_GROUPS` how many build a
trajectory with no port or storage dynamics, i.e. launch the trajectory
kernel once each on the card.
"""

from __future__ import annotations

import numpy as np

from .core.objects import Node, Pod
from .device import DEFAULT_DEVICE
from .ops.encode import (
    Encoder,
    encode_nodes,
    encode_pods,
    initial_anti_counts,
    initial_port_counts,
    initial_selector_counts,
)
from .ops.state import carry_from_table, node_static_from_table
from .ops.tile import tile_pod_batch

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
MIXED_SEED = 10

WORKLOADS = ("spread_affinity", "gpushare", "mixed")

DIGESTS = {
    "spread_affinity": "sha256:7ca240a4c156f3c0a32ef6c3f5570c613e419b77d4f20681f891bda853201104",
    "gpushare": "sha256:d2a2c483567eaee29f1bf309c4e1010ef59a8b8ee30ac7de845dacd6deb6f046",
    "mixed": "sha256:bb5008741395730a00749af6518c5d17051ef33f2880648eaf5ec09ff6f407d9",
}

PATHS = {
    "spread_affinity": {"domain": 2},
    "gpushare": {"scan": 2},
    "mixed": {
        "sort": 2, "micro": 1, "scan": 1, "grouped": 13, "domain": 8, "domain_fallback": 1,
    },
}

DOMAIN_POP_GROUPS = {"spread_affinity": 1, "gpushare": 0, "mixed": 6}

SCAN_KERNEL_GROUPS = {"spread_affinity": 0, "gpushare": 2, "mixed": 0}

TRAJ_KERNEL_GROUPS = {"spread_affinity": 2, "gpushare": 2, "mixed": 11}


def _bench_node(name, cpu, mem, labels=None, capacity_extra=None):
    """bench.py's _mk_node: allocatable == capacity, 110 pod slots."""
    res = {"cpu": cpu, "memory": mem, "pods": "110", **(capacity_extra or {})}
    return {
        "metadata": {"name": name, "labels": {HOSTNAME: name, **(labels or {})}},
        "status": {"allocatable": dict(res), "capacity": dict(res)},
    }


def _bench_template(name, cpu, mem, spec_extra=None, anno=None):
    """The pod template of bench.py's _mk_deploy(name, ...)."""
    spec = {"containers": [
        {"name": "c", "image": "img", "resources": {"requests": {"cpu": cpu, "memory": mem}}}
    ]}
    spec.update(spec_extra or {})
    return {
        "metadata": {"name": name, "namespace": "bench", "labels": {"app": name},
                     "annotations": anno or {}},
        "spec": spec,
    }


def spread_affinity(n_pods=10_000, n_nodes=1_000):
    nodes = [
        _bench_node(f"n-{i}", "32", "64Gi", labels={ZONE: f"az-{i % 3}"})
        for i in range(n_nodes)
    ]
    spread = {"topologySpreadConstraints": [{
        "maxSkew": 50, "topologyKey": ZONE, "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "front"}},
    }]}
    affinity = {"affinity": {"podAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 10,
            "podAffinityTerm": {
                "labelSelector": {"matchLabels": {"app": "front"}}, "topologyKey": ZONE,
            },
        }],
    }}}
    templates = [
        _bench_template("front", "250m", "512Mi", spec_extra=spread),
        _bench_template("back", "500m", "1Gi", spec_extra=affinity),
    ]
    return nodes, templates, [n_pods // 2, n_pods - n_pods // 2]


def gpushare(n_pods=5_000, n_nodes=320):
    gpu = {"alibabacloud.com/gpu-count": "8", "alibabacloud.com/gpu-mem": "128Gi"}
    nodes = [_bench_node(f"g-{i}", "64", "256Gi", capacity_extra=gpu) for i in range(n_nodes)]
    templates = [
        _bench_template("train", "2", "8Gi", anno={
            "alibabacloud.com/gpu-mem": "8Gi", "alibabacloud.com/gpu-count": "1"}),
        _bench_template("infer", "1", "4Gi", anno={
            "alibabacloud.com/gpu-mem": "4Gi", "alibabacloud.com/gpu-count": "1"}),
    ]
    return nodes, templates, [n_pods // 2, n_pods - n_pods // 2]


def _pick(rng, options):
    return options[int(rng.integers(len(options)))]


def _fuzz_node(rng, i):
    labels = {HOSTNAME: f"n-{i}", ZONE: _pick(rng, ["z-0", "z-1", "z-2"])}
    if rng.random() < 0.5:
        labels["rack"] = f"r-{int(rng.integers(4))}"
    if rng.random() < 0.3:
        labels["tier"] = _pick(rng, ["gold", "silver"])
    taints = (
        [{"key": "dedicated", "value": "batch", "effect": "NoSchedule"}]
        if rng.random() < 0.2 else []
    )
    return {
        "metadata": {"name": f"n-{i}", "labels": labels},
        "spec": {"taints": taints},
        "status": {"allocatable": {
            "cpu": str(_pick(rng, [4, 8, 16])), "memory": f"{_pick(rng, [8, 16, 64])}Gi",
            "pods": str(_pick(rng, [5, 10])),
        }},
    }


def _fuzz_template(rng, t):
    app = f"a{t}"
    spec = {}
    if rng.random() < 0.6:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": _pick(rng, [1, 2, 5]),
                "topologyKey": _pick(rng, [ZONE, "rack"]),
                "whenUnsatisfiable": _pick(rng, ["ScheduleAnyway", "DoNotSchedule"]),
                "labelSelector": {"matchLabels": {"app": app}},
            }
            for _ in range(int(rng.integers(1, 3)))
        ]
    if rng.random() < 0.35:
        term = {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": ZONE}
        kind = "podAntiAffinity" if rng.random() < 0.5 else "podAffinity"
        if rng.random() < 0.5:
            spec["affinity"] = {kind: {"requiredDuringSchedulingIgnoredDuringExecution": [term]}}
        else:
            spec["affinity"] = {kind: {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 10, "podAffinityTerm": term}]}}
    if rng.random() < 0.25:
        spec["nodeSelector"] = {"tier": "gold"}
    if rng.random() < 0.25:
        spec["tolerations"] = [{"key": "dedicated", "operator": "Equal", "value": "batch",
                                "effect": "NoSchedule"}]
    container = {"name": "c", "resources": {"requests": {
        "cpu": _pick(rng, ["250m", "500m", "1"]), "memory": _pick(rng, ["256Mi", "512Mi"]),
    }}}
    if rng.random() < 0.2:
        container["ports"] = [{"containerPort": 80, "hostPort": 8000 + int(rng.integers(2))}]
    spec["containers"] = [container]
    return {"metadata": {"name": f"t{t}", "namespace": "fast", "labels": {"app": app}},
            "spec": spec}


def mixed(seed=MIXED_SEED, n_nodes=1_000, n_templates=24):
    rng = np.random.default_rng(seed)
    nodes = [_fuzz_node(rng, i) for i in range(n_nodes)]
    templates = [_fuzz_template(rng, t) for t in range(n_templates)]
    counts = [_pick(rng, [3, 17, 40, 200, 1000]) for _ in templates]
    solo = f"a{n_templates}"
    templates.append({
        "metadata": {"name": f"t{n_templates}", "namespace": "fast", "labels": {"app": solo}},
        "spec": {
            "containers": [{"name": "c", "resources": {"requests": {
                "cpu": "250m", "memory": "256Mi"}}}],
            "affinity": {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": solo}}, "topologyKey": HOSTNAME}]}},
        },
    })
    counts.append(300)
    return nodes, templates, counts


def workload(name: str):
    """(node dicts, pod-template dicts, replica counts) of a workload."""
    return {"spread_affinity": spread_affinity, "gpushare": gpushare, "mixed": mixed}[name]()


def build_state(name: str, device=DEFAULT_DEVICE):
    """(NodeStatic, Carry, PodBatch) of a workload, the state on `device`."""
    node_dicts, pod_dicts, counts = workload(name)
    templates = [Pod.from_dict(d) for d in pod_dicts]
    enc = Encoder()
    enc.register_pods(templates)
    table = encode_nodes(enc, [Node.from_dict(d) for d in node_dicts])
    batch = tile_pod_batch(encode_pods(enc, templates), counts)
    ns = node_static_from_table(enc, table, device)
    carry = carry_from_table(
        table, initial_selector_counts(enc, table, []),
        port_counts=initial_port_counts(enc, table, []),
        anti_counts=initial_anti_counts(enc, table, []), device=device,
    )
    return ns, carry, batch
