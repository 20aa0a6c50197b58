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
  - the capacity searches (`engine/capacity.plan_capacity`): `plan_spec()`
    with `bench.py:475`'s 32 cpu / 64Gi template (`plan_full`), the same
    shapes at `PLAN_SMALL`, and `bench.py:490 config_capacity_sweep`; and
    `bench.py:559 config_multi_scenario`'s 64 lanes through
    `simulate_batch`. `CAPACITY_DIGESTS`, `MULTI_SCENARIO_DIGESTS` and
    `QUICKSTART_DIGEST` hold the JAX package's answers.
  - the extender phase: `extender_spec()` (48 nodes each holding a bound
    low-priority pod, 160 pods of `web` (two full extender waves and a
    half) and 4 `urgent` pods that must preempt) against the stub extender
    `EXTENDER_BEHAVIOR` with filter, prioritize and preempt verbs;
    `extender_capacity_spec()` through plan_capacity with an extender that
    admits only the clones and `EXTENDER_FAULT_PLAN`'s one transient blip;
    and `run_apply` on a kubeConfig (tools/stubs.py
    `write_kube_apply_config`) served by a stub apiserver holding
    `KUBE_APIS`. `EXTENDER_DIGESTS` and
    `KUBE_APPLY_DIGEST` hold the JAX package's answers.

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


# plan_small's size, cut from 10,000 x 1,000 to fit chip_smoke.py's time
# limit: in auto mode on a card the search runs the wave engine, whose
# 256-pod waves on this workload all run the 24-round budget and then the
# serial fallback (7.6-12.7 s a wave at 2,000 x 200, PERF.md §5). At
# 10,000 x 1,000 that is ~80 waves, 10-17 minutes, more than the whole
# script may take; 2,000 x 200 (16 waves, 121-204 s) left too little of the
# limit once the serve phase ran, so it is 1,000 x 100 (8 waves), still
# over the wave engine's 512-pod floor. ROADMAP.md Perf candidate 2
# restores the size once sweeps are faster.
PLAN_SMALL = (1_000, 100)

# plan_capacity of each workload from the JAX package after reset_name_rng(),
# keyed "<name>/<sweep_mode>": (nodes_added, attempts, batched_calls,
# result_digest of the plan's result). plan_full is plan_spec() (100,000 pods
# x 10,000 nodes), plan_small plan_spec(*PLAN_SMALL), both with
# template_spec(); capacity_sweep is capacity_sweep_spec() with the same
# template. (tests/test_torch_capacity.py recomputes them; plan_* are slow.)
CAPACITY_DIGESTS = {
    "plan_full/serial": (235, 10, 0, "a35e3c5da4b96e1b84a3e3af20136681"),
    "plan_small/serial": (3, 4, 0, "0a0b1e917cd38dfb122da071c4f541d5"),
    "plan_small/auto": (3, 11, 2, "0a0b1e917cd38dfb122da071c4f541d5"),
    "capacity_sweep/serial": (46, 13, 0, "1c99963293d482e13e8d4dab5c5fdaa2"),
    "capacity_sweep/batched": (46, 19, 3, "1c99963293d482e13e8d4dab5c5fdaa2"),
    "capacity_sweep/auto": (46, 19, 3, "1c99963293d482e13e8d4dab5c5fdaa2"),
}
# simulate_batch of multi_scenario_spec() over multi_scenario_counts() (64
# lanes) from the JAX package: each lane's result_digest, by its node count.
MULTI_SCENARIO_DIGESTS = {
    32: "29b139c973f53dc9c250d94b9d90d317",
    33: "744a09755be8d4ea7df4472725c5b005",
    34: "c19fd8414a7b5283f3af897f9ef7a513",
    35: "a4c7be5e28d155ec588b925e9064a15a",
    36: "5e1d7302d2c9879b06a04013a6e83e04",
    37: "2d7caad30cf2de7448f0103463936206",
    38: "cc35a348dcfa62629f0a30a8b13ad036",
    39: "f8ab68f6fbfb10fe1fe85496768d88f4",
    40: "9d7f7b0e98afa6df8e626ac56bdb7c86",
    41: "789d2d81a5551ad0677aec03473ba5b2",
    42: "fe8b9e9b13eb282b2536dfa3df36ec65",
    43: "88129fee7f0211fb41f4a0cc2e91d8c6",
    44: "8da93fc3024f55ef6ac07ab5c4560fb9",
    45: "dff2c786f2b49515bdc3037b8e07a5cc",
    46: "536eaa54c01deb1700380472616f5eb5",
    47: "585bd0c867462eae80a60352252604eb",
    48: "eee6860b3d69287403e7c88dbb483375",
    49: "4794c1af06d58c161d9ee6bebc5f8351",
    50: "c48b91fd37de56c323f72b61aebd24db",
    51: "c34f1e1eb1c6c62299c067df051f6e2e",
    52: "7caeea062435c299c3cb8662381eafdc",
    53: "0d3706a37691cf67bfd8c6ca8e0ea147",
    54: "3667238e87f77c9507efb1d80b9d0db3",
    55: "4f41e25577358cafdd614abc3d02a8ec",
    56: "adc41a91c5676e3b03f7a6cc4ddf02a6",
    57: "20cb232443df22925814668c2c46ae37",
    58: "e48ca124395f1255e74674d1bae5478a",
    59: "bd1886442205826c54eefd57a0cc4eb9",
    60: "97692296ddff536d794cc889bb467a42",
    61: "5b6db272e6a56514ddbb435bc7a68df5",
    62: "f6270c6c50b32db148f7f5ac256be9fe",
    63: "75e3dc94dc509e429f0e540043b8ed0c",
    64: "db94fd60dc68b2599f4257425ed0059b",
}
# example/simon-config.yaml through run_apply(auto_plan=True) in the JAX
# package: (report_digest, placement_digest, nodes_added, attempts).
QUICKSTART_DIGEST = ("3140719f1dc40b4e23a84fdb1dbd5530", "65b089aece437ea2", 1, 2)
# example/simon-config.yaml through simulate() (no capacity search) in the
# JAX package after reset_name_rng(): (result_digest, placed, unscheduled).
# chip_smoke.py's tooling phase holds the plain and the sanitized
# (OSIM_SANITIZE=1) run against it.
QUICKSTART_SIM_DIGEST = ("ba149f655c31c5fd3350142ea9e6f170", 66, 2)
# nodes_added of the canonical capacity sweep (the reference's
# analysis/jaxpr_audit._run_sweeps, serial and batched) in the JAX package:
# what `simon warmup --check` must answer.
WARM_START_NODES_ADDED = 7


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


def template_spec() -> dict:
    """The capacity searches' candidate node (`bench.py:475`): 32 cpu, 64Gi."""
    return _mk_node("new-node", "32", "64Gi")


def capacity_sweep_spec(n_base: int = 2, n_replicas: int = 48) -> Spec:
    """`bench.py:490 config_capacity_sweep`: required hostname anti-affinity
    makes every replica need its own node, so the demand estimate (~1 node)
    is far below the answer (n_replicas - n_base)."""
    anti = {
        "affinity": {
            "podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {
                        "labelSelector": {"matchLabels": {"app": "lonely"}},
                        "topologyKey": "kubernetes.io/hostname",
                    }
                ]
            }
        }
    }
    nodes = [_mk_node(f"n-{i}", "32", "64Gi") for i in range(n_base)]
    return nodes, [("bench", [_mk_deploy("lonely", n_replicas, "500m", "1Gi", spec_extra=anti)])]


def multi_scenario_spec(n_nodes: int = 64, n_pods: int = 400) -> Spec:
    """`bench.py:559 config_multi_scenario`'s cluster and app."""
    nodes = [_mk_node(f"n-{i}", "16", "32Gi") for i in range(n_nodes)]
    return nodes, [("bench", [_mk_deploy("web", n_pods, "500m", "1Gi")])]


def multi_scenario_counts(n_scenarios: int = 64, n_nodes: int = 64) -> List[int]:
    """The node count of each of config_multi_scenario's lanes: they cycle
    over the top half of the cluster."""
    return [n_nodes // 2 + (i % (n_nodes // 2 + 1)) for i in range(n_scenarios)]


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


# ---------------------------------------------------------------------------
# Extenders and kubeConfig (chip_smoke.py's extender phase)
# ---------------------------------------------------------------------------

# The stub extender's behavior (tools/stubs.py): every fourth node is
# refused with a message, e-1 and e-2 score a little higher, and the preempt
# verb keeps only even-numbered candidate nodes.
EXTENDER_BEHAVIOR = {
    "allow": {f"e-{i}" for i in range(48) if i % 4 != 3},
    "failed": {f"e-{i}": "reserved by quota" for i in range(48) if i % 4 == 3},
    "scores": {"e-1": 2, "e-2": 1},
    "preempt_allow": {f"e-{i}" for i in range(0, 48, 2)},
}
EXTENDER_VERBS = ("filter", "prioritize", "preempt")


def extender_spec(n_nodes: int = 48, n_web: int = 160, n_urgent: int = 4):
    """(node dicts, bound pod dicts, [(app name, workload dicts)]): nodes of
    8 cpu each hold a bound 6-cpu pod at priority 0; `web` pods (250m)
    spread over the nodes the extender allows; `urgent` pods (6 cpu,
    priority 100) fit nowhere without evicting."""
    nodes = [_mk_node(f"e-{i}", "8", "32Gi", labels={"zone": f"z-{i % 3}"}) for i in range(n_nodes)]
    bound = [
        {
            "metadata": {"name": f"low-{i}", "namespace": "bench", "labels": {"app": "low"}},
            "spec": {
                "nodeName": f"e-{i}", "priority": 0,
                "containers": [{"name": "c", "image": "img",
                                "resources": {"requests": {"cpu": "6", "memory": "1Gi"}}}],
            },
        }
        for i in range(n_nodes)
    ]
    apps = [("bench", [
        _mk_deploy("web", n_web, "250m", "512Mi"),
        _mk_deploy("urgent", n_urgent, "6", "1Gi", spec_extra={"priority": 100}),
    ])]
    return nodes, bound, apps


def extender_capacity_spec(n_base: int = 8, n_pods: int = 60) -> Spec:
    """The capacity search behind an extender that admits only the clones:
    8 nodes of 16 cpu that the extender refuses, 60 pods of 4 cpu."""
    nodes = [_mk_node(f"c-{i}", "16", "64Gi") for i in range(n_base)]
    return nodes, [("bench", [_mk_deploy("job", n_pods, "4", "1Gi")])]


EXTENDER_CAPACITY_BEHAVIOR = {"allow": {f"simon-{i:05d}" for i in range(64)}}
# one transient blip: each pod's first three filter calls are refused, so
# the extender's own retries (3 attempts) run out in the first probe and the
# capacity search re-runs that probe once (CapacityPlan.retries == 1); the
# breaker threshold must be raised (OSIM_BREAKER_THRESHOLD) so that the
# blip does not open the circuit
EXTENDER_FAULT_PLAN = {
    "seed": 1,
    "rules": [{"target": "extender", "op": "filter", "kind": "connection_error", "times": 3}],
}

# The JAX package's answers after reset_name_rng():
#   "simulate": (result_digest, stub requests per verb)
#   "capacity": (nodes_added, attempts, retries, result_digest of the plan's
#                result, stub requests per verb)
EXTENDER_DIGESTS = {
    "simulate": ("64f525acbf6986f9d014e78fd3eb9392",
                 {"filter": 243, "prioritize": 243, "preempt": 4}),
    "capacity": (8, 6, 1, "a9e68e2219a65d571aca6db967f7d430",
                 {"filter": 626, "prioritize": 522}),
}


def extender_config(profiles_mod, url: str, verbs=EXTENDER_VERBS):
    """The phase's ExtenderConfig in one package's models.profiles."""
    names = {"filter": "filter_verb", "prioritize": "prioritize_verb", "preempt": "preempt_verb"}
    return profiles_mod.ExtenderConfig(url_prefix=url, **{names[v]: v for v in verbs})


def extender_simulate(sim_mod, objects_mod, profiles_mod, url: str, **kw):
    """simulate() of extender_spec() against the extender at `url`, through
    one package's engine.simulator / core.objects / models.profiles (the
    caller resets that package's name RNG first)."""
    node_dicts, bound, apps = extender_spec()
    cluster = sim_mod.ClusterResource(
        nodes=[objects_mod.Node.from_dict(d) for d in node_dicts],
        pods=[objects_mod.Pod.from_dict(p) for p in bound],
    )
    return sim_mod.simulate(
        cluster, [sim_mod.AppResource(name=n, objects=o) for n, o in apps],
        extenders=[extender_config(profiles_mod, url)], **kw,
    )


def extender_capacity(sim_mod, objects_mod, profiles_mod, capacity_mod, url: str, **kw):
    """plan_capacity of extender_capacity_spec() with template_spec() behind
    a filter+prioritize extender at `url`, in one package."""
    node_dicts, apps = extender_capacity_spec()
    cluster = sim_mod.ClusterResource(nodes=[objects_mod.Node.from_dict(d) for d in node_dicts])
    return capacity_mod.plan_capacity(
        cluster, [sim_mod.AppResource(name=n, objects=o) for n, o in apps],
        objects_mod.Node.from_dict(template_spec()),
        extenders=[extender_config(profiles_mod, url, ("filter", "prioritize"))], **kw,
    )


# run_apply(auto_plan=False) on tools/stubs.py write_kube_apply_config's
# config, served from its KUBE_APIS, in the JAX package: (report_digest, placement_digest, unscheduled pods)
KUBE_APPLY_DIGEST = ("93538885b8390aaf8d4e644c110e04ea", "aca5823f4ec53d46", 0)


# ---------------------------------------------------------------------------
# Durable runs and resident state (chip_smoke.py's durable and resident
# phases)
# ---------------------------------------------------------------------------

# The chunked scan at full width: plan_full's first ladder sweep (6 lanes,
# padded to 8, over 20,480 node rows, as chip_smoke.py's wave_width_check
# builds it) and the first CHUNK_SCAN_PODS pods of its workload, scanned
# whole. scenario_carry_digest of the exit carry, from the JAX package
# (tests/test_torch_checkpoint.py::test_full_width_scan_digest_matches_jax,
# marked slow, recomputes it).
CHUNK_SCAN_PODS = 512
CHUNK_SCAN_DIGEST = 0x6048C1FF

# simon sweep --capacity -f tests/fixtures/sweep/simon-config.yaml --run-dir D
# and simon apply -f example/simon-config.yaml --run-dir D through the JAX
# package's CLI: outcome.json's placement_digest
RUN_DIR_DIGESTS = {
    "sweep": "af6f8c4c489fb711",
    "apply": "65b089aece437ea2",
}

# The resident phase: RESIDENT_ROUNDS rounds of RESIDENT_CHANGES seeded
# changes each to plan_spec()'s 10,000 nodes (resident_rounds), synced into a
# ResidentCluster. RESIDENT_DIGEST is digest_table of the final state and
# RESIDENT_SIM_DIGEST the result_digest of simulate() of plan_spec()'s apps on
# the cluster after the rounds, both from the JAX package
# (tests/test_torch_resident.py::test_plan_rounds_match_jax, marked slow).
RESIDENT_ROUNDS = 32
RESIDENT_CHANGES = 64
RESIDENT_SEED = 7
RESIDENT_DIGEST = 3475267394
RESIDENT_SIM_DIGEST = "ac1f226693b87f73b49ce58397d76c2e"


def resident_rounds(node_dicts: List[dict], n_rounds: int = RESIDENT_ROUNDS,
                    per_round: int = RESIDENT_CHANGES, seed: int = RESIDENT_SEED):
    """Seeded delta rounds over a cluster: yields, per round, ({node index:
    its new node dict}, [bound pod dicts]). Each change is one of: a label
    set on a node (a third label), a NoSchedule taint put on or taken off,
    the node's allocatable cpu and memory changed, a pod bound to the node
    (or, one time in four, a bound pod removed), or a node added at the
    end (within the node bucket). At most three labels and one taint per
    node keep every row within the resident's axis buckets. `node_dicts` is
    not modified."""
    import copy as _copy
    import random

    rng = random.Random(seed)
    nodes = list(node_dicts)
    pods: List[dict] = []
    serial = 0
    for r in range(n_rounds):
        changed = {}
        for _ in range(per_round):
            kind = rng.choices(("label", "taint", "alloc", "bind", "add"),
                               weights=(25, 15, 20, 30, 10))[0]
            i = rng.randrange(len(nodes))
            if kind == "add":
                i = len(nodes)
                nodes.append(_mk_node(f"n-{i}", "3", "6Gi",
                                      labels={"topology.kubernetes.io/zone": f"az-{i % 3}"}))
            elif kind == "bind":
                if pods and rng.random() < 0.25:
                    pods.pop(rng.randrange(len(pods)))
                else:
                    serial += 1
                    pods.append({
                        "metadata": {"name": f"bound-{serial}", "namespace": "resident"},
                        "spec": {"nodeName": nodes[i]["metadata"]["name"], "containers": [
                            {"name": "c", "image": "img", "resources": {"requests": {
                                "cpu": rng.choice(("250m", "500m", "1")),
                                "memory": rng.choice(("256Mi", "512Mi"))}}}]},
                    })
                continue
            else:
                d = _copy.deepcopy(nodes[i])
                if kind == "label":
                    d["metadata"]["labels"]["tier"] = f"t{r % 4}"
                elif kind == "taint":
                    spec = d.setdefault("spec", {})
                    spec["taints"] = [] if spec.get("taints") else [
                        {"key": "maintenance", "value": f"r{r}", "effect": "NoSchedule"}]
                else:
                    res = {"cpu": rng.choice(("2", "3", "4")),
                           "memory": rng.choice(("4Gi", "6Gi", "8Gi")), "pods": "110"}
                    d["status"] = {"allocatable": dict(res), "capacity": dict(res)}
                nodes[i] = d
            changed[i] = nodes[i]
        yield changed, list(pods)


class ResidentWalk:
    """One package's Node and Pod objects along resident_rounds: apply()
    takes a round and returns (nodes, pods), reusing the objects of nodes
    and pods that did not change (the resident's identity fast path)."""

    def __init__(self, node_cls, pod_cls, node_dicts: List[dict]) -> None:
        self.node_cls, self.pod_cls = node_cls, pod_cls
        self.nodes = [node_cls.from_dict(d) for d in node_dicts]
        self._pods: dict = {}

    def apply(self, changed: dict, pod_dicts: List[dict]):
        for i, d in sorted(changed.items()):
            nd = self.node_cls.from_dict(d)
            if i < len(self.nodes):
                self.nodes[i] = nd
            else:
                self.nodes.append(nd)
        pods = []
        for d in pod_dicts:
            name = d["metadata"]["name"]
            if name not in self._pods:
                self._pods[name] = self.pod_cls.from_dict(d)
            pods.append(self._pods[name])
        return list(self.nodes), pods


# ---------------------------------------------------------------------------
# Serving (chip_smoke.py's serve phase)
# ---------------------------------------------------------------------------
# The live cluster is plan_spec()'s 10,000 nodes behind a stub apiserver
# (tools/stubs.StubApiServer over live_apis()). The full request is
# config_plan's apps with no cluster (so the server snapshots the live
# cluster); the small request is the same zone-spread `web` Deployment at
# SERVE_SMALL_REPLICAS replicas, under WAVE_AUTO_MIN_PODS (ops/wave.py), so
# a pack of small bodies runs the lane-batched scan. SERVE_WEIGHTS are the
# scenario pack's 8 lanes.
SERVE_SMALL_REPLICAS = 256
SERVE_WEIGHTS = (
    {"least_allocated": 1.0},
    {"least_allocated": 100.0},
    {"balanced_allocation": 10.0},
    {"topology_spread": 20.0},
    {"least_allocated": 0.0, "balanced_allocation": 5.0},
    {"topology_spread": 0.0},
    {"simon": 50.0},
    {"least_allocated": 3.0, "topology_spread": 7.0},
)

# response_digest of each serve-phase response, from the JAX package's server
# on the same stub and bodies after reset_name_rng():
#  - "full": the full request on the untouched cluster. response_digest equals
#    result_digest when a result has no preemption, GPU index or storage, so
#    this is SIM_DIGESTS["plan"] (tests/test_torch_server.py::
#    test_response_digest_is_result_digest holds the identity on a small plan
#    through both packages' servers);
#  - "resync": the full request after the stub moved by all RESIDENT_ROUNDS
#    rounds of resident_rounds(), RESIDENT_SIM_DIGEST by the same identity
#    (test_live_rounds_response_is_resident_digest holds it at small size);
#  - "small/<i>": the small request with SERVE_WEIGHTS[i], one lane of a pack
#    of all 8, computed with the JAX server by
#    `python -m pytest -m slow tests/test_torch_server.py::test_serve_digests_match_jax`;
#  - "inline": serve_inline_body() (bench.py's serving body, 20 nodes, 100
#    replicas), computed by the same test.
SERVE_DIGESTS = {
    "full": SIM_DIGESTS["plan"],
    "resync": RESIDENT_SIM_DIGEST,
    "small/0": "7f0c392f20c4893eee8d5c1e7198a81e",
    "small/1": "7f0c392f20c4893eee8d5c1e7198a81e",
    "small/2": "c73d8d45bc5b48f3540f99de93320ffb",
    "small/3": "0bcebc8b863b8cbb2b783a914db9754a",
    "small/4": "c73d8d45bc5b48f3540f99de93320ffb",
    "small/5": "c73d8d45bc5b48f3540f99de93320ffb",
    "small/6": "c73d8d45bc5b48f3540f99de93320ffb",
    "small/7": "7f0c392f20c4893eee8d5c1e7198a81e",
    "inline": "f84d92185c95d0bae52f9554a8cf1532",
}


# The serve phase's async job: plan_capacity of capacity_sweep_spec() with
# template_spec() and the batched sweep, the server's, as outcome.json
# reports it. The numbers are CAPACITY_DIGESTS["capacity_sweep/batched"]'s;
# placement_digest is engine.apply.placement_digest of the JAX package's plan
# result (tests/test_torch_server.py::test_capacity_sweep_job_matches_jax
# recomputes it).
SERVE_JOB_OUTCOME = {
    "outcome": "ok", "kind": "sweep", "nodes_added": 46, "attempts": 19,
    "batched_calls": 3, "retries": 0, "unscheduled": 0,
    "placement_digest": "9d18bf3b1a8ee710",
}


def serve_job_body(job: str) -> dict:
    """POST /v1/jobs body of the serve phase's async job: capacity_sweep's
    cluster and apps inline, the template as the new node."""
    nodes, apps = capacity_sweep_spec()
    return {"cluster": {"objects": [dict(n, kind="Node") for n in nodes]},
            "apps": [{"name": name, "objects": objs} for name, objs in apps],
            "newNode": dict(template_spec(), kind="Node"), "job": job}


def _response_lines(payload: dict) -> List[str]:
    lines = sorted(f"bound\t{k}\t{n}\t" for k, n in payload["placements"].items())
    lines += sorted(f"unscheduled\t{u['pod']}\t{u['reason']}" for u in payload["unscheduled"])
    return lines


def response_digest(payload: dict) -> str:
    """result_digest's blake2b over a deploy-apps response (placements and
    unscheduled pods); equal to result_digest of the simulation behind it
    when that has no preemption, GPU index or storage."""
    return hashlib.blake2b("\n".join(_response_lines(payload)).encode(),
                           digest_size=16).hexdigest()


def _workload_of(pod_key: str) -> str:
    """A generated pod's workload: its key without the random suffix
    (`ns/web-<suffix>` -> `ns/web`)."""
    return pod_key.rsplit("-", 1)[0]


def response_census(payload: dict) -> str:
    """A name-free digest of a response: per node, the count of each
    workload's pods, and the unscheduled count per workload and reason. Two
    responses whose pod names came from different draws of the name RNG
    agree on it when their placements agree up to names."""
    per_node: dict = {}
    for key, node in payload["placements"].items():
        k = (node, _workload_of(key))
        per_node[k] = per_node.get(k, 0) + 1
    unsched: dict = {}
    for u in payload["unscheduled"]:
        k = (_workload_of(u["pod"]), u["reason"])
        unsched[k] = unsched.get(k, 0) + 1
    lines = sorted(f"node\t{n}\t{w}\t{c}" for (n, w), c in per_node.items())
    lines += sorted(f"unscheduled\t{w}\t{r}\t{c}" for (w, r), c in unsched.items())
    return hashlib.blake2b("\n".join(lines).encode(), digest_size=16).hexdigest()


def serve_full_body(n_pods: int = 100_000, n_nodes: int = 10_000) -> dict:
    """The full request: plan_spec()'s apps, the cluster left to the live
    snapshot."""
    _, apps = plan_spec(n_pods, n_nodes)
    return {"apps": [{"name": name, "objects": objs} for name, objs in apps]}


def serve_small_body(weights=None, replicas: int = SERVE_SMALL_REPLICAS) -> dict:
    """The small request: plan_spec()'s `web` Deployment alone at `replicas`,
    with score `weights` when given."""
    _, apps = plan_spec(2 * replicas, 3)
    web = apps[0][1][0]
    body = {"apps": [{"name": apps[0][0], "objects": [web]}]}
    if weights is not None:
        body["weights"] = dict(weights)
    return body


def serve_inline_body() -> dict:
    """bench.py config_serving_concurrent's body: 20 nodes of 32 cpu / 64Gi
    inline, Deployment `web` at 100 replicas of 500m / 1Gi."""
    nodes = [dict(_mk_node(f"n-{i}", "32", "64Gi"), kind="Node") for i in range(20)]
    return {"cluster": {"objects": nodes},
            "apps": [{"name": "web", "objects": [_mk_deploy("web", 100, "500m", "1Gi")]}]}


def live_apis(node_dicts: List[dict], pod_dicts: List[dict] = ()) -> dict:
    """A stub apiserver's document map (tools/stubs.StubApiServer) holding a
    cluster: the nodes in order, each pod as a Running pod, every other list
    the kubeclient reads empty."""
    pods = [dict(p, status={"phase": "Running"}) for p in pod_dicts]
    apis = {path: {"items": []} for path in (
        "/apis/policy/v1beta1/poddisruptionbudgets", "/api/v1/services",
        "/apis/storage.k8s.io/v1/storageclasses", "/api/v1/persistentvolumeclaims",
        "/api/v1/configmaps", "/apis/apps/v1/daemonsets", "/apis/apps/v1/statefulsets",
        "/apis/apps/v1/replicasets",
    )}
    apis["/api/v1/nodes"] = {"items": list(node_dicts)}
    apis["/api/v1/pods"] = {"items": pods}
    return apis
