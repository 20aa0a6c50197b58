"""The benchmark's one generator: cluster manifests from a configuration
file, and each call's app manifests from a traffic file.

A configuration (`configs/<name>.json`) describes its nodes under "nodes":
`count`, a `name` pattern with `{i}`, and per-node `labels`, `allocatable`
and `capacity` maps whose values are one of

  "16Gi"                      the same value on every node
  {"cycle": [a, b, c]}        value i % 3 on node i
  {"shuffle": [a, b, c]}      a balanced multiset (each value on a third of
                              the nodes) in an order drawn from the seed

plus `taints` (`every`: the taint on every k-th node, from node 0) and
optional `types`, each with a `count` and its own maps, laid out in a
seeded order (`type_order: "shuffle"`) or in blocks. Capacity defaults to
the allocatable map, as a kubelet reports both.

A traffic mix (`traffic/<name>.json`) lists `workloads` (templates with
cpu, memory, labels, spread, tolerations, node_selector, gpu_mem and
gpu_count; `repeat` makes numbered copies) and `per_call` lists: for every
call each list is dealt to the workload slots in an order drawn from the
seed, so every call has the same shapes and pod total, and only which slot
gets which value changes. Deployment and app names carry the call's index.
`apps` is "one_per_workload" (the default: each workload its own app, in
slot order) or "one_app" (all of them in one app, which simon orders).

Every draw comes from numpy's PCG64 seeded by (seed, stream): the same seed
gives the same manifests, and a seed of any size is taken.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent

ANNO_GPU_MEM = "alibabacloud.com/gpu-mem"
ANNO_GPU_COUNT = "alibabacloud.com/gpu-count"
HOSTNAME = "kubernetes.io/hostname"

# stream ids of the seed's generators
_NODES, _CALL, _WARM, _SAMPLE = 0, 1, 2, 3


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    """`<root>/<kind>/<name>.json`: a configuration or a traffic mix."""
    path = root / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def _balanced(values: list, n: int, r: np.random.Generator) -> list:
    tiled = [values[i % len(values)] for i in range(n)]
    return [tiled[j] for j in r.permutation(n)]


def _column(spec, n: int, r: np.random.Generator) -> list:
    """The values of one node field over `n` nodes."""
    if isinstance(spec, dict):
        if "cycle" in spec:
            vals = spec["cycle"]
            return [vals[i % len(vals)] for i in range(n)]
        if "shuffle" in spec:
            return _balanced(spec["shuffle"], n, r)
        raise ValueError(f"unknown node field spec {spec!r}")
    return [spec] * n


def _columns(maps: Dict[str, object], n: int, r: np.random.Generator) -> Dict[str, list]:
    return {k: _column(v, n, r) for k, v in sorted(maps.items())}


def cluster(config: dict, seed: int) -> List[dict]:
    """The configuration's Node manifests, in node order."""
    spec = config["nodes"]
    n = int(spec["count"])
    r = rng(seed, _NODES)
    types = spec.get("types") or [{"count": n}]
    if sum(int(t["count"]) for t in types) != n:
        raise ValueError("node types do not add up to the node count")
    type_of = np.repeat(np.arange(len(types)), [int(t["count"]) for t in types])
    if spec.get("type_order", "blocks") == "shuffle":
        type_of = type_of[r.permutation(n)]
    labels = _columns(spec.get("labels", {}), n, r)
    alloc = _columns(spec.get("allocatable", {}), n, r)
    cap = _columns(spec.get("capacity", {}), n, r)
    nodes = []
    for i in range(n):
        t = types[int(type_of[i])]
        name = spec["name"].format(i=i)
        lab = {HOSTNAME: name}
        lab.update({k: str(v[i]) for k, v in labels.items()})
        lab.update({k: str(v) for k, v in t.get("labels", {}).items()})
        a = {k: str(v[i]) for k, v in alloc.items()}
        a.update({k: str(v) for k, v in t.get("allocatable", {}).items()})
        c = {k: str(v[i]) for k, v in cap.items()}
        c.update({k: str(v) for k, v in t.get("capacity", {}).items()})
        taints = [
            {"key": tt["key"], "value": tt.get("value", ""), "effect": tt["effect"]}
            for tt in spec.get("taints", [])
            if i % int(tt.get("every", 1)) == 0
        ]
        nodes.append({
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": lab},
            "spec": {"taints": taints} if taints else {},
            "status": {"allocatable": a, "capacity": c or dict(a)},
        })
    return nodes


def slots(traffic: dict) -> List[dict]:
    """The traffic's workload slots, `repeat` expanded (base names
    `<name>-<k>`)."""
    out = []
    for w in traffic["workloads"]:
        k = int(w.get("repeat", 1))
        for j in range(k):
            s = {key: val for key, val in w.items() if key != "repeat"}
            if k > 1:
                s["name"] = f"{w['name']}-{j}"
            out.append(s)
    return out


def _deployment(slot: dict, tag: str, namespace: str) -> dict:
    base = slot["name"]
    labels = dict(slot.get("labels") or {"app": base})
    requests = {"cpu": slot["cpu"], "memory": slot["memory"]}
    pod_spec: dict = {"containers": [{
        "name": "main", "image": f"registry.local/{base}:1",
        "resources": {"requests": requests, "limits": dict(requests)},
    }]}
    if slot.get("tolerations"):
        pod_spec["tolerations"] = [dict(t) for t in slot["tolerations"]]
    if slot.get("node_selector"):
        pod_spec["nodeSelector"] = dict(slot["node_selector"])
    if slot.get("spread"):
        pod_spec["topologySpreadConstraints"] = [{
            "maxSkew": int(c["max_skew"]), "topologyKey": c["key"],
            "whenUnsatisfiable": c["when"],
            "labelSelector": {"matchLabels": dict(labels)},
        } for c in slot["spread"]]
    annotations = {}
    if slot.get("gpu_mem") is not None:
        annotations[ANNO_GPU_MEM] = str(slot["gpu_mem"])
    if slot.get("gpu_count") is not None:
        annotations[ANNO_GPU_COUNT] = str(slot["gpu_count"])
    template_meta: dict = {"labels": labels}
    if annotations:
        template_meta["annotations"] = annotations
    return {
        "apiVersion": "apps/v1", "kind": slot.get("kind", "Deployment"),
        "metadata": {"name": f"{base}-{tag}", "namespace": namespace},
        "spec": {
            "replicas": int(slot["replicas"]),
            "selector": {"matchLabels": dict(labels)},
            "template": {"metadata": template_meta, "spec": pod_spec},
        },
    }


def call_apps(traffic: dict, seed: int, call: int) -> List[Tuple[str, List[dict]]]:
    """The apps of one call, as (app name, [workload manifests]) in the
    order they are submitted. Call -1 is the set-up's warm call, drawn from
    a stream of its own."""
    r = rng(seed, _WARM) if call < 0 else rng(seed, _CALL, call)
    tag = "warm" if call < 0 else f"c{call}"
    sl = slots(traffic)
    for field, values in sorted(traffic.get("per_call", {}).items()):
        if len(values) != len(sl):
            raise ValueError(f"per_call {field}: {len(values)} values for {len(sl)} slots")
        order = r.permutation(len(sl))
        for s, j in zip(sl, order):
            s[field] = values[int(j)]
    ns = traffic.get("namespace", "default")
    deps = [_deployment(s, tag, ns) for s in sl]
    total = sum(d["spec"]["replicas"] for d in deps)
    if total != int(traffic["pods_per_call"]):
        raise ValueError(f"a call of {total} pods; the traffic fixes {traffic['pods_per_call']}")
    layout = traffic.get("apps", "one_per_workload")
    if layout == "one_per_workload":
        return [(d["metadata"]["name"], [d]) for d in deps]
    if layout == "one_app":
        return [(f"apps-{tag}", deps)]
    raise ValueError(f"unknown apps layout {layout!r}")


def check_pool(traffic: dict, seed: int):
    """The calls whose results are compared with the reference, fixed
    before the window opens: `check.calls` indices drawn from the seed among
    the first `check.among_first`, or None for every call ("all")."""
    chk = traffic.get("check", {"calls": "all"})
    if chk.get("calls") == "all":
        return None
    r = rng(seed, _SAMPLE)
    return {int(k) for k in r.permutation(int(chk["among_first"]))[: int(chk["calls"])]}


def sample_calls(pool, n_calls: int) -> List[int]:
    """The sample of a window of `n_calls`: the pool's calls, where a window
    shorter than the pool gives its last call instead."""
    if pool is None:
        return list(range(n_calls))
    return sorted({min(k, n_calls - 1) for k in pool}) if n_calls else []
