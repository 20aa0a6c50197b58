"""The headline scheduling workload and a digest of its result.

`build_state` generates the capacity-planning cluster of the JAX package's
headline benchmark (bench.py:build_state there): the same seeded nodes
(three zones, three instance types, every tenth node tainted) and the same
four pod templates (a zone-spread web tier, a tolerating batch job, a
selector-pinned cache, a zone-spread sidecar), tiled to `n_pods` replicas.
`placement_digest` hashes a schedule's whole result so two runs (or the two
packages) can be compared with one string.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .core.objects import Node, Pod
from .device import DEFAULT_DEVICE
from .ops.encode import Encoder, encode_nodes, encode_pods, initial_selector_counts
from .ops.kernels import Carry
from .ops.state import carry_from_table, node_static_from_table
from .ops.tile import tile_pod_batch

# placement_digest of the JAX package's schedule_batch_fast on
# build_state(10000, 100000) — the reference result the port must reproduce
HEADLINE_DIGEST_100K_10K = (
    "sha256:6aef7345175a2f1d34dd01c734043eeaa559ef579402cf3673b6eb7a561fcea4"
)


def build_state(n_nodes: int, n_pods: int, device=DEFAULT_DEVICE):
    """(NodeStatic, Carry, PodBatch) of the headline cluster."""
    rng = np.random.default_rng(0)
    nodes = []
    for i in range(n_nodes):
        taints = (
            [{"key": "dedicated", "value": "batch", "effect": "NoSchedule"}]
            if i % 10 == 0 else []
        )
        nodes.append(Node.from_dict({
            "metadata": {
                "name": f"node-{i}",
                "labels": {
                    "kubernetes.io/hostname": f"node-{i}",
                    "topology.kubernetes.io/zone": f"az-{i % 3}",
                    "node.kubernetes.io/instance-type": ["m5.4x", "m5.8x", "c5.9x"][i % 3],
                },
            },
            "spec": {"taints": taints},
            "status": {
                "allocatable": {
                    "cpu": str(16 + 16 * int(rng.integers(0, 3))),
                    "memory": f"{32 + 32 * int(rng.integers(0, 3))}Gi",
                    "pods": "110",
                }
            },
        }))

    tmpl_specs = [
        dict(cpu="500m", mem="512Mi", labels={"app": "web"}, spread=True, tol=False, sel=None),
        dict(cpu="2", mem="4Gi", labels={"app": "batch"}, spread=False, tol=True, sel=None),
        dict(
            cpu="1", mem="2Gi", labels={"app": "cache"}, spread=False, tol=False,
            sel={"node.kubernetes.io/instance-type": "m5.8x"},
        ),
        dict(cpu="250m", mem="256Mi", labels={"app": "sidecar"}, spread=True, tol=False, sel=None),
    ]
    templates = []
    for t, s in enumerate(tmpl_specs):
        spec = {"containers": [
            {"name": "c", "resources": {"requests": {"cpu": s["cpu"], "memory": s["mem"]}}}
        ]}
        if s["spread"]:
            spec["topologySpreadConstraints"] = [{
                "maxSkew": 50,
                "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "ScheduleAnyway",
                "labelSelector": {"matchLabels": s["labels"]},
            }]
        if s["tol"]:
            spec["tolerations"] = [{
                "key": "dedicated", "operator": "Equal", "value": "batch",
                "effect": "NoSchedule",
            }]
        if s["sel"]:
            spec["nodeSelector"] = s["sel"]
        templates.append(Pod.from_dict({
            "metadata": {"name": f"tpl-{t}", "namespace": "bench", "labels": s["labels"]},
            "spec": spec,
        }))

    share = n_pods // len(templates)
    counts = [share] * len(templates)
    counts[0] += n_pods - share * len(templates)

    enc = Encoder()
    enc.register_pods(templates)
    table = encode_nodes(enc, nodes)
    batch = tile_pod_batch(encode_pods(enc, templates), counts)
    ns = node_static_from_table(enc, table, device)
    carry = carry_from_table(table, initial_selector_counts(enc, table, []), device=device)
    return ns, carry, batch


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def placement_digest(carry, nodes, reasons, take, vg_take, dev_take) -> str:
    """sha256 over the placements, reason rows, GPU/VG/device takes and every
    carry leaf (in Carry field order), each with its dtype and shape. Takes
    torch tensors, numpy arrays or any array numpy can read, so results of
    either package hash alike."""
    h = hashlib.sha256()
    leaves = [nodes, reasons, take, vg_take, dev_take] + [
        getattr(carry, f) for f in Carry._fields
    ]
    for a in leaves:
        arr = _host(a)
        h.update(f"{arr.dtype.str}{arr.shape}".encode())
        h.update(arr.tobytes())
    return "sha256:" + h.hexdigest()
