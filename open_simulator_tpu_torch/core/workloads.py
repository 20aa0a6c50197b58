"""Workload → Pod expansion (pod synthesis).

Parity targets in the reference:
  - Deployment→ReplicaSet→Pods    upstream pkg/utils/utils.go:132-171
  - Job / CronJob                 utils.go:173-217
  - StatefulSet (+ volumeClaimTemplates → local-storage annotation) utils.go:219-292
  - DaemonSet (per-node eligibility via daemon-controller Predicates) utils.go:325-366
  - MakeValidPod normalization    utils.go:378-463
  - pod name = "<owner>-<rand10>" (STS renamed "<name>-<ordinal>") utils.go:311-313

Randomized suffixes are generated from a seeded RNG so simulations are
deterministic (the reference uses k8s rand.String(10); determinism there is
irrelevant because names never affect placement).
"""

from __future__ import annotations

import copy
import json
import random
import string
from typing import Dict, List, Optional

from .objects import (
    ANNO_POD_LOCAL_STORAGE,
    ANNO_WORKLOAD_KIND,
    ANNO_WORKLOAD_NAME,
    ANNO_WORKLOAD_NAMESPACE,
    HDD_SC_NAMES,
    LVM_SC_NAMES,
    SSD_SC_NAMES,
    Node,
    Pod,
)
from .matcher import daemonset_should_run
from ..utils.quantity import parse_int

# Workload kind strings (parity: pkg/type/const.go workload kinds)
DEPLOYMENT = "Deployment"
REPLICASET = "ReplicaSet"
STATEFULSET = "StatefulSet"
DAEMONSET = "DaemonSet"
JOB = "Job"
CRONJOB = "CronJob"
POD = "Pod"

WORKLOAD_KINDS = {DEPLOYMENT, REPLICASET, STATEFULSET, DAEMONSET, JOB, CRONJOB, POD}

# Seed of the pod-name RNG; the JAX package draws from the same seed, so
# generated names (and every digest over them) agree between the packages.
NAME_RNG_SEED = 0x51B0
_rng = random.Random(NAME_RNG_SEED)


def _clone_pod(proto: Pod, name: str) -> Pod:
    """Cheap per-replica clone of a parsed template pod.

    Replicas of one workload differ only in name: metadata (name + mutable
    label/annotation/request dicts) is fresh per clone, while the spec-derived
    immutable structures (affinity, tolerations, spread constraints, host
    ports) are shared — the engine never mutates those. This replaces the
    reference's per-replica template deep-copy (utils.go:139-150) and is what
    makes 100k-pod expansion a data-loader, not a bottleneck."""
    import dataclasses

    raw = dict(proto.raw)
    raw_meta = dict(raw.get("metadata") or {})
    raw_meta["name"] = name
    raw["metadata"] = raw_meta
    meta = dataclasses.replace(
        proto.meta,
        name=name,
        labels=dict(proto.meta.labels),
        annotations=dict(proto.meta.annotations),
    )
    return dataclasses.replace(
        proto,
        meta=meta,
        requests=dict(proto.requests),
        limits=dict(proto.limits),
        raw=raw,
    )


def reset_name_rng(seed: int = NAME_RNG_SEED) -> None:
    _rng.seed(seed)


def _rand_suffix(n: int = 10) -> str:
    alphabet = string.ascii_lowercase + string.digits
    return "".join(_rng.choice(alphabet) for _ in range(n))


def _pod_dict_from_template(owner: dict, kind: str, template: dict) -> dict:
    meta = owner.get("metadata") or {}
    tmeta = template.get("metadata") or {}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{meta.get('name', 'pod')}-{_rand_suffix()}",
            "generateName": meta.get("name", ""),
            "namespace": meta.get("namespace") or "default",
            "labels": copy.deepcopy(tmeta.get("labels") or {}),
            "annotations": copy.deepcopy(tmeta.get("annotations") or {}),
            "ownerReferences": [
                {
                    "kind": kind,
                    "name": meta.get("name", ""),
                    "controller": True,
                }
            ],
        },
        "spec": copy.deepcopy(template.get("spec") or {}),
    }


def make_valid_pod_dict(pod: dict) -> dict:
    """MakeValidPod normalization (utils.go:378-463): defaults, strip env/
    volumeMounts/probes/pull-secrets, PVC volumes → hostPath, empty status."""
    pod = copy.deepcopy(pod)
    meta = pod.setdefault("metadata", {})
    meta.setdefault("labels", {})
    meta.setdefault("annotations", {})
    if not meta.get("namespace"):
        meta["namespace"] = "default"
    spec = pod.setdefault("spec", {})
    spec.setdefault("dnsPolicy", "ClusterFirst")
    spec.setdefault("restartPolicy", "Always")
    spec.setdefault("schedulerName", "default-scheduler")
    spec.pop("imagePullSecrets", None)
    for section in ("initContainers", "containers"):
        for c in spec.get(section) or []:
            c.setdefault("terminationMessagePolicy", "FallbackToLogsOnError")
            c.setdefault("imagePullPolicy", "IfNotPresent")
            sc = c.get("securityContext")
            if sc and "privileged" in sc:
                sc["privileged"] = False
            c.pop("volumeMounts", None)
            c.pop("env", None)
            if section == "containers":
                c.pop("livenessProbe", None)
                c.pop("readinessProbe", None)
                c.pop("startupProbe", None)
    for v in spec.get("volumes") or []:
        if isinstance(v, dict) and v.get("persistentVolumeClaim"):
            v.pop("persistentVolumeClaim")
            v["hostPath"] = {"path": "/tmp"}
    pod["status"] = {}
    return pod


def _add_workload_info(pod: dict, kind: str, name: str, namespace: str) -> dict:
    anns = pod["metadata"].setdefault("annotations", {})
    anns[ANNO_WORKLOAD_KIND] = kind
    anns[ANNO_WORKLOAD_NAME] = name
    anns[ANNO_WORKLOAD_NAMESPACE] = namespace or "default"
    return pod


def _storage_annotation(volume_claim_templates: List[dict]) -> Optional[str]:
    """volumeClaimTemplates → simon/pod-local-storage annotation (utils.go:246-292)."""
    volumes = []
    for pvc in volume_claim_templates or []:
        spec = pvc.get("spec") or {}
        sc = spec.get("storageClassName")
        size = parse_int(
            ((spec.get("resources") or {}).get("requests") or {}).get("storage", 0)
        )
        if sc in LVM_SC_NAMES:
            kind = "LVM"
        elif sc in SSD_SC_NAMES:
            kind = "SSD"
        elif sc in HDD_SC_NAMES:
            kind = "HDD"
        else:
            continue  # unsupported storage class — reference logs an error
        # Field names/stringly size match the reference's ffjson encoding of
        # utils.Volume (`json:"size,string"`, `json:"scName"`).
        volumes.append({"size": str(size), "kind": kind, "scName": sc})
    if not volumes:
        return None
    return json.dumps({"volumes": volumes})


def pods_from_workload(obj: dict, nodes: Optional[List[Node]] = None) -> List[Pod]:
    """Expand one decoded workload object into scheduling-ready Pods."""
    kind = obj.get("kind", "")
    meta = obj.get("metadata") or {}
    name = meta.get("name", "")
    namespace = meta.get("namespace") or "default"
    spec = obj.get("spec") or {}
    out: List[dict] = []

    if kind == POD:
        p = make_valid_pod_dict(obj)
        out.append(p)
    elif kind in (DEPLOYMENT, REPLICASET):
        # Deployment pods are annotated as ReplicaSet-owned (utils.go:132-135)
        return _expand_replicas(
            obj, REPLICASET, spec.get("template") or {},
            spec.get("replicas", 1), REPLICASET, name, namespace,
            name_fn=None,
        )
    elif kind == STATEFULSET:
        storage_ann = _storage_annotation(spec.get("volumeClaimTemplates") or [])
        return _expand_replicas(
            obj, STATEFULSET, spec.get("template") or {},
            spec.get("replicas", 1), STATEFULSET, name, namespace,
            name_fn=lambda ordinal: f"{name}-{ordinal}",
            # unconditional: volumeClaimTemplates are the source of truth for
            # the storage annotation, overriding any template-supplied value
            # (utils.go:246-292 always assigns)
            force_annotations=(
                {ANNO_POD_LOCAL_STORAGE: storage_ann} if storage_ann else None
            ),
        )
    elif kind == JOB:
        return _expand_replicas(
            obj, JOB, spec.get("template") or {},
            spec.get("completions", 1), JOB, name, namespace, name_fn=None,
        )
    elif kind == CRONJOB:
        job_spec = (spec.get("jobTemplate") or {}).get("spec") or {}
        return _expand_replicas(
            obj, JOB, job_spec.get("template") or {},
            job_spec.get("completions", 1), JOB, name, namespace,
            name_fn=None,
            extra_annotations={"cronjob.kubernetes.io/instantiate": "manual"},
        )
    elif kind == DAEMONSET:
        return daemonset_pods(obj, nodes or [])
    else:
        raise ValueError(f"unsupported workload kind: {kind}")
    return [Pod.from_dict(p) for p in out]


def _expand_replicas(
    owner: dict,
    owner_kind: str,
    template: dict,
    count,
    info_kind: str,
    name: str,
    namespace: str,
    name_fn,
    extra_annotations: Optional[Dict[str, str]] = None,
    force_annotations: Optional[Dict[str, str]] = None,
) -> List[Pod]:
    """Expand one template into `count` replica Pods: the first replica is
    fully synthesized + validated + parsed (the reference's MakeValidPod path,
    utils.go:139-171,378-463), the rest are cheap clones of that prototype —
    replicas are spec-identical by construction. extra_annotations are
    defaults (template wins); force_annotations always overwrite."""
    n = int(count if count is not None else 1)
    if n <= 0:
        return []
    d = make_valid_pod_dict(_pod_dict_from_template(owner, owner_kind, template))
    _add_workload_info(d, info_kind, name, namespace)
    if extra_annotations:
        for k, v in extra_annotations.items():
            d["metadata"]["annotations"].setdefault(k, v)
    if force_annotations:
        d["metadata"]["annotations"].update(force_annotations)
    if name_fn is not None:
        d["metadata"]["name"] = name_fn(0)
    proto = Pod.from_dict(d)
    pods = [proto]
    for i in range(1, n):
        pod_name = name_fn(i) if name_fn is not None else f"{name}-{_rand_suffix()}"
        pods.append(_clone_pod(proto, pod_name))
    return pods


def daemonset_pods(ds: dict, nodes: List[Node]) -> List[Pod]:
    """One pod per eligible node, pinned via required node affinity on the
    hostname — parity with NewDaemonPod/SetDaemonSetPodNodeNameByNodeAffinity
    (utils.go:338-366, 466-493)."""
    meta = ds.get("metadata") or {}
    name = meta.get("name", "")
    namespace = meta.get("namespace") or "default"
    template = (ds.get("spec") or {}).get("template") or {}
    pods: List[Pod] = []
    for node in nodes:
        d = _pod_dict_from_template(ds, DAEMONSET, template)
        spec = d["spec"]
        pin = {"key": "metadata.name", "operator": "In", "values": [node.name]}
        aff = spec.setdefault("affinity", {})
        node_aff = aff.setdefault("nodeAffinity", {})
        req = node_aff.setdefault("requiredDuringSchedulingIgnoredDuringExecution", {})
        terms = req.get("nodeSelectorTerms")
        if terms:
            # AND the node-name pin into every existing term, keeping the
            # template's matchExpressions (utils.go:806-813).
            for t in terms:
                t["matchFields"] = [pin]
        else:
            req["nodeSelectorTerms"] = [{"matchFields": [pin]}]
        p = make_valid_pod_dict(d)
        pod = Pod.from_dict(_add_workload_info(p, DAEMONSET, name, namespace))
        if daemonset_should_run(pod, node):
            pods.append(pod)
    return pods
