"""Apiserver-grade object validation (the essential subset).

Parity: the reference validates every synthesized pod and imported node with
the vendored apiserver validation before simulating — `utils.ValidatePod` /
`utils.ValidateNode` (upstream `pkg/utils/utils.go:495-508`, backed by
`vendor/k8s.io/kubernetes/pkg/apis/core/validation`) — and fails the whole
simulation on the first invalid object. This module ports the checks that
matter for scheduling fidelity: metadata names/labels, container shape,
resource sanity, and selector validity; messages follow the apiserver's
`field.Error` style so diagnostics read the same.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .objects import Node, Pod

_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$"
)
_QUALIFIED_PART = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_LABEL_VALUE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")

_LABEL_MSG = (
    "a lowercase RFC 1123 label must consist of lower case alphanumeric "
    "characters or '-', and must start and end with an alphanumeric character"
)
_SUBDOMAIN_MSG = (
    "a lowercase RFC 1123 subdomain must consist of lower case alphanumeric "
    "characters, '-' or '.', and must start and end with an alphanumeric "
    "character"
)


class ValidationError(ValueError):
    """Raised when an object fails apiserver-style validation."""


def _dns1123_label(value: str, max_len: int = 63) -> Optional[str]:
    if len(value) > max_len:
        return f"must be no more than {max_len} characters"
    if not _DNS1123_LABEL.match(value):
        return _LABEL_MSG
    return None


def _dns1123_subdomain(value: str) -> Optional[str]:
    if len(value) > 253:
        return "must be no more than 253 characters"
    if not _DNS1123_SUBDOMAIN.match(value):
        return _SUBDOMAIN_MSG
    return None


def _qualified_name(value: str) -> Optional[str]:
    parts = value.split("/")
    if len(parts) > 2:
        return "a qualified name must consist of a name and an optional prefix"
    if len(parts) == 2:
        prefix, name = parts
        if not prefix or _dns1123_subdomain(prefix) is not None:
            return "prefix part " + _SUBDOMAIN_MSG
    else:
        name = parts[0]
    if not name or len(name) > 63 or not _QUALIFIED_PART.match(name):
        return (
            "name part must consist of alphanumeric characters, '-', '_' or "
            "'.', and must start and end with an alphanumeric character"
        )
    return None


def _validate_labels(labels: Dict[str, str], path: str, errs: List[str]) -> None:
    for k, v in labels.items():
        msg = _qualified_name(k)
        if msg is not None:
            errs.append(f"{path}: Invalid value: {k!r}: {msg}")
        if len(v) > 63 or not _LABEL_VALUE.match(v):
            errs.append(
                f"{path}: Invalid value: {v!r}: a valid label value must be "
                "an empty string or consist of alphanumeric characters, '-', "
                "'_' or '.', and must start and end with an alphanumeric "
                "character"
            )


_RESTART_POLICIES = ("", "Always", "OnFailure", "Never")


def validate_pod(pod: Pod) -> List[str]:
    """Field errors for one pod; empty list = valid."""
    errs: List[str] = []
    name, namespace = pod.meta.name, pod.meta.namespace
    if not name:
        errs.append("metadata.name: Required value: name or generateName is required")
    else:
        msg = _dns1123_subdomain(name)
        if msg is not None:
            errs.append(f"metadata.name: Invalid value: {name!r}: {msg}")
    if not namespace:
        errs.append("metadata.namespace: Required value")
    else:
        msg = _dns1123_label(namespace)
        if msg is not None:
            errs.append(f"metadata.namespace: Invalid value: {namespace!r}: {msg}")
    _validate_labels(pod.meta.labels, "metadata.labels", errs)

    spec = (pod.raw.get("spec") or {}) if isinstance(pod.raw, dict) else {}
    containers = spec.get("containers")
    if not containers:
        errs.append("spec.containers: Required value")
        containers = []
    seen = set()
    for i, c in enumerate(containers):
        cname = (c or {}).get("name", "")
        if not cname:
            errs.append(f"spec.containers[{i}].name: Required value")
        else:
            msg = _dns1123_label(cname)
            if msg is not None:
                errs.append(
                    f"spec.containers[{i}].name: Invalid value: {cname!r}: {msg}"
                )
            if cname in seen:
                errs.append(
                    f"spec.containers[{i}].name: Duplicate value: {cname!r}"
                )
            seen.add(cname)
        if not (c or {}).get("image"):
            errs.append(f"spec.containers[{i}].image: Required value")

    policy = spec.get("restartPolicy", "")
    if policy not in _RESTART_POLICIES:
        errs.append(
            f"spec.restartPolicy: Unsupported value: {policy!r}: supported "
            'values: "Always", "OnFailure", "Never"'
        )

    for res, q in pod.requests.items():
        if q < 0:
            errs.append(
                f"spec.containers[0].resources.requests[{res}]: Invalid "
                f"value: must be greater than or equal to 0"
            )
    for res, q in pod.limits.items():
        if q < 0:
            errs.append(
                f"spec.containers[0].resources.limits[{res}]: Invalid value: "
                f"must be greater than or equal to 0"
            )
        req = pod.requests.get(res, 0)
        if q >= 0 and req > q:
            errs.append(
                f"spec.containers[0].resources.requests[{res}]: Invalid "
                f"value: must be less than or equal to {res} limit"
            )

    for k, v in pod.node_selector.items():
        msg = _qualified_name(k)
        if msg is not None:
            errs.append(f"spec.nodeSelector: Invalid value: {k!r}: {msg}")
    return errs


def validate_node(node: Node) -> List[str]:
    """Field errors for one node; empty list = valid."""
    errs: List[str] = []
    if not node.name:
        errs.append("metadata.name: Required value")
    else:
        msg = _dns1123_subdomain(node.name)
        if msg is not None:
            errs.append(f"metadata.name: Invalid value: {node.name!r}: {msg}")
    _validate_labels(node.meta.labels, "metadata.labels", errs)
    for res, q in node.allocatable.items():
        if q < 0:
            errs.append(
                f"status.allocatable[{res}]: Invalid value: must be greater "
                "than or equal to 0"
            )
    return errs


def check_pods(pods, where: str = "") -> None:
    """Raise ValidationError on the first invalid pod (the reference fails the
    whole Simulate on one invalid object, utils.go:60-67)."""
    for pod in pods:
        errs = validate_pod(pod)
        if errs:
            ctx = f" in {where}" if where else ""
            raise ValidationError(
                f"invalid pod {pod.key}{ctx}: " + "; ".join(errs)
            )


def check_nodes(nodes) -> None:
    for node in nodes:
        errs = validate_node(node)
        if errs:
            raise ValidationError(
                f"invalid node {node.name}: " + "; ".join(errs)
            )
