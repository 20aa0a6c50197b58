"""Pure-Python scheduling predicates — the host-side reference semantics.

These mirror the vendored kube-scheduler plugin predicates
(upstream `vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/*`)
and serve three roles:
 1. DaemonSet eligibility during pod synthesis (parity with the daemon
    controller `Predicates`, `vendor/.../daemon/daemon_controller.go:1251`).
 2. Host-side victim selection in DefaultPreemption (engine/preemption.py).
 3. Label-selector matching for the encoder (ops/encode.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from .objects import (
    LabelSelector,
    LabelSelectorRequirement,
    Node,
    NodeSelectorTerm,
    Pod,
    Taint,
    Toleration,
)


def _match_expression(labels: Dict[str, str], e: LabelSelectorRequirement) -> bool:
    val = labels.get(e.key)
    if e.operator == "In":
        return val is not None and val in e.values
    if e.operator == "NotIn":
        return val is None or val not in e.values
    if e.operator == "Exists":
        return val is not None
    if e.operator == "DoesNotExist":
        return val is None
    if e.operator in ("Gt", "Lt"):
        if val is None or not e.values:
            return False
        try:
            lhs, rhs = int(val), int(e.values[0])
        except ValueError:
            return False
        return lhs > rhs if e.operator == "Gt" else lhs < rhs
    return False


def match_label_selector(selector: Optional[LabelSelector], labels: Dict[str, str]) -> bool:
    """metav1.LabelSelector semantics; a nil selector matches nothing, an empty
    selector matches everything (upstream labels.Selector behavior)."""
    if selector is None:
        return False
    for k, v in selector.match_labels.items():
        if labels.get(k) != v:
            return False
    for e in selector.match_expressions:
        if not _match_expression(labels, e):
            return False
    return True


def match_node_selector_term(term: NodeSelectorTerm, labels: Dict[str, str]) -> bool:
    """One NodeSelectorTerm: AND of its expressions. Empty term matches nothing
    (parity with upstream nodeaffinity helpers)."""
    if not term.match_expressions:
        return False
    return all(_match_expression(labels, e) for e in term.match_expressions)


def match_node_affinity(pod: Pod, node: Node) -> bool:
    """Required node affinity + plain nodeSelector (NodeAffinity filter plugin)."""
    labels = node.meta.labels
    for k, v in pod.node_selector.items():
        if labels.get(k) != v:
            return False
    terms = pod.affinity.node_required
    if terms:
        if not any(match_node_selector_term(t, labels) for t in terms):
            return False
    return True


def toleration_tolerates(t: Toleration, taint: Taint) -> bool:
    """Upstream Toleration.ToleratesTaint: an empty key matches every taint key;
    an empty operator means Equal."""
    if t.effect and t.effect != taint.effect:
        return False
    if t.key and t.key != taint.key:
        return False
    if t.operator == "Exists":
        return True
    if t.operator in ("", "Equal"):
        return t.value == taint.value
    return False


def tolerations_tolerate_taint(tolerations: Iterable[Toleration], taint: Taint) -> bool:
    return any(toleration_tolerates(t, taint) for t in tolerations)


_WILDCARD_IPS = ("", "0.0.0.0")


def untolerated_taint(pod_tolerations: List[Toleration], node: Node) -> Optional[Taint]:
    """First NoSchedule/NoExecute taint not tolerated (TaintToleration filter)."""
    for taint in node.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not tolerations_tolerate_taint(pod_tolerations, taint):
            return taint
    return None


def fits_resources(pod: Pod, free: Dict[str, int]) -> List[str]:
    """NodeResourcesFit: returns the list of insufficient resource names."""
    bad = []
    for name, req in pod.requests.items():
        if req <= 0:
            continue
        if req > free.get(name, 0):
            bad.append(name)
    return bad


def daemonset_should_run(pod: Pod, node: Node) -> bool:
    """Should a DaemonSet pod run on this node?

    Parity with `utils.NodeShouldRunPod` / the daemon controller Predicates
    (upstream `pkg/utils/utils.go:325-366`): node affinity + taints with
    the auto-added unschedulable toleration. Resources are NOT checked here —
    the scheduler decides that later.
    """
    if pod.node_name and pod.node_name != node.name:
        return False
    if not match_node_affinity(pod, node):
        return False
    tols = list(pod.tolerations) + [
        Toleration(key="node.kubernetes.io/unschedulable", operator="Exists", effect="NoSchedule"),
        Toleration(key="node.kubernetes.io/not-ready", operator="Exists", effect="NoExecute"),
        Toleration(key="node.kubernetes.io/unreachable", operator="Exists", effect="NoExecute"),
        Toleration(key="node.kubernetes.io/disk-pressure", operator="Exists", effect="NoSchedule"),
        Toleration(key="node.kubernetes.io/memory-pressure", operator="Exists", effect="NoSchedule"),
        Toleration(key="node.kubernetes.io/pid-pressure", operator="Exists", effect="NoSchedule"),
    ]
    return untolerated_taint(tols, node) is None
