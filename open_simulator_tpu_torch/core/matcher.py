"""Label-selector matching used by the encoder (pure Python).

Mirrors the vendored kube-scheduler predicate semantics: a nil selector
matches nothing, an empty selector matches everything.
"""

from __future__ import annotations

from typing import Dict, Optional

from .objects import LabelSelector, LabelSelectorRequirement

# hostIP values that overlap every other hostIP (NodePorts semantics)
_WILDCARD_IPS = ("", "0.0.0.0")


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
