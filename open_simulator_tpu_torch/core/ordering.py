"""Pod-ordering queues applied before submission to the scheduler.

Parity: upstream `pkg/algo/` —
  - AffinityQueue (affinity.go): pods with a nodeSelector first
  - TolerationQueue (toleration.go): pods with tolerations first
  - GreedQueue (greed.go): node-pinned pods first, then descending dominant
    cpu/memory share of the cluster total (`calculatePodShare` :50-67,
    `Share` :70-83)

ScheduleApp always applies affinity then toleration (simulator.go:238-241).
The reference's `--use-greed` flag exists but GreedQueue is never wired in
(dead option, SURVEY §2.1 #14); here the flag actually works — greed ordering
runs first, then the affinity/toleration stable sorts, so the reference's
default ordering is preserved within equal-share groups.

All sorts are STABLE (Python sorted), unlike Go's sort.Sort; the reference's
orderings are therefore reproduced deterministically rather than
arbitrarily-among-equals.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .objects import CPU, MEMORY, Node, Pod


def share(alloc: float, total: float) -> float:
    """algo.Share (greed.go:70-83)."""
    if total == 0:
        return 0.0 if alloc == 0 else 1.0
    return alloc / total


def pod_dominant_share(pod: Pod, totals: Dict[str, float]) -> float:
    """Max share over cpu/memory of the cluster totals (greed.go:50-67)."""
    if not pod.requests:
        return 0.0
    res = 0.0
    for name, total in totals.items():
        res = max(res, share(float(pod.requests.get(name, 0)), total))
    return res


def cluster_totals(nodes: Sequence[Node]) -> Dict[str, float]:
    """Cluster-wide allocatable cpu+memory (greed.go:16-32)."""
    return {
        CPU: float(sum(n.allocatable.get(CPU, 0) for n in nodes)),
        MEMORY: float(sum(n.allocatable.get(MEMORY, 0) for n in nodes)),
    }


def greed_sort(pods: Sequence[Pod], nodes: Sequence[Node]) -> List[Pod]:
    """GreedQueue order: node-pinned pods first, then descending dominant
    share (bigger pods first — worst-fit pairing with the Simon score)."""
    totals = cluster_totals(nodes)
    return sorted(
        pods,
        key=lambda p: (not p.node_name, -pod_dominant_share(p, totals)),
    )


def affinity_sort(pods: Sequence[Pod]) -> List[Pod]:
    """AffinityQueue: nodeSelector pods first (affinity.go:21-23)."""
    return sorted(pods, key=lambda p: not p.node_selector)


def toleration_sort(pods: Sequence[Pod]) -> List[Pod]:
    """TolerationQueue: tolerating pods first (toleration.go:19-21)."""
    return sorted(pods, key=lambda p: not p.tolerations)


def order_pods(
    pods: Sequence[Pod],
    nodes: Sequence[Node] = (),
    use_greed: bool = False,
) -> List[Pod]:
    """The ScheduleApp ordering: optional greed pass, then affinity, then
    toleration (stable, so later sorts only reorder across their own key)."""
    out = list(pods)
    if use_greed:
        out = greed_sort(out, nodes)
    out = affinity_sort(out)
    return toleration_sort(out)
