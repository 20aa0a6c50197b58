"""DefaultPreemption PostFilter: evict lower-priority pods to place a pod.

Parity target: the vendored default-preemption plugin,
`upstream vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/
defaultpreemption/default_preemption.go`:
  - PodEligibleToPreemptOthers (:231): preemptionPolicy != Never
  - nodesWherePreemptionMightHelp (:258): skip nodes whose filter failure is
    UnschedulableAndUnresolvable (taints, node affinity, node name,
    unschedulable flag — removing pods can't fix those)
  - selectVictimsOnNode (:578): remove ALL lower-priority pods, check fit,
    then reprieve PDB-violating victims first and non-violating second, each
    class from the most important pod down (MoreImportantPod = higher
    priority first)
  - filterPodsWithPDBViolation (:736): a victim violates a PDB when evicting
    it would drive the budget's DisruptionsAllowed below zero (budgets are
    decremented per selected victim)
  - pickOneNodeForPreemption (:443): fewest PDB violations → lowest highest
    victim priority → lowest victim-priority sum → fewest victims → first
    (the reference's final earliest-start-time tiebreaks have no analog here:
    the simulation has no pod start times)

Deviation (documented): feasibility during victim selection checks the
resolvable filters host-side — resources (CPU/mem/pods/extended) — on top of
the static unresolvable gate. Topology-spread/inter-pod-affinity/storage/GPU
coupling to victims is not modeled; the upstream plugin itself skips
affinity-to-victim coupling "for performance reasons" (:628-632).

This runs host-side: preemption is rare (only failed pods with priority > 0),
and its victim search is branch-heavy sequential logic that would serialize on
device anyway — the device path stays a pure batch scheduler, and preemption
re-syncs device state once per successful eviction round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.matcher import (
    fits_resources,
    match_label_selector,
    match_node_affinity,
    untolerated_taint,
)
from ..core.objects import LabelSelector, Node, Pod
from ..utils.tracing import log, span


@dataclass
class PodDisruptionBudget:
    """Decoded policy/v1beta1 PodDisruptionBudget (the reference syncs PDBs
    into the fake cluster, simulator.go:388-394)."""
    name: str
    namespace: str
    selector: Optional[LabelSelector]
    min_available: Optional[str] = None      # int or "NN%"
    max_unavailable: Optional[str] = None
    disruptions_allowed: Optional[int] = None  # from status, when present

    @staticmethod
    def from_dict(d: dict) -> "PodDisruptionBudget":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        da = status.get("disruptionsAllowed")
        return PodDisruptionBudget(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            selector=LabelSelector.from_dict(spec.get("selector")),
            min_available=_opt_str(spec.get("minAvailable")),
            max_unavailable=_opt_str(spec.get("maxUnavailable")),
            disruptions_allowed=int(da) if da is not None else None,
        )

    def matches(self, pod: Pod) -> bool:
        if not pod.meta.labels:
            return False  # "A pod with no labels will not match any PDB"
        if pod.meta.namespace != self.namespace:
            return False
        if self.selector is None:
            return False  # nil/empty selector matches nothing (:755)
        if not self.selector.match_labels and not self.selector.match_expressions:
            return False
        return match_label_selector(self.selector, pod.meta.labels)

    def allowed_disruptions(self, matching_healthy: int) -> int:
        """DisruptionsAllowed: status value when provided; otherwise derived
        from spec the way the disruption controller would for currently-
        healthy count `matching_healthy`."""
        if self.disruptions_allowed is not None:
            return self.disruptions_allowed
        if self.min_available is not None:
            need = _resolve_count(self.min_available, matching_healthy)
            return max(0, matching_healthy - need)
        if self.max_unavailable is not None:
            return max(0, _resolve_count(self.max_unavailable, matching_healthy))
        return 0


def _opt_str(v) -> Optional[str]:
    return None if v is None else str(v)


def _resolve_count(v: str, total: int) -> int:
    if v.endswith("%"):
        import math

        return math.ceil(float(v[:-1]) / 100.0 * total)
    return int(v)


@dataclass
class PreemptionResult:
    node: str
    victims: List[Pod]
    num_pdb_violations: int


def _static_unresolvable_ok(pod: Pod, node: Node) -> bool:
    """Filters whose failure preemption cannot fix (nodesWherePreemptionMight-
    Help skips UnschedulableAndUnresolvable nodes)."""
    if node.unschedulable and not _tolerates_unschedulable(pod):
        return False
    if pod.node_name and pod.node_name != node.name:
        return False
    if untolerated_taint(pod.tolerations, node) is not None:
        return False
    if not match_node_affinity(pod, node):
        return False
    return True


def _tolerates_unschedulable(pod: Pod) -> bool:
    for t in pod.tolerations:
        key_ok = not t.key or t.key == "node.kubernetes.io/unschedulable"
        val_ok = t.operator == "Exists" or not t.value
        eff_ok = not t.effect or t.effect == "NoSchedule"
        if key_ok and val_ok and eff_ok:
            return True
    return False


def _free_after(node: Node, pods: Sequence[Pod]) -> Dict[str, int]:
    free = dict(node.allocatable)
    free["pods"] = free.get("pods", 0)
    for p in pods:
        for res, q in p.requests.items():
            free[res] = free.get(res, 0) - q
        free["pods"] = free.get("pods", 0) - 1
    return free


def _fits(pod: Pod, node: Node, remaining: Sequence[Pod]) -> bool:
    free = _free_after(node, remaining)
    # pod.requests never carries the "pods" slot resource; check it explicitly
    # (the reference's full-filter dry run gets this via NodeResourcesFit).
    if free.get("pods", 0) < 1:
        return False
    return not fits_resources(pod, free)


def _more_important(p: Pod) -> Tuple:
    """Sort key for MoreImportantPod order (higher priority first; the
    start-time tiebreak has no analog — encoding order is stable)."""
    return (-p.priority,)


def _victim_candidates(
    pod: Pod,
    bound: Sequence[Pod],
    pdbs: Sequence[PodDisruptionBudget],
    pdb_allowed: Dict[int, int],
) -> Optional[Tuple[List[Pod], List[Tuple[Pod, bool]]]]:
    """The deterministic prefix of selectVictimsOnNode: (keep, ordered
    reprieve queue of (pod, violates_pdb)). Victims process in MoreImportant
    order, PDB-violating first, budgets decremented per candidate (:736)."""
    potential = [p for p in bound if p.priority < pod.priority]
    if not potential:
        return None
    keep = [p for p in bound if p.priority >= pod.priority]
    potential.sort(key=_more_important)
    allowed = dict(pdb_allowed)
    violating: List[Pod] = []
    non_violating: List[Pod] = []
    for p in potential:
        is_violating = False
        for i, pdb in enumerate(pdbs):
            if pdb.matches(p):
                allowed[i] = allowed.get(i, 0) - 1
                if allowed[i] < 0:
                    is_violating = True
        (violating if is_violating else non_violating).append(p)
    queue = [(p, True) for p in violating] + [(p, False) for p in non_violating]
    return keep, queue


@dataclass
class _Lane:
    """One candidate node's reprieve state in the lockstep lane rounds."""
    node: Node
    remaining: List[Pod]
    queue: List[Tuple[Pod, bool]]
    victims: List[Pod]
    num_violating: int = 0


def _drive_lanes(pod: Pod, lanes: List[_Lane], fits_many_fn) -> List[PreemptionResult]:
    """The single reprieve implementation (selectVictimsOnNode's loop,
    :595-660) run over any number of lanes in lockstep rounds: round 0 checks
    fit with every potential victim evicted, then each round every active
    lane tries to reprieve its k-th queued victim. Per-lane semantics are
    exactly the sequential algorithm — lanes are independent. Lanes whose
    reprieve run ends with no victims are dropped (the pod's real failure
    was a filter preemption can't fix there)."""
    if not lanes:
        return []
    fit0 = fits_many_fn(pod, [(l.node, l.remaining) for l in lanes])
    lanes = [l for l, ok in zip(lanes, fit0) if ok]
    max_q = max((len(l.queue) for l in lanes), default=0)
    for k in range(max_q):
        active = [l for l in lanes if k < len(l.queue)]
        if not active:
            break
        results = fits_many_fn(
            pod, [(l.node, l.remaining + [l.queue[k][0]]) for l in active]
        )
        for lane, ok in zip(active, results):
            p, is_violating = lane.queue[k]
            if ok:
                lane.remaining.append(p)   # reprieved
            else:
                lane.victims.append(p)
                if is_violating:
                    lane.num_violating += 1
    return [
        PreemptionResult(
            node=l.node.name, victims=l.victims,
            num_pdb_violations=l.num_violating,
        )
        for l in lanes
        if l.victims
    ]


def pick_one_node(candidates: List[PreemptionResult]) -> Optional[PreemptionResult]:
    """pickOneNodeForPreemption (:443) tiebreak cascade."""
    if not candidates:
        return None
    best = min(c.num_pdb_violations for c in candidates)
    pool = [c for c in candidates if c.num_pdb_violations == best]
    if len(pool) > 1:
        hi = min(max(v.priority for v in c.victims) for c in pool)
        pool = [c for c in pool if max(v.priority for v in c.victims) == hi]
    if len(pool) > 1:
        # Offset each victim by MaxInt32+1 (default_preemption.go:497-503) so
        # victim count dominates the sum even with negative priorities.
        def psum(c):
            return sum(v.priority + (1 << 31) for v in c.victims)

        s = min(psum(c) for c in pool)
        pool = [c for c in pool if psum(c) == s]
    if len(pool) > 1:
        n = min(len(c.victims) for c in pool)
        pool = [c for c in pool if len(c.victims) == n]
    return pool[0]


def call_preempt_extenders(
    extenders,
    pod: Pod,
    candidates: List[PreemptionResult],
    bound_by_node: Dict[str, List[Pod]],
    nodes: Sequence[Node] = (),
) -> List[PreemptionResult]:
    """CallExtenders (default_preemption.go:346-394): run the candidate map
    through every preemption-supporting, interested extender in chain order.
    Each extender may veto nodes or trim victims; its output feeds the next.
    An erroring ignorable extender is skipped; a non-ignorable one raises
    ExtenderError (the reference aborts the whole preemption). An empty map
    short-circuits — no preemption can happen regardless of later extenders.

    Candidates that pass through an extender come back with
    num_pdb_violations=0 — the vendored reconversion drops the count
    (extender.go:211-230); see HTTPExtender.process_preemption."""
    from .extenders import ExtenderError

    relevant = [
        e for e in extenders
        if e.supports_preemption and e.is_interested(pod)
    ]
    if not relevant or not candidates:
        return candidates
    victims_map = {
        c.node: (list(c.victims), c.num_pdb_violations) for c in candidates
    }
    # NodeInfoLister analog (extender.go:214-217): every cluster node is
    # resolvable, with an empty pod list when nothing is bound there — an
    # extender answering with a pod-free node must not be misreported as
    # "unknown node".
    pods_on_node = {n.name: bound_by_node.get(n.name, []) for n in nodes}
    for name, pods in bound_by_node.items():
        pods_on_node.setdefault(name, pods)
    for ext in relevant:
        try:
            victims_map = ext.process_preemption(
                pod, victims_map, pods_on_node
            )
        except ExtenderError as e:
            if ext.is_ignorable:
                log.warning(
                    "skipping extender %s during preemption: %s (ignorable)",
                    ext.base, e,
                )
                continue
            raise
        if not victims_map:
            break
    return [
        PreemptionResult(node=node, victims=victims, num_pdb_violations=nv)
        for node, (victims, nv) in victims_map.items()
    ]


def try_preempt(
    pod: Pod,
    nodes: Sequence[Node],
    bound_by_node: Dict[str, List[Pod]],
    pdbs: Sequence[PodDisruptionBudget],
    fits_many_fn=None,
    extenders=(),
) -> Optional[PreemptionResult]:
    """Full PostFilter: find the best node + minimal victim set, or None.

    `fits_many_fn(pod, [(node, remaining), ...]) -> [bool]` enables the
    lane-parallel rounds: every candidate node advances its reprieve loop in
    lockstep rounds, so one preemptor costs 1 + max(queue length) batched fit
    evaluations instead of sum over nodes of (1 + queue length) single
    probes. Per-lane semantics are the sequential selectVictimsOnNode's —
    lanes are independent (budgets are per-candidate copies, :736). This is
    the engine's analog of the reference evaluating selectVictimsOnNode in
    parallel goroutines over candidate nodes (default_preemption.go:560-576).
    """
    if pod.preemption_policy == "Never":
        return None  # PodEligibleToPreemptOthers (:231)
    # budgets from current healthy counts
    all_bound = [p for pods in bound_by_node.values() for p in pods]
    pdb_allowed = {
        i: pdb.allowed_disruptions(sum(1 for p in all_bound if pdb.matches(p)))
        for i, pdb in enumerate(pdbs)
    }
    if fits_many_fn is None:
        def fits_many_fn(pod2, items):   # the host resources-only model
            return [_fits(pod2, n, remaining) for n, remaining in items]

    with span("preempt", pod=pod.key) as sp:
        lanes: List[_Lane] = []
        for node in nodes:
            if not _static_unresolvable_ok(pod, node):
                continue
            got = _victim_candidates(
                pod, bound_by_node.get(node.name, []), pdbs, pdb_allowed
            )
            if got is None:
                continue
            keep, queue = got
            lanes.append(_Lane(node=node, remaining=list(keep), queue=queue,
                               victims=[]))
        sp.meta["lanes"] = len(lanes)
        candidates = _drive_lanes(pod, lanes, fits_many_fn)
        # dryRunPreemption -> CallExtenders -> SelectCandidate (preempt(),
        # default_preemption.go:141-176): extenders see the full candidate
        # map between victim selection and the final pick
        candidates = call_preempt_extenders(extenders, pod, candidates, bound_by_node, nodes)
        # an extender may empty a node's victim list while keeping the node;
        # the pod reached preemption because it failed, so drop victimless
        # candidates as _drive_lanes does
        return pick_one_node([c for c in candidates if c.victims])
