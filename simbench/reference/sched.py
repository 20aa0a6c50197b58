"""The plain reference scheduler: kube-scheduler semantics in NumPy.

`schedule(node_manifests, apps)` parses the manifests itself (nodes; the
Deployments and ReplicaSets of each app), orders each app's pods as simon
does (nodeSelector pods first, then tolerating pods, both sorts stable),
and places the pods one at a time: every filter over every node, every
score over every node, the default weighted fold, the first node of the
highest total, and the commit. The semantics, per plugin:

  NodeUnschedulable   spec.unschedulable, unless the pod tolerates
                      node.kubernetes.io/unschedulable:NoSchedule
  TaintToleration     every NoSchedule/NoExecute taint tolerated; the score
                      counts untolerated PreferNoSchedule taints, reversed
                      and normalised by the largest count
  NodeAffinity        nodeSelector pairs and required terms (OR of terms,
                      AND of In/NotIn/Exists/DoesNotExist expressions)
  NodeResourcesFit    request <= free + 1e-3 in every resource (cpu in
                      millicores, byte-like resources in MiB, pods counted);
                      LeastAllocated and BalancedAllocation over cpu and
                      memory
  PodTopologySpread   per constraint, the pods matching its selector in the
                      pod's namespace, counted over the nodes that pass the
                      pod's node affinity: DoNotSchedule admits a node when
                      count(domain) + selfMatch - min(eligible domains) <=
                      maxSkew; ScheduleAnyway scores the summed counts,
                      100 * (max - count) / max
  open-gpu-share      a node passes when sum over its GPUs of
                      floor(free / gpu-mem) >= gpu-count; one GPU goes to
                      the tightest fit (lowest index on ties), more by the
                      in-order greedy take; the score is the worst-fit share
                      of the request in the node's allocatable, min-max
                      normalised
  Simon               the worst-fit share of the request in the node's
                      allocatable, floored to an integer, min-max normalised
  NodePreferAvoidPods 0 on annotated nodes for ReplicaSet-owned pods

Scores are float32, and each is computed in the order of operations the
scheduler states, so ties fall as they do there; the fold is the left fold
over FOLD with WEIGHTS. A pod that fits nowhere is reported with, for each
filter, how many nodes it was the first to reject.

Only what a node's own commit changes is recomputed after a placement (its
free resources, its GPUs, its partial score), and the spread counts are
kept per domain: every number is the one a full re-evaluation gives, at a
fraction of the cost, and a test holds the two equal. Features outside this
list (pod affinity, host ports, local storage, preferred node affinity,
whole-GPU resources, bound pods) raise Unsupported rather than guess.

`rounding` puts a rounding function after every score and every partial
sum of the fold: the control runs the same scheduler with scores rounded
to bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import quantity

F32 = np.float32
EPS = F32(1e-3)
TINY = F32(1e-9)
ZERO, HALF, ONE, HUNDRED = F32(0.0), F32(0.5), F32(1.0), F32(100.0)
INF = F32(np.inf)

HOSTNAME = "kubernetes.io/hostname"
UNSCHED_TAINT = "node.kubernetes.io/unschedulable"
AVOID_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"
GPU_MEM = "alibabacloud.com/gpu-mem"
GPU_COUNT = "alibabacloud.com/gpu-count"
BYTE_LIKE = ("memory", "ephemeral-storage", "storage", "hugepages-", GPU_MEM)

# filters in the order the scheduler runs them, with simon's diagnostics
MESSAGES = (
    "node(s) were unschedulable",
    "node(s) didn't match the requested node name",
    "node(s) had taint that the pod didn't tolerate",
    "node(s) didn't match Pod's node affinity/selector",
    "node(s) didn't have free ports for the requested pod ports",
    "Insufficient resources",
    "node(s) didn't match pod topology spread constraints",
    "node(s) didn't match pod affinity/anti-affinity rules",
    "node(s) didn't have enough local storage",
    "node(s) didn't have enough free GPU memory",
    "node(s) were rejected by an out-of-tree filter plugin",
)
F_UNSCHED, F_TAINT, F_AFFINITY, F_FIT, F_SPREAD, F_GPU = 0, 2, 3, 5, 6, 9
NONE = len(MESSAGES)

WEIGHTS = {
    "balanced_allocation": 1.0, "gpu_share": 1.0, "least_allocated": 1.0,
    "node_affinity": 1.0, "open_local": 1.0, "prefer_avoid_pods": 10000.0,
    "simon": 1.0, "taint_toleration": 1.0, "inter_pod_affinity": 1.0,
    "topology_spread": 2.0,
}
# the node-local scores in name order, then the two that read other pods
FOLD = ("balanced_allocation", "gpu_share", "least_allocated", "node_affinity",
        "open_local", "prefer_avoid_pods", "simon", "taint_toleration",
        "inter_pod_affinity", "topology_spread")
WORKLOADS = ("Deployment", "ReplicaSet")


class Unsupported(ValueError):
    """A manifest uses a feature this reference does not implement."""


def scale(resource: str) -> float:
    return float(1 << 20) if any(resource.startswith(b) for b in BYTE_LIKE) else 1.0


def to_bf16(x):
    """Round float32 values to the nearest bfloat16 (ties to even)."""
    b = np.ascontiguousarray(x, dtype=F32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(F32)


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

class Nodes:
    """The cluster's nodes as arrays, in manifest order."""

    def __init__(self, manifests: Sequence[dict]):
        self.names: List[str] = []
        self.labels: List[Dict[str, str]] = []
        self.taints: List[List[Tuple[str, str, str]]] = []
        self.avoid = np.zeros(len(manifests), bool)
        self.unsched = np.zeros(len(manifests), bool)
        self._alloc: List[Dict[str, int]] = []
        gpus: List[Tuple[int, int]] = []
        for i, m in enumerate(manifests):
            meta, spec, status = m["metadata"], m.get("spec") or {}, m.get("status") or {}
            self.names.append(meta["name"])
            lab = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
            lab.setdefault(HOSTNAME, meta["name"])
            self.labels.append(lab)
            self.taints.append([(t["key"], str(t.get("value", "") or ""), t.get("effect", ""))
                                for t in spec.get("taints") or []])
            self.unsched[i] = bool(spec.get("unschedulable"))
            self.avoid[i] = AVOID_ANNOTATION in (meta.get("annotations") or {})
            self._alloc.append({k: quantity.canonical(k, v)
                                for k, v in (status.get("allocatable") or {}).items()})
            cap = status.get("capacity") or {}
            count = quantity.canonical(GPU_COUNT, cap.get(GPU_COUNT, 0))
            total = quantity.canonical(GPU_MEM, cap.get(GPU_MEM, 0))
            gpus.append((count, total // count if count > 0 else 0))
        self.n = len(self.names)
        g = max([c for c, _ in gpus] + [1])
        self.gpu_total = np.zeros((self.n, g), F32)
        for i, (c, per) in enumerate(gpus):
            self.gpu_total[i, :c] = F32(per / float(1 << 20))

    def alloc(self, resource: str) -> np.ndarray:
        """Allocatable of one resource on every node, in scheduler units."""
        s = scale(resource)
        return np.array([a.get(resource, 0) / s for a in self._alloc], F32)

    def topology(self, key: str) -> Tuple[np.ndarray, int]:
        """(domain index per node, -1 without the key; number of domains)."""
        ids: Dict[str, int] = {}
        out = np.full(self.n, -1, np.int64)
        for i, lab in enumerate(self.labels):
            if key in lab:
                out[i] = ids.setdefault(lab[key], len(ids))
        return out, len(ids)


def _selector_matches(sel: dict, labels: Dict[str, str]) -> bool:
    for k, v in (sel.get("matchLabels") or {}).items():
        if labels.get(k) != str(v):
            return False
    for e in sel.get("matchExpressions") or []:
        k, op, vals = e["key"], e["operator"], [str(v) for v in e.get("values") or []]
        if op == "In" and labels.get(k) not in vals:
            return False
        if op == "NotIn" and k in labels and labels[k] in vals:
            return False
        if op == "Exists" and k not in labels:
            return False
        if op == "DoesNotExist" and k in labels:
            return False
        if op not in ("In", "NotIn", "Exists", "DoesNotExist"):
            raise Unsupported(f"label selector operator {op}")
    return True


@dataclass
class PodSpec:
    """One workload's pod template, parsed."""
    workload: str
    namespace: str
    labels: Dict[str, str]
    requests: Dict[str, int]
    node_selector: Dict[str, str]
    required_terms: list
    tolerations: List[Tuple[str, str, str, str]]
    spread: list                 # (key, max_skew, hard, labelSelector)
    gpu_mem: F32                 # MiB per GPU
    gpu_count: int
    owned_by_rs: bool


def _requests(spec: dict) -> Dict[str, int]:
    """Sum of the containers' requests, at least each init container's,
    plus the pod overhead."""
    total: Dict[str, int] = {}
    for c in spec.get("containers") or []:
        for k, v in ((c.get("resources") or {}).get("requests") or {}).items():
            total[k] = total.get(k, 0) + quantity.canonical(k, v)
    for c in spec.get("initContainers") or []:
        for k, v in ((c.get("resources") or {}).get("requests") or {}).items():
            total[k] = max(total.get(k, 0), quantity.canonical(k, v))
    for k, v in (spec.get("overhead") or {}).items():
        total[k] = total.get(k, 0) + quantity.canonical(k, v)
    return total


def parse_workload(obj: dict) -> Tuple[PodSpec, int]:
    """(pod spec, replicas) of a Deployment or ReplicaSet."""
    kind = obj.get("kind")
    if kind not in WORKLOADS:
        raise Unsupported(f"workload kind {kind}")
    meta, spec = obj["metadata"], obj.get("spec") or {}
    tmpl = spec.get("template") or {}
    tmeta, pspec = tmpl.get("metadata") or {}, tmpl.get("spec") or {}
    aff = pspec.get("affinity") or {}
    if aff.get("podAffinity") or aff.get("podAntiAffinity"):
        raise Unsupported("inter-pod affinity")
    node_aff = aff.get("nodeAffinity") or {}
    if node_aff.get("preferredDuringSchedulingIgnoredDuringExecution"):
        raise Unsupported("preferred node affinity")
    terms = []
    req = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for t in req.get("nodeSelectorTerms") or []:
        if t.get("matchFields"):
            raise Unsupported("node selector matchFields")
        exprs = [(e["key"], e["operator"], [str(v) for v in e.get("values") or []])
                 for e in t.get("matchExpressions") or []]
        for _, op, _ in exprs:
            if op not in ("In", "NotIn", "Exists", "DoesNotExist"):
                raise Unsupported(f"node selector operator {op}")
        terms.append(exprs)
    for c in pspec.get("containers") or []:
        if any(p.get("hostPort") for p in c.get("ports") or []):
            raise Unsupported("host ports")
    if pspec.get("volumes") or pspec.get("nodeName") or pspec.get("priority"):
        raise Unsupported("volumes, nodeName or priority")
    requests = _requests(pspec)
    if GPU_COUNT in requests:
        raise Unsupported("whole-GPU resource requests")
    ann = tmeta.get("annotations") or {}
    gpu_mem = quantity.canonical(GPU_MEM, ann[GPU_MEM]) if GPU_MEM in ann else 0
    spread = []
    for c in pspec.get("topologySpreadConstraints") or []:
        if c.get("labelSelector") is None:
            raise Unsupported("a spread constraint without a selector")
        spread.append((c["topologyKey"], int(c["maxSkew"]),
                       c["whenUnsatisfiable"] == "DoNotSchedule", c["labelSelector"]))
    ps = PodSpec(
        workload=meta["name"],
        namespace=meta.get("namespace") or "default",
        labels={k: str(v) for k, v in (tmeta.get("labels") or {}).items()},
        requests=requests,
        node_selector={k: str(v) for k, v in (pspec.get("nodeSelector") or {}).items()},
        required_terms=terms,
        tolerations=[(t.get("key", "") or "", t.get("operator") or "Equal",
                      str(t.get("value", "") or ""), t.get("effect", "") or "")
                     for t in pspec.get("tolerations") or []],
        spread=spread,
        gpu_mem=F32(gpu_mem / float(1 << 20)),
        gpu_count=int(ann.get(GPU_COUNT, 0)),
        owned_by_rs=True,
    )
    return ps, int(spec.get("replicas", 1))


def order(groups: List[Tuple[PodSpec, int]]) -> List[Tuple[PodSpec, int]]:
    """simon's ScheduleApp order: nodeSelector pods first, then tolerating
    pods first, both stable. A workload's replicas are alike, so sorting
    workloads sorts pods."""
    groups = sorted(groups, key=lambda g: not g[0].node_selector)
    return sorted(groups, key=lambda g: not g[0].tolerations)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

@dataclass
class Result:
    """What the reference decided, in scheduling order."""
    node_names: List[str]
    # (workload, node index or -1, GPU index string, failure counts or None)
    pods: List[Tuple[str, int, str, Optional[Tuple[int, ...]]]] = field(default_factory=list)
    binds: List[List[Tuple[str, str]]] = field(default_factory=list)  # per node, in order
    alloc: Optional[np.ndarray] = None       # f32[N,R] allocatable, scheduler units
    free: Optional[np.ndarray] = None        # f32[N,R] free after the call
    gpu_total: Optional[np.ndarray] = None   # f32[N,G] MiB per GPU
    gpu_free: Optional[np.ndarray] = None    # f32[N,G] MiB free after the call
    requests: Dict[str, np.ndarray] = field(default_factory=dict)  # workload -> f32[R]
    gpu_mem: Dict[str, F32] = field(default_factory=dict)         # workload -> MiB per GPU


def _tolerates(tols, key, value, effect) -> bool:
    for tk, op, tv, te in tols:
        if (te == "" or te == effect) and (tk == "" or tk == key) and (op == "Exists" or tv == value):
            return True
    return False


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(), x.max()
    rng = hi - lo
    if rng > ZERO:
        return np.clip((x - lo) * HUNDRED / max(rng, TINY), ZERO, HUNDRED)
    return np.zeros_like(x)


def _worst_fit(alloc: np.ndarray, req: np.ndarray) -> np.ndarray:
    """Per node the largest share req / (alloc - req) over the resources
    the pod requests (1 where it does not fit) -> f32[N]."""
    avail = alloc - req[None, :]
    safe = np.where(avail == ZERO, ONE, avail)
    share = np.where(req[None, :] == ZERO, ZERO,
                     np.where(avail == ZERO, ONE, req[None, :] / safe))
    share = np.where(avail < ZERO, ONE, share)
    return share.max(axis=1)


class _Row:
    """One spread constraint of the group under way: its domains, the
    matching pods' counts per node, and the counts per domain over the
    eligible nodes."""

    def __init__(self, key, skew, hard, counts, elig, nodes: Nodes, inc: bool, self_match: bool):
        self.hard, self.inc = hard, inc
        self.skew = F32(skew) + EPS
        self.self_match = ONE if self_match else ZERO
        self.elig = elig
        self.host = key == HOSTNAME
        self.counts = counts.astype(F32)
        if self.host:
            self.has_key = np.ones(nodes.n, bool)
            return
        self.topo, nd = nodes.topology(key)
        self.has_key = self.topo >= 0
        on = elig & self.has_key
        self.dom = np.bincount(self.topo[on], weights=self.counts[on], minlength=nd).astype(F32)
        self.dom_elig = np.bincount(self.topo[on], minlength=nd) > 0
        self.gather = np.where(self.has_key, self.topo, nd)

    def cnt(self) -> Tuple[np.ndarray, F32]:
        """(count of each node's domain f32[N], the smallest eligible one)."""
        if self.host:
            cnt = np.where(self.elig, self.counts, ZERO)
            mins = self.counts[self.elig]
            return cnt, (mins.min() if mins.size else ZERO)
        ext = np.append(self.dom, ZERO)
        mins = self.dom[self.dom_elig]
        return ext[self.gather], (mins.min() if mins.size else ZERO)

    def commit(self, n: int) -> None:
        if not self.inc:
            return
        self.counts[n] += ONE
        if not self.host and self.elig[n] and self.has_key[n]:
            self.dom[self.topo[n]] += ONE


class Reference:
    def __init__(self, node_manifests: Sequence[dict], weights: Optional[dict] = None,
                 rounding: Optional[Callable] = None):
        self.nodes = Nodes(node_manifests)
        w = dict(WEIGHTS, **(weights or {}))
        self.w = {k: F32(w[k]) for k in FOLD}
        self.r = rounding or (lambda x: x)

    # -- per node, on any rows of the node arrays -------------------------
    def _fit_fail(self, free, req):
        return (req[None, :] > free + EPS).any(axis=1)

    def _la_ba(self, alloc2, free2, req2):
        free_after = free2 - req2
        frac = np.where(alloc2 > ZERO, free_after / np.maximum(alloc2, TINY), ZERO)
        la = np.clip((frac[:, 0] + frac[:, 1]) * HALF, ZERO, ONE) * HUNDRED
        used = alloc2 - free2 + req2
        fb = np.clip(np.where(alloc2 > ZERO, used / np.maximum(alloc2, TINY), ZERO), ZERO, ONE)
        ba = (ONE - np.abs(fb[:, 0] - fb[:, 1])) * HUNDRED
        return self.r(la), self.r(ba)

    def _gpu_fail(self, gfree, gtotal, spec):
        if spec.gpu_mem <= ZERO:
            return np.zeros(gfree.shape[0], bool)
        caps = np.where(gtotal > ZERO, np.floor((gfree + EPS) / max(spec.gpu_mem, TINY)), ZERO)
        return ~((spec.gpu_count >= 1) & (caps.sum(axis=1) >= F32(spec.gpu_count)))

    def _prefix(self, parts: dict):
        """The fold's partial sum over the node-local scores."""
        total = None
        for k in FOLD[:8]:
            term = self.r(self.w[k] * parts[k])
            total = term if total is None else self.r(total + term)
        return total

    def _gpu_take(self, gfree, gtotal, spec) -> np.ndarray:
        """The GPUs one more pod of `spec` takes on each node, were it
        placed there -> shares per GPU f32[N,G]."""
        mem, num = spec.gpu_mem, spec.gpu_count
        if mem <= ZERO or num < 1:
            return np.zeros_like(gfree)
        if num == 1:
            elig = (gtotal > ZERO) & (gfree >= mem - EPS)
            tight = np.argmin(np.where(elig, gfree, INF), axis=1)
            take = np.zeros_like(gfree)
            take[np.arange(gfree.shape[0]), tight] = ONE
            return np.where(elig.any(axis=1)[:, None], take, ZERO)
        caps = np.where(gtotal > ZERO, np.floor((gfree + EPS) / max(mem, TINY)), ZERO)
        prefix = np.cumsum(caps, axis=1, dtype=F32) - caps
        take = np.minimum(np.maximum(F32(num) - prefix, ZERO), caps)
        return np.where((caps.sum(axis=1) >= F32(num))[:, None], take, ZERO)

    # -- a call ---------------------------------------------------------------
    def run(self, apps: Sequence[Tuple[str, Sequence[dict]]]) -> Result:
        nd = self.nodes
        groups: List[Tuple[PodSpec, int]] = []
        for _, objs in apps:
            groups += order([parse_workload(o) for o in objs if o.get("kind") in WORKLOADS])
        resources = ["cpu", "memory", "pods"]
        for spec, _ in groups:
            resources += [r for r in sorted(spec.requests) if r not in resources]
        alloc = np.stack([nd.alloc(r) for r in resources], axis=1)
        self.free = alloc.copy()
        self.gpu_free = nd.gpu_total.copy()
        self.alloc = alloc
        self.resources = resources
        self.placed: List[Tuple[PodSpec, np.ndarray]] = []
        res = Result(node_names=list(nd.names), binds=[[] for _ in range(nd.n)],
                     alloc=alloc, gpu_total=nd.gpu_total)
        for spec, replicas in groups:
            self._group(spec, replicas, res)
        res.free, res.gpu_free = self.free, self.gpu_free
        return res

    def _static(self, spec: PodSpec):
        """Filters and scores that no placement changes, for one pod spec."""
        nd, n = self.nodes, self.nodes.n
        first = np.full(n, NONE, np.int64)
        unsched_ok = _tolerates(spec.tolerations, UNSCHED_TAINT, "", "NoSchedule")
        taint_ok = np.ones(n, bool)
        prefer_cnt = np.zeros(n, F32)
        na_ok = np.ones(n, bool)
        for i in range(n):
            lab = nd.labels[i]
            for k, v, e in nd.taints[i]:
                tol = _tolerates(spec.tolerations, k, v, e)
                if e in ("NoSchedule", "NoExecute") and not tol:
                    taint_ok[i] = False
                if e == "PreferNoSchedule" and not tol:
                    prefer_cnt[i] += ONE
            ok = all(lab.get(k) == v for k, v in spec.node_selector.items())
            if ok and spec.required_terms:
                ok = any(term and all(_expr(lab, *e) for e in term)
                         for term in spec.required_terms)
            na_ok[i] = ok
        for f, fail in ((F_AFFINITY, ~na_ok), (F_TAINT, ~taint_ok),
                        (F_UNSCHED, nd.unsched & (not unsched_ok))):
            first = np.where(fail, f, first)
        req = np.zeros(len(self.resources), F32)
        for r, q in spec.requests.items():
            req[self.resources.index(r)] = F32(q / scale(r))
        req[2] += ONE                        # every pod takes a pod slot
        has_req = bool(spec.requests)
        simon = np.floor(_worst_fit(self.alloc, req) * HUNDRED) if has_req else np.full(n, HUNDRED, F32)
        gpu_share = _worst_fit(self.alloc, req) * HUNDRED if has_req else np.full(n, HUNDRED, F32)
        mx = prefer_cnt.max()
        taint = (np.clip((mx - prefer_cnt) * HUNDRED / max(mx, TINY), ZERO, HUNDRED)
                 if mx > ZERO else np.full(n, HUNDRED, F32))
        scores = {
            "gpu_share": self.r(_minmax(gpu_share)),
            "node_affinity": np.zeros(n, F32),
            "open_local": np.zeros(n, F32),
            "prefer_avoid_pods": self.r(np.where(nd.avoid & spec.owned_by_rs, ZERO, HUNDRED).astype(F32)),
            "simon": self.r(_minmax(simon)),
            "taint_toleration": self.r(taint),
        }
        return first, na_ok, req, scores

    def _trajectory(self, spec, req, static_ok, replicas):
        """Every node's state after j = 0, 1, ... commits of this pod spec,
        as long as any node could take one more: free f32[J,N,R], GPU free
        f32[J,N,G], the GPU take of commit j+1 f32[J,N,G], and the fit and
        GPU failures bool[J,N]. A node's state depends on its own commits
        alone, so a placement only moves that node one step down."""
        nd = self.nodes
        free, gfree = [self.free], [self.gpu_free]
        takes, fit, gpu = [], [self._fit_fail(self.free, req)], []
        gpu.append(self._gpu_fail(self.gpu_free, nd.gpu_total, spec))
        while len(takes) < replicas and (static_ok & ~fit[-1] & ~gpu[-1]).any():
            take = self._gpu_take(gfree[-1], nd.gpu_total, spec)
            takes.append(take)
            free.append(free[-1] - req)
            gfree.append(gfree[-1] - take * spec.gpu_mem)
            fit.append(self._fit_fail(free[-1], req))
            gpu.append(self._gpu_fail(gfree[-1], nd.gpu_total, spec))
        takes.append(np.zeros_like(self.gpu_free))
        return np.stack(free), np.stack(gfree), np.stack(takes), np.stack(fit), np.stack(gpu)

    def _group(self, spec: PodSpec, replicas: int, res: Result) -> None:
        nd = self.nodes
        n_nodes = nd.n
        first, elig, req, st = self._static(spec)
        res.requests[spec.workload], res.gpu_mem[spec.workload] = req, spec.gpu_mem
        static_ok = first == NONE
        rows = []
        for key, skew, hard, sel in spec.spread:
            counts = np.zeros(n_nodes, np.int64)
            for other, cnt in self.placed:
                if other.namespace == spec.namespace and _selector_matches(sel, other.labels):
                    counts += cnt
            self_match = _selector_matches(sel, spec.labels)
            rows.append(_Row(key, skew, hard, counts, elig, nd, self_match, self_match))
        soft = [r for r in rows if not r.hard]
        hard_rows = [r for r in rows if r.hard]

        free_t, gfree_t, take_t, fit_t, gpu_t = self._trajectory(spec, req, static_ok, replicas)
        depth = free_t.shape[0]
        la, ba = self._la_ba(np.broadcast_to(self.alloc[:, :2], (depth, n_nodes, 2)).reshape(-1, 2),
                             free_t[:, :, :2].reshape(-1, 2), req[:2])
        parts = {k: np.broadcast_to(v, (depth, n_nodes)).reshape(-1) for k, v in st.items()}
        parts["least_allocated"], parts["balanced_allocation"] = la, ba
        # the inter-pod affinity score is 0 everywhere: no pod has such terms
        ipa = self.r(self.w["inter_pod_affinity"] * ZERO)
        prefix_t = self.r(self._prefix(parts) + ipa).reshape(depth, n_nodes)
        w_ts = self.w["topology_spread"]
        # without spread rows the spread score is 100 on every node
        flat_t = self.r(prefix_t + self.r(w_ts * self.r(HUNDRED)))
        open_t = static_ok[None, :] & ~fit_t & ~gpu_t

        x = np.zeros(n_nodes, np.int64)
        nodes = np.arange(n_nodes)
        prefix = prefix_t[0].copy()
        avail = open_t[0].copy()
        masked = np.where(avail, flat_t[0], -INF)
        placed = np.zeros(n_nodes, np.int64)
        self.placed.append((spec, placed))
        for k in range(replicas):
            if rows:
                mask = avail.copy()
                hard_ok = None
                for r in hard_rows:
                    cnt, mn = r.cnt()
                    ok = ((cnt + r.self_match - mn) <= r.skew) & r.has_key
                    hard_ok = ok if hard_ok is None else hard_ok & ok
                if hard_ok is not None:
                    mask &= hard_ok
                if soft:
                    raw = None
                    for r in soft:
                        cnt, _ = r.cnt()
                        raw = cnt if raw is None else raw + cnt
                    mx = raw.max()
                    sp = (np.clip((mx - raw) * HUNDRED / max(mx, TINY), ZERO, HUNDRED)
                          if mx > ZERO else np.full(n_nodes, HUNDRED, F32))
                    total = self.r(prefix + self.r(w_ts * self.r(sp)))
                else:
                    total = flat_t[x, nodes]
                n = int(np.argmax(np.where(mask, total, -INF)))
                fits = bool(mask[n])
            else:
                hard_ok = None
                n = int(np.argmax(masked))
                fits = bool(avail[n])
            if not fits:
                # nothing changes until a pod lands, so the rest of the
                # group fails alike
                why = first.copy()
                for f, fail in ((F_FIT, fit_t[x, nodes]),
                                (F_SPREAD, None if hard_ok is None else ~hard_ok),
                                (F_GPU, gpu_t[x, nodes])):
                    if fail is not None:
                        why = np.where((why == NONE) & fail, f, why)
                counts = tuple(int(c) for c in np.bincount(why[why < NONE], minlength=NONE))
                res.pods += [(spec.workload, -1, "", counts)] * (replicas - k)
                break
            j = int(x[n])
            take = take_t[j, n]
            x[n] = j + 1
            prefix[n] = prefix_t[j + 1, n]
            avail[n] = open_t[j + 1, n]
            masked[n] = flat_t[j + 1, n] if avail[n] else -INF
            placed[n] += 1
            for r in rows:
                r.commit(n)
            gpu_index = "-".join(str(d) for d in range(take.shape[0]) for _ in range(int(take[d])))
            res.pods.append((spec.workload, n, gpu_index, None))
            res.binds[n].append((spec.workload, gpu_index))
        self.free = free_t[x, nodes]
        self.gpu_free = gfree_t[x, nodes]


def _expr(labels: Dict[str, str], key: str, op: str, values: List[str]) -> bool:
    if op == "In":
        return labels.get(key) in values
    if op == "NotIn":
        return labels.get(key) not in values
    if op == "Exists":
        return key in labels
    return key not in labels


def schedule(node_manifests: Sequence[dict], apps: Sequence[Tuple[str, Sequence[dict]]],
             weights: Optional[dict] = None, rounding: Optional[Callable] = None) -> Result:
    """Schedule one call's apps on a fresh cluster of `node_manifests`."""
    return Reference(node_manifests, weights, rounding).run(apps)
