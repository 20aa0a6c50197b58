"""Tensorization: object model -> structure-of-arrays host tables (numpy).

The port's own copy of the JAX package's encoder (ops/encode.py there): the
same vocabularies, bucketed shapes and byte-identical tables, so the same
Node/Pod objects encode to the same arrays in both packages. Strings (labels,
taints, namespaces) are interned into integer vocabularies on the host; the
state functions (ops/state.py) ship the tables to the device.

Shapes (N nodes, P pods, R resources, padded caps L/T/TERM/EXPR/VAL/TOL/S/K):
  NodeTable: alloc f32[N,R], free f32[N,R], label_pair i32[N,L], label_key
  i32[N,L], label_num f32[N,L], taint_{key,val,effect} i32[N,T], name_id i32[N],
  unsched bool[N], avoid_pods bool[N], topo i32[N,K], valid bool[N]
  PodBatch: req f32[P,R], selector term tensors, tolerations, preferred terms,
  spread/affinity constraint tables, match_sel bool[P,S].
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.matcher import match_label_selector
from ..core.objects import (
    ANNO_GPU_COUNT_POD,
    ANNO_GPU_MEM_POD,
    ANNO_NODE_LOCAL_STORAGE,
    ANNO_POD_LOCAL_STORAGE,
    RESOURCE_GPU_COUNT,
    LabelSelector,
    Node,
    NodeLocalStorage,
    Pod,
)
from ..utils import metrics as _metrics

# Resource scaling: canonical int units -> f32-safe units.
# cpu is already milli; byte-like resources go to MiB so f32's 24-bit mantissa
# stays exact up to 16 TiB per node.
_BYTE_LIKE = (
    "memory", "ephemeral-storage", "storage", "hugepages-",
    "alibabacloud.com/gpu-mem",
)

# Fixed resource-axis index of the whole-GPU count extended resource
# (alibabacloud.com/gpu-count). Its node allocatable is DYNAMIC in the
# reference — the gpu-share plugin's Reserve rewrites it to the number of
# fully-idle devices (open-gpu-share.go:183-190) — so the kernels recompute
# effective availability from the per-device state instead of trusting the
# static row (kernels.run_filters).
GPU_COUNT_IDX = 3
_EFFECTS = {"NoSchedule": 1, "PreferNoSchedule": 2, "NoExecute": 3}

OP_PAD, OP_IN, OP_NOT_IN, OP_EXISTS, OP_NOT_EXISTS, OP_GT, OP_LT = range(7)
_OPS = {
    "In": OP_IN,
    "NotIn": OP_NOT_IN,
    "Exists": OP_EXISTS,
    "DoesNotExist": OP_NOT_EXISTS,
    "Gt": OP_GT,
    "Lt": OP_LT,
}


def resource_scale(name: str) -> float:
    if any(name.startswith(b) or name == b for b in _BYTE_LIKE):
        return float(1 << 20)
    return 1.0


def round_up(n: int, floor: int = 8, step: int = 4096) -> int:
    """Bucket a dynamic size so jit caches hit across add-node iterations and
    varying app sizes: next power of two up to `step`, then multiples of
    `step` (bounds padding waste to <1/16 for big batches where scan steps
    are paid per padded row).

    `floor` is the smallest bucket ever returned; `step` is the linear
    granularity past the power-of-two region. They are distinct knobs: the
    old `minimum` name suggested granularity but only ever set the floor."""
    size = max(n, floor, 1)
    if size <= step:
        return 1 << (size - 1).bit_length()
    return (size + step - 1) // step * step


# The node-axis shape ladder (ROADMAP 5(b), docs/performance.md): every node
# table pads to a rung, so the jit family compiles a finite program set no
# matter how node counts grow — powers of two from the floor up to the step,
# then multiples of the step: 64, 128, ..., 4096, 8192, 12288, ...
NODE_BUCKET_FLOOR = 64
NODE_BUCKET_STEP = 4096


def node_bucket(n: int) -> int:
    """The ladder rung (padded node-axis length) covering `n` real nodes.
    Tiny clusters pay a few inert padded rows; in exchange the engine keeps
    one compiled program per rung instead of one per node count."""
    return round_up(n, floor=NODE_BUCKET_FLOOR, step=NODE_BUCKET_STEP)


def ladder_rungs(n_max: int) -> List[int]:
    """Every ladder rung up to and including the one covering `n_max`: the
    node-axis shapes a capacity sweep over [1, n_max] can touch."""
    rungs = [NODE_BUCKET_FLOOR]
    while rungs[-1] < n_max:
        rungs.append(node_bucket(rungs[-1] + 1))
    return rungs


class Vocab:
    """Host-side string interner. Id 0 is reserved for 'absent'."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}

    def id(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._ids) + 1
            self._ids[s] = i
        return i

    def get(self, s: str) -> int:
        return self._ids.get(s, 0)

    def __len__(self) -> int:
        return len(self._ids)


def _pod_row_sig(pod: Pod) -> Tuple:
    """Encoding signature: pods with equal signatures produce identical
    PodBatch rows (the name itself is never encoded). Mutable per-clone dicts
    (labels, annotations-derived features, requests) are keyed by content;
    spec-derived immutable structures that _clone_pods shares between replicas
    (affinity, tolerations, spread constraints, host ports, nodeSelector) are
    keyed by identity — distinct parses never share ids, so identity keying is
    conservative (never merges pods that differ)."""
    return (
        pod.meta.namespace,
        tuple(sorted(pod.meta.labels.items())),
        tuple(sorted(pod.requests.items())),
        pod.node_name,
        pod.meta.owner_kind,
        pod.meta.annotations.get(ANNO_GPU_MEM_POD),
        pod.meta.annotations.get(ANNO_GPU_COUNT_POD),
        pod.meta.annotations.get(ANNO_POD_LOCAL_STORAGE),
        id(pod.affinity),
        id(pod.tolerations),
        id(pod.spread_constraints),
        id(pod.host_ports),
        id(pod.node_selector),
    )


@dataclass
class SelectorEntry:
    """A deduped (namespaces, LabelSelector) pair used by spread/affinity terms."""
    namespaces: Tuple[str, ...]
    selector: Optional[LabelSelector]

    def matches(self, pod: Pod) -> bool:
        if self.namespaces and pod.meta.namespace not in self.namespaces:
            return False
        return match_label_selector(self.selector, pod.meta.labels)


class Encoder:
    """Shared vocabularies + caps for one simulation. Nodes and pods must be
    encoded by the same Encoder so ids line up."""

    UNSCHED_TAINT_KEY = "node.kubernetes.io/unschedulable"

    def __init__(
        self,
        topology_keys: Sequence[str] = (),
        ignored_resources: Sequence[str] = (),
    ) -> None:
        # Extender-managed resources with ignoredByScheduler: the reference
        # adds these to NodeResourcesFit's IgnoredResources for every profile
        # (vendor/.../scheduler/factory.go:105-130). Skipping them here keeps
        # them out of the req/alloc tensors entirely, so the device resource
        # filter never sees them — the extender (which matches interest on
        # the raw pod.requests dict) remains the sole authority.
        self.ignored_resources = frozenset(r for r in ignored_resources if r)
        self.keys = Vocab()        # label keys
        self.vals = Vocab()        # label values
        # Pre-intern ids the kernels reference as scalars, so they are stable
        # regardless of node/pod encode order.
        self.unsched_key_id = self.keys.id(self.UNSCHED_TAINT_KEY)
        self.empty_val_id = self.vals.id("")
        self.pairs = Vocab()       # "key=value"
        self.names = Vocab()       # node names
        self.vgs = Vocab()         # LVM volume-group names (open-local)
        self.resources: List[str] = ["cpu", "memory", "pods", RESOURCE_GPU_COUNT]
        assert self.resources[GPU_COUNT_IDX] == RESOURCE_GPU_COUNT
        # kubernetes.io/hostname is pinned at index 0: its domains are the
        # nodes themselves, handled natively by the kernels (a dense one-hot
        # for it would be O(N^2) memory — kernels.HOSTNAME_KEY_IDX).
        self.topology_keys: List[str] = ["kubernetes.io/hostname"] + [
            k for k in dict.fromkeys(list(topology_keys))
            if k != "kubernetes.io/hostname"
        ]
        self.selectors: List[SelectorEntry] = []
        self._selector_ids: Dict[Tuple, int] = {}
        self.domains = Vocab()     # "topokey=value" domain ids
        self.domain_topo: List[int] = []  # topo-key index per domain id (1-based)
        # NodePorts: (protocol, port) ids and specific (protocol, port, ip) ids.
        # Id 0 is the pad row of the count tables (never incremented).
        self.ports = Vocab()
        self.port_ips = Vocab()
        # InterPodAffinity symmetry: registry of distinct required
        # anti-affinity (topo key idx, selector id) terms across ALL pods, so
        # existing pods' anti-affinity can repel matching incomers (the
        # vendored plugin's existingAntiAffinityCounts).
        self.anti_terms: List[Tuple[int, int]] = []
        self._anti_ids: Dict[Tuple[int, int], int] = {}
        # (namespace, sorted labels) -> bool[S] selector match vector; see
        # match_vector. Append-only selector ids keep stale entries safe to
        # detect by length.
        self._match_cache: Dict[Tuple, np.ndarray] = {}

    def domain_id(self, key_idx: int, key: str, value: str) -> int:
        before = len(self.domains)
        did = self.domains.id(f"{key}={value}")
        if len(self.domains) > before:
            self.domain_topo.append(key_idx)
        return did

    # -- registration -------------------------------------------------------
    def resource_index(self, name: str) -> int:
        if name not in self.resources:
            self.resources.append(name)
        return self.resources.index(name)

    def topo_index(self, key: str) -> int:
        if key not in self.topology_keys:
            self.topology_keys.append(key)
        return self.topology_keys.index(key)

    def selector_id(self, namespaces: Sequence[str], selector: Optional[LabelSelector]) -> int:
        key = (
            tuple(sorted(namespaces)),
            selector.key() if selector is not None else None,
        )
        sid = self._selector_ids.get(key)
        if sid is None:
            sid = len(self.selectors)
            self._selector_ids[key] = sid
            self.selectors.append(SelectorEntry(tuple(sorted(namespaces)), selector))
        return sid

    def pair_id(self, key: str, value: str) -> int:
        self.keys.id(key)
        self.vals.id(value)
        return self.pairs.id(f"{key}={value}")

    def anti_term_id(self, topo_idx: int, sel_id: int) -> int:
        key = (topo_idx, sel_id)
        aid = self._anti_ids.get(key)
        if aid is None:
            aid = len(self.anti_terms)
            self._anti_ids[key] = aid
            self.anti_terms.append(key)
        return aid

    def port_ids(self, pod: Pod) -> List[Tuple[int, bool, int]]:
        """(pid, is_wildcard_ip, ipid) per host port; registers vocab entries."""
        from ..core.matcher import _WILDCARD_IPS

        out = []
        for proto, port, ip in pod.host_ports:
            pid = self.ports.id(f"{proto}:{port}")
            wild = ip in _WILDCARD_IPS
            ipid = 0 if wild else self.port_ips.id(f"{proto}:{port}:{ip}")
            out.append((pid, wild, ipid))
        return out

    def anti_ids(self, pod: Pod) -> List[int]:
        """Required anti-affinity term ids this pod carries; registers them."""
        out = []
        for t in pod.affinity.anti_required:
            if not t.topology_key:
                continue
            k = self.topo_index(t.topology_key)
            s = self.selector_id(t.namespaces or (pod.meta.namespace,), t.selector)
            out.append(self.anti_term_id(k, s))
        return out

    def register_pods(self, pods: Sequence[Pod]) -> None:
        """Pre-register every resource name, topology key and selector used by
        a pod batch, so caps and ids are stable before arrays are built.

        Deduped by row signature: workload replicas are prototype clones
        (core/workloads._clone_pods) whose registrations are identical, so one
        representative per signature registers for the whole group."""
        seen: Set[Tuple] = set()
        for pod in pods:
            sig = _pod_row_sig(pod)
            if sig in seen:
                continue
            seen.add(sig)
            for r in pod.requests:
                if r not in self.ignored_resources:
                    self.resource_index(r)
            for c in pod.spread_constraints:
                if c.topology_key:
                    self.topo_index(c.topology_key)
                self.selector_id((pod.meta.namespace,), c.selector)
            aff = pod.affinity
            for terms in (aff.pod_required, aff.anti_required):
                for t in terms:
                    if t.topology_key:
                        self.topo_index(t.topology_key)
                    self.selector_id(t.namespaces or (pod.meta.namespace,), t.selector)
            for wt in list(aff.pod_preferred) + list(aff.anti_preferred):
                t = wt.term
                if t.topology_key:
                    self.topo_index(t.topology_key)
                self.selector_id(t.namespaces or (pod.meta.namespace,), t.selector)
            self.anti_ids(pod)
            self.port_ids(pod)


@dataclass
class NodeTable:
    """SoA encoding of all nodes. All arrays are numpy; the engine ships them
    to the device once per simulation."""
    alloc: np.ndarray       # f32[N,R] allocatable, scaled units
    free: np.ndarray        # f32[N,R] allocatable - requested(existing pods)
    label_pair: np.ndarray  # i32[N,L]
    label_key: np.ndarray   # i32[N,L]
    label_num: np.ndarray   # f32[N,L] numeric label value (nan if non-numeric)
    taint_key: np.ndarray   # i32[N,T]
    taint_val: np.ndarray   # i32[N,T]
    taint_effect: np.ndarray  # i32[N,T] 0=pad
    name_id: np.ndarray     # i32[N]
    unsched: np.ndarray     # bool[N]
    avoid_pods: np.ndarray  # bool[N] NodePreferAvoidPods annotation present
    topo: np.ndarray        # i32[N,K] domain id or -1
    valid: np.ndarray       # bool[N]
    gpu_total: np.ndarray   # f32[N,G] per-device total GPU mem, MiB (0 = none)
    gpu_free: np.ndarray    # f32[N,G] per-device free after existing pods
    # open-local storage (parity: the simon/node-local-storage annotation,
    # utils.GetNodeStorage — VGs are shared bin-packed pools, devices are
    # exclusively allocated whole disks)
    vg_cap: np.ndarray      # f32[N,V] VG capacity, MiB (0 = pad)
    vg_free: np.ndarray     # f32[N,V] capacity - requested
    vg_name: np.ndarray     # i32[N,V] VG name vocab id (0 = pad)
    dev_cap: np.ndarray     # f32[N,DV] device capacity, MiB (0 = pad)
    dev_ssd: np.ndarray     # bool[N,DV] media type is SSD
    dev_free: np.ndarray    # f32[N,DV] 1.0 = free, 0.0 = allocated/pad
    has_storage: np.ndarray  # bool[N] node carries the storage annotation
    names: List[str] = field(default_factory=list)

    @property
    def n(self) -> int:
        return self.alloc.shape[0]


@dataclass
class PodBatch:
    """SoA encoding of a pod batch to schedule sequentially."""
    req: np.ndarray            # f32[P,R]
    has_req: np.ndarray        # bool[P] (simon score: empty requests => max)
    node_name_id: np.ndarray   # i32[P] 0 = unpinned
    gpu_mem: np.ndarray        # f32[P] per-GPU shared-memory request, MiB
    gpu_num: np.ndarray        # f32[P] number of GPU shares requested
    # required node affinity: OR over TERM terms, AND over EXPR exprs each
    sel_op: np.ndarray         # i32[P,TERM,EXPR]
    sel_key: np.ndarray        # i32[P,TERM,EXPR]
    sel_val: np.ndarray        # i32[P,TERM,EXPR,VAL] pair ids for In/NotIn
    sel_num: np.ndarray        # f32[P,TERM,EXPR] numeric rhs for Gt/Lt
    has_terms: np.ndarray      # bool[P] any required term present
    # plain nodeSelector: all pairs must be present
    ns_pair: np.ndarray        # i32[P,NS]
    # preferred node affinity terms (flattened single-expression groups)
    pref_weight: np.ndarray    # f32[P,PREF]
    pref_op: np.ndarray        # i32[P,PREF,EXPR]
    pref_key: np.ndarray       # i32[P,PREF,EXPR]
    pref_val: np.ndarray       # i32[P,PREF,EXPR,VAL]
    pref_num: np.ndarray       # f32[P,PREF,EXPR]
    # tolerations
    tol_key: np.ndarray        # i32[P,TOL] 0 = all keys
    tol_val: np.ndarray        # i32[P,TOL]
    tol_exists: np.ndarray     # bool[P,TOL]
    tol_effect: np.ndarray     # i32[P,TOL] 0 = all effects
    tol_valid: np.ndarray      # bool[P,TOL]
    # topology spread constraints
    spread_topo: np.ndarray    # i32[P,C] topo key index or -1
    spread_sel: np.ndarray     # i32[P,C] selector id
    spread_skew: np.ndarray    # f32[P,C]
    spread_hard: np.ndarray    # bool[P,C]
    # inter-pod (anti)affinity terms
    aff_topo: np.ndarray       # i32[P,A] topo key index or -1
    aff_sel: np.ndarray        # i32[P,A]
    aff_anti: np.ndarray       # bool[P,A]
    aff_required: np.ndarray   # bool[P,A]
    aff_weight: np.ndarray     # f32[P,A] (preferred terms; 0 for required)
    # open-local storage volumes (parity: simon/pod-local-storage VolumeRequest)
    lvm_req: np.ndarray        # f32[P,SV] LVM request MiB per slot (0 = pad)
    lvm_vg: np.ndarray         # i32[P,SV] explicit VG id, 0 = binpack over VGs
    dev_req: np.ndarray        # f32[P,SV] exclusive-device request MiB (0 = pad)
    dev_media_ssd: np.ndarray  # bool[P,SV] device request wants SSD media
    has_local: np.ndarray      # bool[P] pod carries any local-storage volume
    # membership of this pod in each deduped selector
    match_sel: np.ndarray      # bool[P,S]
    owned_by_rs: np.ndarray    # bool[P] controller is ReplicaSet/RC (NodePreferAvoidPods)
    # NodePorts: requested host ports (pid indexes the port_any/port_wild count
    # tables; ipid indexes port_ipc; 0 = pad)
    hp_pid: np.ndarray         # i32[P,HP]
    hp_wild: np.ndarray        # bool[P,HP] hostIP is wildcard
    hp_ipid: np.ndarray        # i32[P,HP]
    # InterPodAffinity symmetry: per registered required-anti-affinity term
    match_anti: np.ndarray     # bool[P,AT] pod matches term's selector+namespaces
    own_anti: np.ndarray       # f32[P,AT] times this pod carries the term
    valid: np.ndarray          # bool[P]
    keys: List[str] = field(default_factory=list)  # namespace/name per row

    @property
    def p(self) -> int:
        return self.req.shape[0]


def _num_or_nan(s: str) -> float:
    # Fast reject before the try: raising costs ~1.5us per call and nearly
    # every label value / node name is non-numeric (k8s label values cannot
    # start with whitespace, so the leading-char test loses nothing).
    if not s or not (s[0].isdigit() or s[0] in "+-"):
        return float("nan")
    try:
        return float(int(s))
    except ValueError:
        return float("nan")


def node_axes(
    enc: Encoder,
    nodes: Sequence[Node],
    storages: Optional[Sequence[Optional["NodeLocalStorage"]]] = None,
) -> Tuple[int, int, int, int, int]:
    """Bucketed per-node axis caps (L, T, G, V, DV) for this node list — the
    shape-defining maxima of encode_nodes."""
    if storages is None:
        storages = [nd.local_storage() for nd in nodes]
    L = round_up(max((len(nd.meta.labels) for nd in nodes), default=1), 4)
    T = round_up(max((len(nd.taints) for nd in nodes), default=1), 2)
    G = round_up(max((nd.gpu_count() for nd in nodes), default=1), 2)
    V = round_up(max((len(s.vgs) for s in storages if s), default=1), 2)
    DV = round_up(max((len(s.devices) for s in storages if s), default=1), 2)
    return L, T, G, V, DV


# Sentinel for "decode the node's local storage here"; None is a legal
# storage value.
_STORAGE_UNSET: Optional[NodeLocalStorage] = NodeLocalStorage()


def clear_node_row(table: NodeTable, i: int) -> None:
    """Reset row i of every per-node array to the pad value encode_nodes
    allocates (zeros, NaN label_num, -1 topo, False flags), so a following
    encode_node_into writes bytes identical to a from-scratch encode."""
    for f in _STAMP_FIELDS:
        arr = getattr(table, f)
        arr[i] = _PAD_VALUES.get(f, 0)


def encode_node_into(
    enc: Encoder,
    table: NodeTable,
    i: int,
    nd: Node,
    usage: Dict[str, Dict[str, int]],
    gpu_usage: Dict[str, np.ndarray],
    st: Optional[NodeLocalStorage] = _STORAGE_UNSET,
) -> None:
    """Encode one node into row i of a zeroed or cleared table (its local
    storage `st` is decoded here unless the caller passes it)."""
    L = table.label_pair.shape[1]
    T = table.taint_key.shape[1]
    V = table.vg_cap.shape[1]
    DV = table.dev_cap.shape[1]
    table.valid[i] = True
    table.name_id[i] = enc.names.id(nd.name)
    table.unsched[i] = nd.unschedulable
    table.avoid_pods[i] = (
        "scheduler.alpha.kubernetes.io/preferAvoidPods" in nd.meta.annotations
    )
    for r, res in enumerate(enc.resources):
        a = nd.allocatable.get(res, 0) / resource_scale(res)
        table.alloc[i, r] = a
        used = usage.get(nd.name, {}).get(res, 0) / resource_scale(res)
        table.free[i, r] = a - used
    for j, (k, v) in enumerate(sorted(nd.meta.labels.items())):
        if j >= L:
            break
        table.label_key[i, j] = enc.keys.id(k)
        table.label_pair[i, j] = enc.pair_id(k, v)
        table.label_num[i, j] = _num_or_nan(v)
    for j, t in enumerate(nd.taints):
        if j >= T:
            break
        table.taint_key[i, j] = enc.keys.id(t.key)
        table.taint_val[i, j] = enc.vals.id(t.value)
        table.taint_effect[i, j] = _EFFECTS.get(t.effect, 0)
    table.topo[i, 0] = i  # hostname: every node is its own domain
    for k_idx, key in enumerate(enc.topology_keys[1:], start=1):
        v = nd.meta.labels.get(key)
        if v is not None:
            table.topo[i, k_idx] = enc.domain_id(k_idx, key, v)
    g_cnt = nd.gpu_count()
    if g_cnt > 0:
        per_dev = np.float32(nd.gpu_mem_per_device() / float(1 << 20))
        table.gpu_total[i, :g_cnt] = per_dev
        table.gpu_free[i, :g_cnt] = per_dev
        used = gpu_usage.get(nd.name)
        if used is not None:
            table.gpu_free[i, : len(used)] -= used.astype(np.float32)
    if st is _STORAGE_UNSET:
        st = nd.local_storage()
    if st is not None:
        table.has_storage[i] = True
        for j, vg in enumerate(st.vgs[:V]):
            table.vg_name[i, j] = enc.vgs.id(vg.name)
            table.vg_cap[i, j] = np.float32(vg.capacity / float(1 << 20))
            table.vg_free[i, j] = np.float32(
                max(vg.capacity - vg.requested, 0) / float(1 << 20)
            )
        for j, dev in enumerate(st.devices[:DV]):
            table.dev_cap[i, j] = np.float32(dev.capacity / float(1 << 20))
            table.dev_ssd[i, j] = dev.media_type == "ssd"
            table.dev_free[i, j] = 0.0 if dev.is_allocated else 1.0


# Per-row NodeTable arrays (every array field; `names` is built apart): the
# fields the stamping pass broadcasts from a template row to its clones, and
# the pad value encode_nodes allocates for each (0 / False elsewhere).
_STAMP_FIELDS = (
    "alloc", "free", "label_pair", "label_key", "label_num",
    "taint_key", "taint_val", "taint_effect", "name_id", "unsched",
    "avoid_pods", "topo", "valid", "gpu_total", "gpu_free",
    "vg_cap", "vg_free", "vg_name", "dev_cap", "dev_ssd", "dev_free",
    "has_storage",
)
_PAD_VALUES = {"label_num": np.nan, "topo": -1}

# Placeholder for "this label holds the node's own name" in template
# signatures: a control character no real label value can contain.
_OWN_NAME_SENTINEL = "\x00own-name\x00"


def _node_stamp_sig(
    enc: Encoder,
    nd: Node,
    usage: Dict[str, Dict[str, int]],
    gpu_usage: Dict[str, np.ndarray],
    st: Optional[NodeLocalStorage],
    host_key: str,
) -> Tuple:
    """Template signature: nodes with equal signatures encode to identical
    rows except the name-derived cells (name_id, topo[:, 0] and, when the
    hostname label holds the node's own name, that label slot's pair id and
    numeric view), which the stamping pass fixes up per clone. It covers
    exactly the inputs encode_node_into reads; a hostname label value is
    replaced by a sentinel only when it equals the node's own name."""
    g_cnt = nd.gpu_count()
    g_used = gpu_usage.get(nd.name)
    labels = []
    for k in sorted(nd.meta.labels):
        v = nd.meta.labels[k]
        if k == host_key and v == nd.name:
            v = _OWN_NAME_SENTINEL
        labels.append((k, v))
    return (
        tuple(sorted(nd.allocatable.items())),
        tuple(labels),
        tuple((t.key, t.value, t.effect) for t in nd.taints),
        nd.unschedulable,
        "scheduler.alpha.kubernetes.io/preferAvoidPods" in nd.meta.annotations,
        g_cnt,
        nd.gpu_mem_per_device() if g_cnt > 0 else 0,
        tuple(sorted(usage.get(nd.name, {}).items())),
        None if g_used is None else tuple(np.asarray(g_used).tolist()),
        None if st is None else (
            tuple((vg.name, vg.capacity, vg.requested) for vg in st.vgs),
            tuple((d.capacity, d.media_type, d.is_allocated) for d in st.devices),
        ),
    )


def encode_nodes(
    enc: Encoder,
    nodes: Sequence[Node],
    existing_usage: Optional[Dict[str, Dict[str, int]]] = None,
    existing_gpu: Optional[Dict[str, np.ndarray]] = None,
    n_pad: Optional[int] = None,
    min_axes: Optional[Tuple[int, int, int, int, int]] = None,
    stamp: Optional[bool] = None,
) -> NodeTable:
    """Build the node table. existing_usage maps node name -> canonical
    request totals of already-bound pods (subtracted into `free`);
    existing_gpu maps node name -> used MiB per device. The node axis pads
    to `n_pad`, or to the node_bucket ladder. `min_axes` is an optional
    (L, T, G, V, DV) floor: the resident state pins it to its own bucket
    sizes so a verification re-encode lands in the same shapes.

    `stamp` (None reads OSIM_STAMP_ENCODE, default on) is the template
    stamping pass: each distinct node spec is encoded once with
    encode_node_into and its clones are stamped by a row broadcast plus
    per-row name fixups. Byte-identical to the per-node loop: the signature
    covers every input the row encode reads, and clones intern their
    name-derived vocabulary entries at their loop position. Capacity clones
    carry a `_stamp_token` (engine/capacity.new_fake_nodes) that stands for
    their content, so their signature is a few dict lookups."""
    n = len(nodes)
    N = n_pad if n_pad is not None else node_bucket(n)
    R = len(enc.resources)
    K = max(len(enc.topology_keys), 1)
    usage = existing_usage or {}
    gpu_usage = existing_gpu or {}
    if stamp is None:
        stamp = os.environ.get("OSIM_STAMP_ENCODE", "1") != "0"
    stamp = bool(stamp) and n >= 2

    storages: List[Optional[NodeLocalStorage]] = []
    storages_by_row: Dict[int, Optional[NodeLocalStorage]] = {}
    sigs: List[Tuple] = []
    names_list: List[str] = []
    if stamp:
        # signature pre-pass; the axis caps come from one representative
        # per distinct signature (group members are content-equal)
        host_key = enc.topology_keys[0]
        ax_nodes: List[Node] = []
        ax_st: List[Optional[NodeLocalStorage]] = []
        seen_tok: Dict[object, Tuple] = {}
        no_usage = not usage and not gpu_usage
        for i, nd in enumerate(nodes):
            meta = nd.meta
            name = meta.name
            names_list.append(name)
            tok = nd.__dict__.get("_stamp_token")
            if tok is not None:
                if no_usage:
                    sig = (tok, nd.unschedulable,
                           meta.annotations.get(ANNO_NODE_LOCAL_STORAGE))
                else:
                    sig = (
                        tok, nd.unschedulable,
                        meta.annotations.get(ANNO_NODE_LOCAL_STORAGE),
                        tuple(sorted(usage[name].items())) if name in usage else None,
                        tuple(np.asarray(gpu_usage[name]).tolist())
                        if name in gpu_usage else None,
                    )
                prev = seen_tok.get(tok)
                if prev is None:
                    seen_tok[tok] = sig
                if prev is None or prev != sig:
                    ax_nodes.append(nd)
                    ax_st.append(nd.local_storage())
            else:
                st = nd.local_storage()
                storages_by_row[i] = st
                sig = _node_stamp_sig(enc, nd, usage, gpu_usage, st, host_key)
                ax_nodes.append(nd)
                ax_st.append(st)
            sigs.append(sig)
        L, T, G, V, DV = node_axes(enc, ax_nodes, ax_st)
    else:
        storages = [nd.local_storage() for nd in nodes]
        L, T, G, V, DV = node_axes(enc, nodes, storages)
        names_list = [nd.meta.name for nd in nodes]
    if min_axes is not None:
        L, T, G, V, DV = (max(a, b) for a, b in zip((L, T, G, V, DV), min_axes))
    table = NodeTable(
        alloc=np.zeros((N, R), np.float32),
        free=np.zeros((N, R), np.float32),
        label_pair=np.zeros((N, L), np.int32),
        label_key=np.zeros((N, L), np.int32),
        label_num=np.full((N, L), np.nan, np.float32),
        taint_key=np.zeros((N, T), np.int32),
        taint_val=np.zeros((N, T), np.int32),
        taint_effect=np.zeros((N, T), np.int32),
        name_id=np.zeros(N, np.int32),
        unsched=np.zeros(N, bool),
        avoid_pods=np.zeros(N, bool),
        topo=np.full((N, K), -1, np.int32),
        valid=np.zeros(N, bool),
        gpu_total=np.zeros((N, G), np.float32),
        gpu_free=np.zeros((N, G), np.float32),
        vg_cap=np.zeros((N, V), np.float32),
        vg_free=np.zeros((N, V), np.float32),
        vg_name=np.zeros((N, V), np.int32),
        dev_cap=np.zeros((N, DV), np.float32),
        dev_ssd=np.zeros((N, DV), bool),
        dev_free=np.zeros((N, DV), np.float32),
        has_storage=np.zeros(N, bool),
        names=names_list,
    )
    if not stamp:
        for i, nd in enumerate(nodes):
            encode_node_into(enc, table, i, nd, usage, gpu_usage, storages[i])
        return table

    # Stamping pass, sequential over nodes so every vocabulary intern
    # happens at the position the per-node loop would do it.
    first_row: Dict[Tuple, int] = {}
    # template row -> [(clone row, name_id, hostname pair id, num(name))]
    clones: Dict[int, List[Tuple[int, int, int, float]]] = {}
    host_bound: Dict[int, bool] = {}
    names_d = enc.names._ids
    vals_d = enc.vals._ids
    pairs_d = enc.pairs._ids
    _nan = float("nan")
    for i, sig in enumerate(sigs):
        tmpl = first_row.get(sig)
        if tmpl is None:
            nd = nodes[i]
            first_row[sig] = i
            host_bound[i] = nd.meta.labels.get(host_key) == names_list[i]
            encode_node_into(
                enc, table, i, nd, usage, gpu_usage,
                st=storages_by_row.get(i, _STORAGE_UNSET),
            )
            continue
        # a clone's only new vocabulary entries are its name and (when
        # hostname-bound) its hostname label pair: Vocab.id, inlined
        name = names_list[i]
        nid = names_d.get(name)
        if nid is None:
            nid = len(names_d) + 1
            names_d[name] = nid
        if host_bound[tmpl]:
            if name not in vals_d:
                vals_d[name] = len(vals_d) + 1
            pair = host_key + "=" + name
            pid = pairs_d.get(pair)
            if pid is None:
                pid = len(pairs_d) + 1
                pairs_d[pair] = pid
            num = _num_or_nan(name)
        else:
            pid, num = 0, _nan
        clones.setdefault(tmpl, []).append((i, nid, pid, num))
    stamped = 0
    for tmpl, rows in clones.items():
        idx = np.fromiter((r[0] for r in rows), np.int32, len(rows))
        for f in _STAMP_FIELDS:
            arr = getattr(table, f)
            arr[idx] = arr[tmpl]
        table.name_id[idx] = np.fromiter((r[1] for r in rows), np.int32, len(rows))
        table.topo[idx, 0] = idx  # hostname: every node is its own domain
        if host_bound[tmpl]:
            # the hostname label sits at the same sorted slot on every clone
            key_id = enc.keys.get(host_key)
            j = int(np.nonzero(table.label_key[tmpl] == key_id)[0][0])
            table.label_pair[idx, j] = np.fromiter((r[2] for r in rows), np.int32, len(rows))
            table.label_num[idx, j] = np.fromiter((r[3] for r in rows), np.float32, len(rows))
        stamped += len(rows)
    if stamped:
        _metrics.ENCODE_STAMPED_ROWS.inc(stamped)
    return table


def _encode_term_exprs(enc: Encoder, exprs, EXPR: int, VAL: int):
    """Encode one node-selector term's expressions into fixed arrays."""
    op = np.zeros(EXPR, np.int32)
    key = np.zeros(EXPR, np.int32)
    val = np.zeros((EXPR, VAL), np.int32)
    num = np.zeros(EXPR, np.float32)
    for e, ex in enumerate(exprs[:EXPR]):
        op[e] = _OPS.get(ex.operator, OP_PAD)
        key[e] = enc.keys.id(ex.key)
        for v, value in enumerate(ex.values[:VAL]):
            val[e, v] = enc.pair_id(ex.key, value)
        if ex.operator in ("Gt", "Lt") and ex.values:
            try:
                num[e] = float(int(ex.values[0]))
            except ValueError:
                num[e] = float("nan")
    return op, key, val, num


def encode_pods(enc: Encoder, pods: Sequence[Pod], p_pad: Optional[int] = None) -> PodBatch:
    """Encode a pod batch; the pod axis pads to `p_pad`, or to round_up(p).

    Row-level dedup: workload replicas are prototype clones whose encoded rows
    are identical (name excluded — it never becomes a feature), so only one
    representative per `_pod_row_sig` runs the per-row Python encode (incl.
    the O(S) selector matching); clones expand by a numpy gather. This is what
    keeps 100k-pod × hundreds-of-workloads encodes in seconds."""
    enc.register_pods(pods)
    p = len(pods)
    P = p_pad if p_pad is not None else round_up(p)
    R = len(enc.resources)
    S = selector_table_size(enc)

    reps: List[Pod] = []
    rep_of: Dict[Tuple, int] = {}
    inverse = np.empty(p, np.int32)
    for i, pod in enumerate(pods):
        sig = _pod_row_sig(pod)
        j = rep_of.get(sig)
        if j is None:
            j = len(reps)
            rep_of[sig] = j
            reps.append(pod)
        inverse[i] = j
    D = len(reps)

    def cap(f, minimum=1):
        return max((f(pod) for pod in reps), default=minimum) or minimum

    # Feature-axis floors cover typical specs so batches from different apps
    # (and capacity-search probes) share ONE jit shape family — distinct
    # (TERM, EXPR, ...) combos each trace their own multi-second graphs
    # otherwise. The axes are tiny relative to the [N]-wide work, so padding
    # costs ~nothing; round_up still grows past the floor for outliers.
    TERM = round_up(cap(lambda pd: len(pd.affinity.node_required)), 2)
    EXPR = round_up(
        cap(
            lambda pd: max(
                [len(t.match_expressions) for t in pd.affinity.node_required]
                + [
                    len(t.preference.match_expressions)
                    for t in pd.affinity.node_preferred
                ]
                + [0]
            )
        ),
        4,
    )
    VAL = round_up(
        cap(
            lambda pd: max(
                [
                    len(e.values)
                    for t in pd.affinity.node_required
                    for e in t.match_expressions
                ]
                + [
                    len(e.values)
                    for t in pd.affinity.node_preferred
                    for e in t.preference.match_expressions
                ]
                + [0]
            )
        ),
        4,
    )
    NS = round_up(cap(lambda pd: len(pd.node_selector)), 4)
    PREF = round_up(cap(lambda pd: len(pd.affinity.node_preferred)), 2)
    TOL = round_up(cap(lambda pd: len(pd.tolerations)), 4)
    C = round_up(cap(lambda pd: len(pd.spread_constraints)), 2)
    A = round_up(
        cap(
            lambda pd: len(pd.affinity.pod_required)
            + len(pd.affinity.anti_required)
            + len(pd.affinity.pod_preferred)
            + len(pd.affinity.anti_preferred)
        ),
        2,
    )
    vols = [pd.local_volumes() for pd in reps]
    SV = round_up(max((max(len(l), len(d)) for l, d in vols), default=1), 2)
    HP = round_up(cap(lambda pd: len(pd.host_ports)), 2)
    AT = anti_table_size(enc)

    b = PodBatch(
        req=np.zeros((D, R), np.float32),
        has_req=np.zeros(D, bool),
        node_name_id=np.zeros(D, np.int32),
        gpu_mem=np.zeros(D, np.float32),
        gpu_num=np.zeros(D, np.float32),
        sel_op=np.zeros((D, TERM, EXPR), np.int32),
        sel_key=np.zeros((D, TERM, EXPR), np.int32),
        sel_val=np.zeros((D, TERM, EXPR, VAL), np.int32),
        sel_num=np.zeros((D, TERM, EXPR), np.float32),
        has_terms=np.zeros(D, bool),
        ns_pair=np.zeros((D, NS), np.int32),
        pref_weight=np.zeros((D, PREF), np.float32),
        pref_op=np.zeros((D, PREF, EXPR), np.int32),
        pref_key=np.zeros((D, PREF, EXPR), np.int32),
        pref_val=np.zeros((D, PREF, EXPR, VAL), np.int32),
        pref_num=np.zeros((D, PREF, EXPR), np.float32),
        tol_key=np.zeros((D, TOL), np.int32),
        tol_val=np.zeros((D, TOL), np.int32),
        tol_exists=np.zeros((D, TOL), bool),
        tol_effect=np.zeros((D, TOL), np.int32),
        tol_valid=np.zeros((D, TOL), bool),
        spread_topo=np.full((D, C), -1, np.int32),
        spread_sel=np.zeros((D, C), np.int32),
        spread_skew=np.zeros((D, C), np.float32),
        spread_hard=np.zeros((D, C), bool),
        aff_topo=np.full((D, A), -1, np.int32),
        aff_sel=np.zeros((D, A), np.int32),
        aff_anti=np.zeros((D, A), bool),
        aff_required=np.zeros((D, A), bool),
        aff_weight=np.zeros((D, A), np.float32),
        lvm_req=np.zeros((D, SV), np.float32),
        lvm_vg=np.zeros((D, SV), np.int32),
        dev_req=np.zeros((D, SV), np.float32),
        dev_media_ssd=np.zeros((D, SV), bool),
        has_local=np.zeros(D, bool),
        match_sel=np.zeros((D, S), bool),
        owned_by_rs=np.zeros(D, bool),
        hp_pid=np.zeros((D, HP), np.int32),
        hp_wild=np.zeros((D, HP), bool),
        hp_ipid=np.zeros((D, HP), np.int32),
        match_anti=np.zeros((D, AT), bool),
        own_anti=np.zeros((D, AT), np.float32),
        valid=np.zeros(D, bool),
        keys=[pd.key for pd in pods],
    )

    for i, pod in enumerate(reps):
        b.valid[i] = True
        b.has_req[i] = bool(pod.requests)
        b.owned_by_rs[i] = pod.meta.owner_kind in ("ReplicaSet", "ReplicationController")
        for res, q in pod.requests.items():
            if res in enc.ignored_resources:
                continue  # extender-owned (factory.go:105-130), not fit-checked
            b.req[i, enc.resource_index(res)] = q / resource_scale(res)
        b.req[i, enc.resources.index("pods")] += 1.0  # each pod occupies a slot
        b.gpu_mem[i] = np.float32(pod.gpu_mem_request() / float(1 << 20))
        b.gpu_num[i] = float(pod.gpu_count_request())
        if pod.node_name:
            b.node_name_id[i] = enc.names.id(pod.node_name)
        for j, t in enumerate(pod.affinity.node_required[:TERM]):
            op, key, val, num = _encode_term_exprs(enc, t.match_expressions, EXPR, VAL)
            b.sel_op[i, j], b.sel_key[i, j], b.sel_val[i, j], b.sel_num[i, j] = op, key, val, num
        b.has_terms[i] = bool(pod.affinity.node_required)
        for j, (k, v) in enumerate(sorted(pod.node_selector.items())[:NS]):
            b.ns_pair[i, j] = enc.pair_id(k, v)
        for j, pref in enumerate(pod.affinity.node_preferred[:PREF]):
            b.pref_weight[i, j] = float(pref.weight)
            op, key, val, num = _encode_term_exprs(
                enc, pref.preference.match_expressions, EXPR, VAL
            )
            b.pref_op[i, j], b.pref_key[i, j], b.pref_val[i, j], b.pref_num[i, j] = (
                op, key, val, num,
            )
        for j, t in enumerate(pod.tolerations[:TOL]):
            b.tol_valid[i, j] = True
            b.tol_key[i, j] = enc.keys.id(t.key) if t.key else 0
            b.tol_val[i, j] = enc.vals.id(t.value) if t.value else enc.vals.id("")
            b.tol_exists[i, j] = t.operator == "Exists"
            b.tol_effect[i, j] = _EFFECTS.get(t.effect, 0)
        for j, c in enumerate(pod.spread_constraints[:C]):
            b.spread_topo[i, j] = enc.topo_index(c.topology_key) if c.topology_key else -1
            b.spread_sel[i, j] = enc.selector_id((pod.meta.namespace,), c.selector)
            b.spread_skew[i, j] = float(c.max_skew)
            b.spread_hard[i, j] = c.when_unsatisfiable == "DoNotSchedule"
        terms = (
            [(t, False, True, 0.0) for t in pod.affinity.pod_required]
            + [(t, True, True, 0.0) for t in pod.affinity.anti_required]
            + [(wt.term, False, False, float(wt.weight)) for wt in pod.affinity.pod_preferred]
            + [(wt.term, True, False, float(wt.weight)) for wt in pod.affinity.anti_preferred]
        )
        for j, (t, anti, required, weight) in enumerate(terms[:A]):
            b.aff_topo[i, j] = enc.topo_index(t.topology_key) if t.topology_key else -1
            b.aff_sel[i, j] = enc.selector_id(t.namespaces or (pod.meta.namespace,), t.selector)
            b.aff_anti[i, j] = anti
            b.aff_required[i, j] = required
            b.aff_weight[i, j] = weight
        b.match_sel[i] = match_vector(enc, pod)
        for j, (pid, wild, ipid) in enumerate(enc.port_ids(pod)[:HP]):
            b.hp_pid[i, j] = pid
            b.hp_wild[i, j] = wild
            b.hp_ipid[i, j] = ipid
        for t, (_k_idx, sel_id) in enumerate(enc.anti_terms):
            b.match_anti[i, t] = b.match_sel[i, sel_id]  # same SelectorEntry
        for aid in enc.anti_ids(pod):
            b.own_anti[i, aid] += 1.0
        lvm_vols, dev_vols = vols[i]
        b.has_local[i] = bool(lvm_vols or dev_vols)
        # Explicit-VG volumes are allocated before binpack volumes, each class
        # in annotation order (ProcessLVMPVCPredicate handles pvcsWithVG first,
        # algo/common.go:59-75); device volumes are sorted ascending by size —
        # the reference sorts each media class ascending before the greedy
        # match (CheckExclusiveResourceMeetsPVCSize, algo/common.go:291-294),
        # and a stable ascending sort of the union preserves per-media order.
        lvm_vols = sorted(lvm_vols, key=lambda x: not x.vg_name)
        for j, v in enumerate(lvm_vols[:SV]):
            b.lvm_req[i, j] = np.float32(v.size / float(1 << 20))
            b.lvm_vg[i, j] = enc.vgs.id(v.vg_name) if v.vg_name else 0
        for j, v in enumerate(sorted(dev_vols, key=lambda x: x.size)[:SV]):
            b.dev_req[i, j] = np.float32(v.size / float(1 << 20))
            b.dev_media_ssd[i, j] = v.media_type == "ssd"

    # Expand representative rows to the full padded batch by gather.
    expanded = {}
    for f in b.__dataclass_fields__:
        if f == "keys":
            continue
        arr = getattr(b, f)
        out = np.zeros((P,) + arr.shape[1:], arr.dtype)
        if f in ("spread_topo", "aff_topo"):
            out[:] = -1  # pad rows keep the inactive sentinel
        if p:
            out[:p] = arr[inverse]
        expanded[f] = out
    return PodBatch(keys=b.keys, **expanded)


def aggregate_gpu_usage(
    nodes: Sequence[Node], placed: Sequence[Tuple[Pod, str]]
) -> Dict[str, np.ndarray]:
    """Per-node used-MiB-per-device arrays for already-bound GPU pods.

    Only pods carrying a gpu-index annotation contribute, and only to devices
    that exist (parity: addOrUpdatePod skips pods whose annotation is missing
    or unparseable, gpunodeinfo.go:122-140). The scheduler cache skips
    Succeeded/Failed pods (deviceinfo.go:45-67)."""
    by_name = {nd.name: nd for nd in nodes}
    used: Dict[str, np.ndarray] = {}
    for pod, node_name in placed:
        mem_bytes = pod.gpu_mem_request()
        if mem_bytes <= 0 or pod.phase in ("Succeeded", "Failed"):
            continue
        nd = by_name.get(node_name)
        if nd is None or nd.gpu_count() <= 0:
            continue
        ids = pod.gpu_index_ids()
        if not ids:
            continue
        mem = np.float32(mem_bytes / float(1 << 20))
        arr = used.setdefault(node_name, np.zeros(nd.gpu_count(), np.float32))
        for d in ids:
            if 0 <= d < len(arr):
                arr[d] += mem
    return used


def aggregate_usage(placed: Sequence[Tuple[Pod, str]]) -> Dict[str, Dict[str, int]]:
    """Canonical per-node request totals of already-bound pods, including the
    implicit 'pods' slot each pod occupies — feed this to encode_nodes so
    NodeResourcesFit sees both resource and pod-count pressure."""
    usage: Dict[str, Dict[str, int]] = {}
    for pod, node_name in placed:
        tot = usage.setdefault(node_name, {})
        for res, q in pod.requests.items():
            tot[res] = tot.get(res, 0) + q
        tot["pods"] = tot.get("pods", 0) + 1
    return usage


def selector_table_size(enc: Encoder) -> int:
    """Bucketed S axis (sel_counts rows / match_sel columns): registering one
    more selector must not change every kernel's shape — pad rows hold zero
    counts and False matches, which every consumer treats as inert."""
    return round_up(max(len(enc.selectors), 1), 8)


def anti_table_size(enc: Encoder) -> int:
    """Bucketed AT axis (anti_counts rows / match_anti columns / anti_topo);
    pad rows carry topo -1, which deactivates them in pod_affinity_mask."""
    return round_up(max(len(enc.anti_terms), 1), 2)


def port_table_sizes(enc: Encoder) -> Tuple[int, int]:
    """(PID, PIP) axis sizes for the port count tables. Row 0 is the pad row
    (vocab ids are 1-based), so sizes are len+1 rounded for bucket stability."""
    return round_up(len(enc.ports) + 1, 2), round_up(len(enc.port_ips) + 1, 2)


def initial_port_counts(
    enc: Encoder,
    table: NodeTable,
    placed: Sequence[Tuple[Pod, str]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(port_any f32[PID,N], port_wild f32[PID,N], port_ipc f32[PIP,N]):
    host-port usage counts of already-bound pods, per node. port_any counts
    every use of a (protocol, port) pair; port_wild only wildcard-hostIP uses;
    port_ipc counts per specific (protocol, port, hostIP) triple."""
    PID, PIP = port_table_sizes(enc)
    port_any = np.zeros((PID, table.n), np.float32)
    port_wild = np.zeros((PID, table.n), np.float32)
    port_ipc = np.zeros((PIP, table.n), np.float32)
    node_index = {name: i for i, name in enumerate(table.names)}
    for pod, node_name in placed:
        ni = node_index.get(node_name)
        if ni is None or not pod.host_ports:
            continue
        for pid, wild, ipid in enc.port_ids(pod):
            if pid < PID:
                port_any[pid, ni] += 1.0
                if wild:
                    port_wild[pid, ni] += 1.0
            if not wild and ipid < PIP:
                port_ipc[ipid, ni] += 1.0
    return port_any, port_wild, port_ipc


def initial_anti_counts(
    enc: Encoder,
    table: NodeTable,
    placed: Sequence[Tuple[Pod, str]],
) -> np.ndarray:
    """anti_counts f32[AT,N]: per (required-anti-affinity term, node) count of
    already-placed pods carrying the term. Bound pods' terms must have been
    registered (register_pods) before this is called."""
    AT = anti_table_size(enc)
    counts = np.zeros((AT, table.n), np.float32)
    node_index = {name: i for i, name in enumerate(table.names)}
    for pod, node_name in placed:
        ni = node_index.get(node_name)
        if ni is None:
            continue
        for aid in enc.anti_ids(pod):
            counts[aid, ni] += 1.0
    return counts


def match_vector(enc: Encoder, pod: Pod) -> np.ndarray:
    """bool[S] — which registered selectors match this pod. Memoized by the
    pod's (namespace, labels) signature: workload replicas are label-identical
    clones, so a 100k-pod cluster hits the Python matcher only once per
    distinct workload instead of pods x selectors times (the reference's
    per-pod listers pay the full product; SURVEY §5.7 scale strategy)."""
    S = selector_table_size(enc)
    sig = (pod.meta.namespace, tuple(sorted(pod.meta.labels.items())))
    cached = enc._match_cache.get(sig)
    if cached is not None and cached.shape[0] == S:
        return cached
    vec = np.zeros(S, bool)
    for s, entry in enumerate(enc.selectors):
        vec[s] = entry.matches(pod)
    enc._match_cache[sig] = vec
    return vec


def initial_selector_counts(
    enc: Encoder,
    table: NodeTable,
    placed: Sequence[Tuple[Pod, str]],
) -> np.ndarray:
    """sel_counts f32[S,N]: per (selector, node) count of already-placed pods
    matching the selector. Seeded from existing cluster pods; maintained on
    device as the scan carry afterwards."""
    S = selector_table_size(enc)
    counts = np.zeros((S, table.n), np.float32)
    node_index = {name: i for i, name in enumerate(table.names)}
    for pod, node_name in placed:
        ni = node_index.get(node_name)
        if ni is None:
            continue
        counts[:, ni] += match_vector(enc, pod)
    return counts
