"""K8s-lite object model: the host-side representation of cluster state.

The port's own copy of the scheduling-relevant object model: lightweight
dataclasses with only the scheduling-relevant fields, plus the original decoded
dict in `raw`.

All resource amounts are canonicalized at parse time:
  cpu            -> millicores (int)
  memory, ephemeral-storage, hugepages-*  -> bytes (int)
  pods and extended resources (counts)    -> plain int
"""

from __future__ import annotations

from dataclasses import dataclass, field
import math
from typing import Dict, List, Optional, Tuple

from ..utils.quantity import parse_quad, parse_quantity

# Canonical resource names (mirrors corev1.ResourceName constants).
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"

# simon annotation/label names (parity: upstream pkg/type/const.go:12-43)
ANNO_WORKLOAD_KIND = "simon/workload-kind"
ANNO_WORKLOAD_NAME = "simon/workload-name"
ANNO_WORKLOAD_NAMESPACE = "simon/workload-namespace"
ANNO_NODE_LOCAL_STORAGE = "simon/node-local-storage"
ANNO_POD_LOCAL_STORAGE = "simon/pod-local-storage"
ANNO_NODE_GPU_SHARE = "simon/node-gpu-share"
ANNO_POD_PROVISIONER = "simon/pod-provisioner"
LABEL_NEW_NODE = "simon/new-node"
LABEL_APP_NAME = "simon/app-name"

# open-gpu-share annotation keys (parity: pkg/type/open-gpu-share/utils/const.go:4-8)
ANNO_GPU_MEM_POD = "alibabacloud.com/gpu-mem"
ANNO_GPU_COUNT_POD = "alibabacloud.com/gpu-count"
ANNO_GPU_INDEX = "alibabacloud.com/gpu-index"
ANNO_GPU_COUNT_NODE = "alibabacloud.com/gpu-count"
ANNO_GPU_MODEL_NODE = "alibabacloud.com/gpu-card-model"
RESOURCE_GPU_COUNT = "alibabacloud.com/gpu-count"

DEFAULT_SCHEDULER = "default-scheduler"

# open-local / yoda storage-class name table (parity: pkg/utils/const.go:3-17).
# LVM membership mirrors GetPodLocalPVCs (pkg/utils/utils.go:598-607): only the
# two LVM class names route to the VG path; every other known class is an
# exclusive-device request.
LVM_SC_NAMES = {"open-local-lvm", "yoda-lvm-default"}
SSD_SC_NAMES = {
    "open-local-device-ssd",
    "open-local-mountpoint-ssd",
    "yoda-mountpoint-ssd",
    "yoda-device-ssd",
}
HDD_SC_NAMES = {
    "open-local-device-hdd",
    "open-local-mountpoint-hdd",
    "yoda-mountpoint-hdd",
    "yoda-device-hdd",
}


def _canon_resources(res: Optional[dict], round_up: bool) -> Dict[str, int]:
    """Canonicalize a resource map. round_up for requests (conservative: a pod
    never claims less than it asked), down for node allocatable."""
    out: Dict[str, int] = {}
    if not res:
        return out
    rounder = math.ceil if round_up else math.floor
    for name, val in res.items():
        if isinstance(val, str):
            # cached parse (utils.quantity.parse_quad)
            mc, mf, bc, bf = parse_quad(val)
            if name == CPU:
                out[str(name)] = mc if round_up else mf
            else:
                out[str(name)] = bc if round_up else bf
            continue
        q = parse_quantity(val)
        if name == CPU:
            q *= 1000
        out[str(name)] = int(rounder(q))
    return out


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_kind: str = ""
    owner_name: str = ""

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ObjectMeta":
        d = d or {}
        owner_kind = owner_name = ""
        owners = d.get("ownerReferences") or []
        if owners:
            owner_kind = owners[0].get("kind", "")
            owner_name = owners[0].get("name", "")
        return ObjectMeta(
            name=d.get("name", "") or d.get("generateName", ""),
            namespace=d.get("namespace") or "default",
            labels=dict(d.get("labels") or {}),
            annotations={k: str(v) for k, v in (d.get("annotations") or {}).items()},
            owner_kind=owner_kind,
            owner_name=owner_name,
        )


@dataclass
class Toleration:
    key: str = ""          # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""       # empty matches all effects

    @staticmethod
    def from_dict(d: dict) -> "Toleration":
        # An empty operator means Equal (vendored toleration.go ToleratesTaint).
        return Toleration(
            key=d.get("key", "") or "",
            operator=d.get("operator") or "Equal",
            value=str(d.get("value", "") or ""),
            effect=d.get("effect", "") or "",
        )


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute

    @staticmethod
    def from_dict(d: dict) -> "Taint":
        return Taint(
            key=d.get("key", ""),
            value=str(d.get("value", "") or ""),
            effect=d.get("effect", "NoSchedule"),
        )


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions."""
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["LabelSelector"]:
        if d is None:
            return None
        exprs = [
            LabelSelectorRequirement(
                key=e.get("key", ""),
                operator=e.get("operator", "In"),
                values=[str(v) for v in (e.get("values") or [])],
            )
            for e in (d.get("matchExpressions") or [])
        ]
        return LabelSelector(
            match_labels={k: str(v) for k, v in (d.get("matchLabels") or {}).items()},
            match_expressions=exprs,
        )

    def key(self) -> Tuple:
        """Hashable identity used to dedupe selectors during tensorization."""
        return (
            tuple(sorted(self.match_labels.items())),
            tuple((e.key, e.operator, tuple(e.values)) for e in self.match_expressions),
        )


@dataclass
class NodeSelectorTerm:
    """One term: AND of requirements over labels (and fields, which we fold in)."""
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "NodeSelectorTerm":
        exprs = []
        for part in ("matchExpressions", "matchFields"):
            for e in d.get(part) or []:
                key = e.get("key", "")
                if part == "matchFields" and key == "metadata.name":
                    key = "kubernetes.io/hostname"  # field selector on name ~ hostname label
                exprs.append(
                    LabelSelectorRequirement(
                        key=key,
                        operator=e.get("operator", "In"),
                        values=[str(v) for v in (e.get("values") or [])],
                    )
                )
        return NodeSelectorTerm(match_expressions=exprs)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class PodAffinityTerm:
    selector: Optional[LabelSelector]
    topology_key: str
    namespaces: List[str] = field(default_factory=list)

    @staticmethod
    def from_dict(d: dict) -> "PodAffinityTerm":
        return PodAffinityTerm(
            selector=LabelSelector.from_dict(d.get("labelSelector")),
            topology_key=d.get("topologyKey", ""),
            namespaces=list(d.get("namespaces") or []),
        )


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass
class Affinity:
    # node affinity
    node_required: List[NodeSelectorTerm] = field(default_factory=list)   # OR of terms
    node_preferred: List[PreferredSchedulingTerm] = field(default_factory=list)
    # pod (anti) affinity
    pod_required: List[PodAffinityTerm] = field(default_factory=list)
    pod_preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)
    anti_required: List[PodAffinityTerm] = field(default_factory=list)
    anti_preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "Affinity":
        a = Affinity()
        if not d:
            return a
        na = d.get("nodeAffinity") or {}
        req = na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
        a.node_required = [
            NodeSelectorTerm.from_dict(t) for t in (req.get("nodeSelectorTerms") or [])
        ]
        a.node_preferred = [
            PreferredSchedulingTerm(
                weight=int(t.get("weight", 1)),
                preference=NodeSelectorTerm.from_dict(t.get("preference") or {}),
            )
            for t in (na.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
        ]
        for src, req_dst, pref_dst in (
            ("podAffinity", "pod_required", "pod_preferred"),
            ("podAntiAffinity", "anti_required", "anti_preferred"),
        ):
            pa = d.get(src) or {}
            setattr(
                a,
                req_dst,
                [
                    PodAffinityTerm.from_dict(t)
                    for t in (pa.get("requiredDuringSchedulingIgnoredDuringExecution") or [])
                ],
            )
            setattr(
                a,
                pref_dst,
                [
                    WeightedPodAffinityTerm(
                        weight=int(t.get("weight", 1)),
                        term=PodAffinityTerm.from_dict(t.get("podAffinityTerm") or {}),
                    )
                    for t in (pa.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
                ],
            )
        return a

    def empty(self) -> bool:
        return not (
            self.node_required
            or self.node_preferred
            or self.pod_required
            or self.pod_preferred
            or self.anti_required
            or self.anti_preferred
        )


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    selector: Optional[LabelSelector]

    @staticmethod
    def from_dict(d: dict) -> "TopologySpreadConstraint":
        return TopologySpreadConstraint(
            max_skew=int(d.get("maxSkew", 1)),
            topology_key=d.get("topologyKey", ""),
            when_unsatisfiable=d.get("whenUnsatisfiable", "DoNotSchedule"),
            selector=LabelSelector.from_dict(d.get("labelSelector")),
        )


def pod_requests_from_spec(spec: dict) -> Dict[str, int]:
    """Effective pod resource requests.

    max(sum(app containers), max(init containers)) + overhead — the formula from
    kubectl's resourcehelper.PodRequestsAndLimits used by the reference at
    `pkg/simulator/plugin/simon.go:46` and `pkg/algo/greed.go:55`.
    """
    total: Dict[str, int] = {}
    for c in spec.get("containers") or []:
        for name, v in _canon_resources((c.get("resources") or {}).get("requests"), True).items():
            total[name] = total.get(name, 0) + v
    for c in spec.get("initContainers") or []:
        for name, v in _canon_resources((c.get("resources") or {}).get("requests"), True).items():
            if v > total.get(name, 0):
                total[name] = v
    for name, v in _canon_resources(spec.get("overhead"), True).items():
        total[name] = total.get(name, 0) + v
    return total


def pod_limits_from_spec(spec: dict) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for c in spec.get("containers") or []:
        for name, v in _canon_resources((c.get("resources") or {}).get("limits"), True).items():
            total[name] = total.get(name, 0) + v
    for c in spec.get("initContainers") or []:
        for name, v in _canon_resources((c.get("resources") or {}).get("limits"), True).items():
            if v > total.get(name, 0):
                total[name] = v
    return total


# ---------------------------------------------------------------------------
# Open-Local storage model (parity: utils.NodeStorage/Volume/VolumeRequest,
# pkg/utils/utils.go:510-530, and the open-local cache types
# vendor/github.com/alibaba/open-local/pkg/scheduler/algorithm/cache/types.go:50-65)
# ---------------------------------------------------------------------------

def _parse_int_lenient(v, default: int = 0) -> int:
    try:
        return int(str(v))
    except (TypeError, ValueError):
        return default


def _parse_bool_lenient(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() == "true"


@dataclass
class LocalVG:
    """A shared LVM volume group (SharedResource: json name/capacity/requested,
    capacity & requested serialized as strings)."""
    name: str
    capacity: int       # bytes
    requested: int = 0  # bytes already committed

    @staticmethod
    def from_dict(d: dict) -> "LocalVG":
        return LocalVG(
            name=str(d.get("name", "")),
            capacity=_parse_int_lenient(d.get("capacity")),
            requested=_parse_int_lenient(d.get("requested")),
        )


@dataclass
class LocalDevice:
    """An exclusive block device (ExclusiveResource: json name/device/capacity/
    mediaType/isAllocated, the booleans serialized as strings)."""
    name: str
    capacity: int            # bytes
    media_type: str = "hdd"  # "ssd" | "hdd"
    is_allocated: bool = False

    @staticmethod
    def from_dict(d: dict) -> "LocalDevice":
        return LocalDevice(
            name=str(d.get("device") or d.get("name") or ""),
            capacity=_parse_int_lenient(d.get("capacity")),
            media_type=str(d.get("mediaType", "hdd")).lower(),
            is_allocated=_parse_bool_lenient(d.get("isAllocated")),
        )


@dataclass
class NodeLocalStorage:
    """Decoded simon/node-local-storage annotation (utils.GetNodeStorage,
    pkg/utils/utils.go:527-539)."""
    vgs: List[LocalVG] = field(default_factory=list)
    devices: List[LocalDevice] = field(default_factory=list)

    @staticmethod
    def from_json(s: str) -> Optional["NodeLocalStorage"]:
        import json

        try:
            d = json.loads(s)
        except (ValueError, TypeError):
            return None
        if not isinstance(d, dict):
            return None
        return NodeLocalStorage(
            vgs=[LocalVG.from_dict(v) for v in d.get("vgs") or [] if isinstance(v, dict)],
            devices=[
                LocalDevice.from_dict(v)
                for v in d.get("devices") or []
                if isinstance(v, dict)
            ],
        )


@dataclass
class LocalVolume:
    """One entry of the simon/pod-local-storage VolumeRequest (utils.Volume:
    size serialized as string, kind in {LVM,SSD,HDD}, scName)."""
    size: int      # bytes
    kind: str
    sc_name: str
    vg_name: str = ""  # optional explicit VG (open-local's SC-parameter path)

    @property
    def is_lvm(self) -> bool:
        return self.sc_name in LVM_SC_NAMES

    @property
    def media_type(self) -> str:
        """Media type of a device request. The reference resolves it from the
        StorageClass parameters (GetMediaTypeFromPVC); simon's SC name table
        encodes it in the name, so we resolve from the name with the declared
        volume kind as fallback."""
        if self.sc_name in SSD_SC_NAMES or "ssd" in self.sc_name:
            return "ssd"
        if self.sc_name in HDD_SC_NAMES or "hdd" in self.sc_name:
            return "hdd"
        return "ssd" if self.kind.upper() == "SSD" else "hdd"


@dataclass
class Pod:
    meta: ObjectMeta
    requests: Dict[str, int] = field(default_factory=dict)
    limits: Dict[str, int] = field(default_factory=dict)
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Affinity = field(default_factory=Affinity)
    tolerations: List[Toleration] = field(default_factory=list)
    spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    scheduler_name: str = DEFAULT_SCHEDULER
    priority: int = 0
    preemption_policy: str = "PreemptLowerPriority"
    phase: str = "Pending"
    # (protocol, port, hostIP); hostIP "" or "0.0.0.0" = wildcard
    host_ports: List[Tuple[str, int, str]] = field(default_factory=list)
    pvc_names: List[str] = field(default_factory=list)
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "Pod":
        meta = ObjectMeta.from_dict(d.get("metadata"))
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        # NodePorts filter parity: app containers only (vendored node_ports.go:64
        # iterates pod.Spec.Containers, not initContainers).
        host_ports: List[Tuple[str, int, str]] = []
        host_network = bool(spec.get("hostNetwork"))
        for c in spec.get("containers") or []:
            for p in c.get("ports") or []:
                hp = p.get("hostPort", 0)
                cp = p.get("containerPort", 0)
                port = hp or (cp if host_network else 0)
                if port:
                    host_ports.append(
                        (p.get("protocol", "TCP"), int(port), p.get("hostIP", "") or "")
                    )
        pvcs = [
            v["persistentVolumeClaim"]["claimName"]
            for v in (spec.get("volumes") or [])
            if isinstance(v, dict) and v.get("persistentVolumeClaim")
        ]
        return Pod(
            meta=meta,
            requests=pod_requests_from_spec(spec),
            limits=pod_limits_from_spec(spec),
            node_name=spec.get("nodeName", "") or "",
            node_selector={k: str(v) for k, v in (spec.get("nodeSelector") or {}).items()},
            affinity=Affinity.from_dict(spec.get("affinity")),
            tolerations=[Toleration.from_dict(t) for t in (spec.get("tolerations") or [])],
            spread_constraints=[
                TopologySpreadConstraint.from_dict(t)
                for t in (spec.get("topologySpreadConstraints") or [])
            ],
            scheduler_name=spec.get("schedulerName") or DEFAULT_SCHEDULER,
            priority=int(spec.get("priority") or 0),
            preemption_policy=spec.get("preemptionPolicy") or "PreemptLowerPriority",
            phase=status.get("phase", "Pending"),
            host_ports=host_ports,
            pvc_names=pvcs,
            raw=d,
        )

    @property
    def key(self) -> str:
        return f"{self.meta.namespace}/{self.meta.name}"

    def gpu_mem_request(self) -> int:
        """Per-GPU memory request in bytes. The annotation is a resource
        quantity like `1024Mi` (parity: GetGpuMemoryFromPodAnnotation,
        pkg/type/open-gpu-share/utils/pod.go:57-67)."""
        v = self.meta.annotations.get(ANNO_GPU_MEM_POD)
        if v is None:
            return 0
        try:
            return int(parse_quantity(str(v)))
        except ValueError:
            return 0

    def gpu_count_request(self) -> int:
        """GPU count from the open-gpu-share annotation (parity:
        GetGpuCountFromPodAnnotation, utils/pod.go:69-79 — defaults to 0, so a
        gpu-mem-only pod is unschedulable everywhere, exactly like the
        reference's AllocateGpuId bailing on reqGpuNum <= 0)."""
        v = self.meta.annotations.get(ANNO_GPU_COUNT_POD)
        try:
            if v is not None and int(v) >= 0:  # reference rejects negatives
                return int(v)
        except ValueError:
            pass
        return 0

    def local_volumes(self) -> Tuple[List["LocalVolume"], List["LocalVolume"]]:
        """(lvm_volumes, device_volumes) from the simon/pod-local-storage
        annotation (parity: utils.GetPodLocalPVCs, pkg/utils/utils.go:580-625:
        kind must be LVM/SSD/HDD; the two LVM storage-class names route to the
        VG path, everything else is an exclusive device)."""
        import json

        s = self.meta.annotations.get(ANNO_POD_LOCAL_STORAGE)
        if not s:
            return [], []
        try:
            d = json.loads(s)
        except (ValueError, TypeError):
            return [], []
        lvm: List[LocalVolume] = []
        dev: List[LocalVolume] = []
        for v in (d.get("volumes") or []) if isinstance(d, dict) else []:
            if not isinstance(v, dict):
                continue
            kind = str(v.get("kind", ""))
            if kind not in ("LVM", "SSD", "HDD"):
                continue  # unsupported volume kind — reference logs and skips
            vol = LocalVolume(
                size=_parse_int_lenient(v.get("size")),
                kind=kind,
                sc_name=str(v.get("scName") or v.get("storageClassName") or ""),
                vg_name=str(v.get("vgName", "")),
            )
            (lvm if vol.is_lvm else dev).append(vol)
        return lvm, dev

    def gpu_index_ids(self) -> List[int]:
        """Allocated device ids from the gpu-index annotation, e.g. "2-3-4" ->
        [2,3,4] (parity: GpuIdStrToIntList, utils/pod.go:102-116). Duplicated
        ids are legal: the multi-GPU allocator may pack several shares onto one
        device (gpunodeinfo.go:271-283)."""
        v = self.meta.annotations.get(ANNO_GPU_INDEX)
        if not v:
            return []
        try:
            return [int(x) for x in str(v).split("-")]
        except ValueError:
            return []


@dataclass
class Node:
    meta: ObjectMeta
    allocatable: Dict[str, int] = field(default_factory=dict)
    capacity: Dict[str, int] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False
    raw: dict = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict) -> "Node":
        meta = ObjectMeta.from_dict(d.get("metadata"))
        spec = d.get("spec") or {}
        status = d.get("status") or {}
        node = Node(
            meta=meta,
            allocatable=_canon_resources(status.get("allocatable"), False),
            capacity=_canon_resources(status.get("capacity"), False),
            taints=[Taint.from_dict(t) for t in (spec.get("taints") or [])],
            unschedulable=bool(spec.get("unschedulable")),
            raw=d,
        )
        # Ensure the hostname label exists (kubelet guarantees it in practice).
        node.meta.labels.setdefault("kubernetes.io/hostname", meta.name)
        return node

    @property
    def name(self) -> str:
        return self.meta.name

    def gpu_total_mem(self) -> int:
        """Total GPU memory in bytes from status.capacity (parity:
        GetTotalGpuMemory, pkg/type/open-gpu-share/utils/node.go:11-17)."""
        return self.capacity.get(ANNO_GPU_MEM_POD, 0)

    def gpu_count(self) -> int:
        """Number of physical GPUs from status.capacity (parity:
        GetGpuCountInNode, utils/node.go:20-26)."""
        return self.capacity.get(RESOURCE_GPU_COUNT, 0)

    def gpu_mem_per_device(self) -> int:
        """Per-device memory in bytes (parity: DeviceInfo totalGpuMem =
        nodeGpuMem / gpuCount, pkg/type/open-gpu-share/cache/deviceinfo.go)."""
        c = self.gpu_count()
        return self.gpu_total_mem() // c if c > 0 else 0

    def local_storage(self) -> Optional[NodeLocalStorage]:
        """Decoded simon/node-local-storage annotation, or None when the node
        has no local storage (parity: utils.GetNodeStorage/GetNodeCache,
        pkg/utils/utils.go:527-563)."""
        s = self.meta.annotations.get(ANNO_NODE_LOCAL_STORAGE)
        if not s:
            return None
        return NodeLocalStorage.from_json(s)
