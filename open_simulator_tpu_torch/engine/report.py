"""Simulation reports: cluster / node / app views.

Parity: the pterm report tables in upstream `pkg/apply/apply.go:308-687`
(reportClusterInfo, reportNodeInfo, reportApp*): per-node requested vs
allocatable cpu/mem with percentages, pod counts, new-node marking, pod→node
placements grouped by workload, and unscheduled pods with reasons.
"""

from __future__ import annotations

from ..core.objects import (
    ANNO_WORKLOAD_KIND,
    ANNO_WORKLOAD_NAME,
    LABEL_NEW_NODE,
    Node,
    Pod,
)
from ..utils.quantity import format_bytes, format_milli
from ..utils.tables import render_table
from .simulator import SimulateResult


def _pct(used: float, total: float) -> str:
    if total <= 0:
        return "-"
    return f"{100.0 * used / total:.1f}%"


def cluster_report(result: SimulateResult) -> str:
    headers = [
        "Node", "CPU Alloc", "CPU Req", "CPU%", "Mem Alloc", "Mem Req", "Mem%",
        "Pods", "PodCap", "New",
    ]
    rows = []
    total_cpu = total_cpu_req = 0
    total_mem = total_mem_req = 0
    for st in result.node_status:
        node = st.node
        cpu_alloc = node.allocatable.get("cpu", 0)
        mem_alloc = node.allocatable.get("memory", 0)
        cpu_req = sum(p.requests.get("cpu", 0) for p in st.pods)
        mem_req = sum(p.requests.get("memory", 0) for p in st.pods)
        total_cpu += cpu_alloc
        total_cpu_req += cpu_req
        total_mem += mem_alloc
        total_mem_req += mem_req
        rows.append(
            [
                node.name,
                format_milli(cpu_alloc),
                format_milli(cpu_req),
                _pct(cpu_req, cpu_alloc),
                format_bytes(mem_alloc),
                format_bytes(mem_req),
                _pct(mem_req, mem_alloc),
                len(st.pods),
                node.allocatable.get("pods", 0),
                "yes" if LABEL_NEW_NODE in node.meta.labels else "",
            ]
        )
    rows.append(
        [
            "(total)",
            format_milli(total_cpu),
            format_milli(total_cpu_req),
            _pct(total_cpu_req, total_cpu),
            format_bytes(total_mem),
            format_bytes(total_mem_req),
            _pct(total_mem_req, total_mem),
            sum(len(st.pods) for st in result.node_status),
            "",
            "",
        ]
    )
    return render_table(headers, rows)


def placement_report(result: SimulateResult) -> str:
    headers = ["Node", "Pod", "Workload", "CPU Req", "Mem Req"]
    rows = []
    for st in sorted(result.node_status, key=lambda s: s.node.name):
        for pod in sorted(st.pods, key=lambda p: p.key):
            kind = pod.meta.annotations.get(ANNO_WORKLOAD_KIND, "Pod")
            name = pod.meta.annotations.get(ANNO_WORKLOAD_NAME, "")
            rows.append(
                [
                    st.node.name,
                    pod.key,
                    f"{kind}/{name}" if name else kind,
                    format_milli(pod.requests.get("cpu", 0)),
                    format_bytes(pod.requests.get("memory", 0)),
                ]
            )
    return render_table(headers, rows)


def storage_report(result: SimulateResult) -> str:
    """Open-local view: per-node VG utilization and device allocation
    (parity: the local-storage tables of reportExtendedResource,
    apply.go:526-614)."""
    if not result.storage:
        return ""
    headers = ["Node", "Resource", "Capacity", "Requested", "Util/Alloc"]
    rows = []
    for name in sorted(result.storage):
        st = result.storage[name]
        for vg in st.vgs:
            rows.append(
                [
                    name,
                    f"VG {vg.name}",
                    format_bytes(vg.capacity),
                    format_bytes(vg.requested),
                    _pct(vg.requested, vg.capacity),
                ]
            )
        for dev in st.devices:
            rows.append(
                [
                    name,
                    f"Device {dev.name} ({dev.media_type})",
                    format_bytes(dev.capacity),
                    "-",
                    "allocated" if dev.is_allocated else "free",
                ]
            )
    return render_table(headers, rows)


def gpu_report(result: SimulateResult) -> str:
    """GPU-share view: per-node per-device memory utilization from the bound
    pods' gpu-index annotations (parity: the gpu tables of
    reportExtendedResource, apply.go:616-687)."""
    headers = ["Node", "GPU", "Mem Total", "Mem Used", "Util", "Pods"]
    rows = []
    for st in sorted(result.node_status, key=lambda s: s.node.name):
        node = st.node
        count = node.gpu_count()
        if count <= 0:
            continue
        per_dev = node.gpu_mem_per_device()
        used = [0] * count
        pods_on = [0] * count
        for pod in st.pods:
            mem = pod.gpu_mem_request()
            if mem <= 0:
                continue
            for d in pod.gpu_index_ids():
                if 0 <= d < count:
                    used[d] += mem
                    pods_on[d] += 1
        for d in range(count):
            rows.append(
                [
                    node.name,
                    f"gpu-{d}",
                    format_bytes(per_dev),
                    format_bytes(used[d]),
                    _pct(used[d], per_dev),
                    pods_on[d],
                ]
            )
    if not rows:
        return ""
    return render_table(headers, rows)


def preempted_report(result: SimulateResult) -> str:
    """Victims evicted by DefaultPreemption (the reference emits 'Preempted'
    events via the event recorder; here they surface as a table)."""
    if not result.preempted:
        return ""
    headers = ["Victim", "Node", "Preempted By", "Priority"]
    rows = [
        [p.pod.key, p.node, p.by, p.pod.priority] for p in result.preempted
    ]
    return render_table(headers, rows)


def unscheduled_report(result: SimulateResult) -> str:
    if not result.unscheduled:
        return "All pods scheduled."
    headers = ["Pod", "Reason"]
    rows = [[u.pod.key, u.reason] for u in result.unscheduled]
    return render_table(headers, rows)


def full_report(
    result: SimulateResult,
    extended: bool = True,
    extended_resources=None,
) -> str:
    """Assembled report. `extended_resources` is the reference's
    --extended-resources flag (cmd/apply/apply.go:32; containLocalStorage /
    containGpu gate the tables, apply.go:777-789): an explicit list shows
    exactly the requested views ("open-local", "gpu"). None keeps every
    extended view that has data (the JAX package's default, a superset of
    the reference's hide-by-default)."""
    parts = [
        "=== Cluster ===",
        cluster_report(result),
        "=== Placements ===",
        placement_report(result),
    ]
    if extended:
        want_storage = extended_resources is None or "open-local" in extended_resources
        want_gpu = extended_resources is None or "gpu" in extended_resources
        stor = storage_report(result) if want_storage else ""
        if stor:
            parts += ["=== Local Storage ===", stor]
        gpu = gpu_report(result) if want_gpu else ""
        if gpu:
            parts += ["=== GPU Share ===", gpu]
    pre = preempted_report(result)
    if pre:
        parts += ["=== Preempted ===", pre]
    parts += ["=== Unscheduled ===", unscheduled_report(result)]
    return "\n\n".join(parts)
