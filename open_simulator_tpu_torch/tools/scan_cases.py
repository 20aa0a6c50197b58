"""Seeded node-local light-scan chunks: the light_scan CUDA kernel against
its plain version.

`build(name, device)` makes one chunk's `ops.fast.light_scan` arguments
from the case's seed (a numpy generator): nodes of random shape with GPUs,
open-local volume groups, tainted, unschedulable and labelled nodes, bound
pods holding the host port, one pod spec and its trajectory, x0 and the
chunk's offset. `kernel(args)` and `plain(args)` run the chunk through the
kernel (a card) and through `fast.light_scan_plain` on the same device;
`compare(name)` holds their nodes, lanes and exit x bit-equal.
tests/test_torch_light_scan_kernel.py and chip_smoke.py use them on the
card; `pai` is the benchmark cell pai_gpu.share's widest group at full
size, for timing. `chain_probe_ms(n, steps)` times the kernel's step
chain alone (csrc/scan_chain_probe.cu, CHAIN_SOURCE), its floor.
"""

from __future__ import annotations

import ctypes
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.objects import Node, Pod
from ..device import resolve_device
from ..ops import encode, fast, kernel_lib, light_scan, state
from ..ops.kernels import (
    DEFAULT_WEIGHTS, F_NODE_PORTS, F_RESOURCES, NUM_FILTERS, PodRow, weights_array,
)

GIB = 1 << 30
PORT = {"containerPort": 80, "hostPort": 8080}
STATIC_TERMS = ("node_affinity", "prefer_avoid_pods", "simon", "taint_toleration")
CHAIN_SOURCE = kernel_lib.CSRC / "scan_chain_probe.cu"
CHAIN_SYMBOLS = {"scan_chain_probe_launch": (
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int)}


class Case(NamedTuple):
    seed: int
    nodes: int
    pods: int                 # the chunk's group_size
    gpu: bool = False         # the pod asks for a GPU share (GPU state evolves)
    storage: bool = False     # the pod has an open-local volume (storage evolves)
    ports: bool = False       # the pod asks for a host port (port state evolves)
    ties: bool = False        # every node alike: every step a tie
    cpu: str = "2"            # the pod's cpu request
    j_steps: Optional[int] = None   # the trajectory's length (None: the fast path's)
    offset: int = 0           # steps an earlier chunk of the group ran
    valid: Optional[int] = None     # the group's valid_count (None: offset + pods)
    zero_static: bool = False  # the four static score weights set to 0
    filters_off: bool = False  # the ports and resources filters off
    pai: bool = False         # pai_gpu's node shapes (500 of 8 GPUs, 1,300 of 2)


CASES = {
    "gpu": Case(11, 150, 200, gpu=True),
    "storage": Case(12, 150, 200, storage=True),
    "ports": Case(13, 150, 160, ports=True),
    "gpu-storage-ports": Case(14, 150, 220, gpu=True, storage=True, ports=True),
    "resources-only": Case(15, 90, 150),
    "ties": Case(16, 64, 200, gpu=True, ties=True),
    "infeasible-first": Case(17, 40, 64, gpu=True, cpu="500"),
    "infeasible-mid": Case(18, 40, 300, gpu=True, storage=True),
    "offset": Case(19, 120, 96, gpu=True, offset=70, valid=130),
    "clamp": Case(20, 8, 160, j_steps=8, cpu="1"),
    "zero-static-weights": Case(21, 150, 200, gpu=True, storage=True, zero_static=True),
    "filters-off": Case(22, 60, 120, ports=True, filters_off=True),
    "pai": Case(23, 1800, 240, gpu=True, cpu="4", pai=True),
}


def _node(i: int, rng, case: Case) -> dict:
    if case.pai:
        big = i < 500
        cpu, mem, gpus = (96, 512, 8) if big else (64, 256, 2)
    elif case.ties:
        cpu, mem, gpus = 32, 128, 2
    else:
        cpu = int(rng.choice([8, 16, 32, 48, 64]))
        mem = int(rng.choice([32, 64, 128, 256]))
        gpus = int(rng.choice([1, 2, 4, 8]))
    alloc = {"cpu": str(cpu), "memory": f"{mem}Gi", "pods": "110"}
    if case.gpu:
        alloc.update({"alibabacloud.com/gpu-count": str(gpus),
                      "alibabacloud.com/gpu-mem": f"{16 * gpus}Gi"})
    meta = {"name": f"n-{i}", "labels": {"kubernetes.io/hostname": f"n-{i}"}}
    spec: dict = {}
    if not (case.ties or case.pai):
        meta["labels"]["tier"] = str(rng.choice(["gold", "silver"]))
        roll = rng.random()
        if roll < 0.12:
            spec["taints"] = [{"key": "spot", "value": "yes", "effect": "PreferNoSchedule"}]
        elif roll < 0.18:
            spec["taints"] = [{"key": "gpu-only", "value": "yes", "effect": "NoSchedule"}]
        elif roll < 0.22:
            spec["unschedulable"] = True
    if case.storage:
        cap = 40 if case.ties else int(rng.integers(10, 80))
        meta["annotations"] = {"simon/node-local-storage": json.dumps({
            "vgs": [{"name": "pool", "capacity": str(cap * GIB), "requested": "0"}],
            "devices": []})}
    return {"metadata": meta, "spec": spec,
            "status": {"allocatable": dict(alloc), "capacity": dict(alloc)}}


def _pod(case: Case, name: str = "p", port: bool = False) -> dict:
    c = {"name": "c", "resources": {"requests": {"cpu": case.cpu, "memory": "2Gi"}}}
    if port:
        c["ports"] = [dict(PORT)]
    anno = {}
    if case.gpu:
        anno.update({"alibabacloud.com/gpu-mem": "4Gi", "alibabacloud.com/gpu-count": "1"})
    if case.storage:
        anno["simon/pod-local-storage"] = json.dumps({"volumes": [
            {"kind": "LVM", "size": str(5 * GIB), "scName": "open-local-lvm"}]})
    spec: dict = {"containers": [c]}
    if not (case.ties or case.pai):
        spec["affinity"] = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 5, "preference": {"matchExpressions": [
                {"key": "tier", "operator": "In", "values": ["gold"]}]}}]}}
    return {"metadata": {"name": name, "namespace": "scan", "annotations": anno}, "spec": spec}


def build(name: str, device=None) -> dict:
    """One chunk's light_scan arguments (keyword form) for case `name`."""
    case = CASES[name]
    dev = resolve_device(device)
    rng = np.random.default_rng(case.seed)
    nodes = [Node.from_dict(_node(i, rng, case)) for i in range(case.nodes)]
    template = Pod.from_dict(_pod(case, port=case.ports))
    placed = []
    if case.ports:
        # bound pods holding the port on some nodes: their rows start infeasible
        for i in rng.choice(case.nodes, size=case.nodes // 8, replace=False):
            p = Pod.from_dict(_pod(case._replace(gpu=False, storage=False), f"b-{i}", True))
            p.node_name = f"n-{i}"
            placed.append((p, p.node_name))
    enc = encode.Encoder()
    enc.register_pods([template] + [p for p, _ in placed])
    table = encode.encode_nodes(enc, nodes, existing_usage=encode.aggregate_usage(placed))
    batch = encode.encode_pods(enc, [template])
    ns = state.node_static_from_table(enc, table, dev)
    carry = state.carry_from_table(
        table, encode.initial_selector_counts(enc, table, []),
        port_counts=encode.initial_port_counts(enc, table, placed),
        anti_counts=encode.initial_anti_counts(enc, table, []), device=dev,
    )
    rows = state.pod_rows_from_batch(batch, dev)
    pod = PodRow(*(a[0] for a in rows))
    flags = fast.group_flags(
        {f: getattr(batch, f)[0] for f in (
            "hp_pid", "has_local", "gpu_mem", "spread_topo", "spread_hard",
            "aff_topo", "aff_required", "match_anti")},
        ns.anti_topo.cpu().numpy(),
    )
    valid = case.offset + case.pods if case.valid is None else case.valid
    j_steps = case.j_steps
    if j_steps is None:
        j_need = fast._traj_len(carry.free.cpu().numpy(), ns.valid.cpu().numpy(),
                                batch.req[0], valid)
        j_steps = fast._bucket_j(j_need)
    w = dict(DEFAULT_WEIGHTS)
    if case.zero_static:
        w.update({k: 0.0 for k in STATIC_TERMS})
    weights = weights_array(w, device=dev)
    filter_on = None
    if case.filters_off:
        fo = np.ones(NUM_FILTERS, bool)
        fo[[F_NODE_PORTS, F_RESOURCES]] = False
        filter_on = torch.as_tensor(fo, device=dev)
    # a case may ask for a trajectory shorter than the fast path's bucket, so
    # that the chunk runs past its last lane (the refresh's clamp)
    traj, static_ok, _, static_scores, na_ok = fast.build_trajectory(
        ns, carry, pod, weights, j_steps, filter_on, flags)  # osim: lint-ok[unbucketed-jit-shape]
    args = dict(ns=ns, traj=traj, carry0=carry, pod=pod, static_ok=static_ok,
                static_scores=static_scores, na_ok=na_ok, weights=weights,
                x0=torch.zeros(ns.valid.shape[0], dtype=torch.int32, device=dev),
                offset=0, group_size=case.pods, valid_count=valid, filter_on=filter_on,
                flags=flags)
    if case.offset:
        # an earlier chunk of the same group, through the plain loop
        args["x0"] = plain({**args, "group_size": case.offset})[0]
        args["offset"] = case.offset
    return args


def plain(args: dict):
    """(x, nodes, jidx) of the chunk through light_scan's plain loop."""
    a = dict(args)
    fo = fast._filters_on(a.pop("filter_on"), a["x0"].device)
    return fast.light_scan_plain(**a, fo=fo)


def kernel(args: dict):
    """(x, nodes, jidx) of the chunk through the light_scan CUDA kernel."""
    a = args
    fo = fast._filters_on(a["filter_on"], a["x0"].device)
    return light_scan.scan_chunk(
        a["ns"], a["traj"], a["pod"], a["static_ok"], a["static_scores"], a["weights"], fo,
        a["x0"], fast._active_steps(a["offset"], a["group_size"], a["valid_count"]),
        a["group_size"], a["flags"])


def compare(name: str, device="cuda") -> dict:
    """Kernel against plain on case `name`: whether nodes, lanes and exit x
    are bit-equal, and what the chunk placed."""
    args = build(name, device)
    got, want = kernel(args), plain(args)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    nodes = want[1]
    return {"case": name, "equal": equal, "placed": int((nodes >= 0).sum()),
            "failed": int((nodes < 0).sum()), "max_x": int(want[0].max()),
            "j_steps": int(args["traj"].packed.shape[1]), "nodes": int(args["ns"].valid.sum())}


def chain_library():
    """The chain probe's library (built and loaded at the first call)."""
    return kernel_lib.open_library(CHAIN_SOURCE, CHAIN_SYMBOLS)


def chain_probe_ms(n: int, steps: int, reps: int = 5) -> float:
    """Milliseconds of `steps` chained steps of the probe in
    csrc/scan_chain_probe.cu at `n` nodes (CUDA events, mean of `reps`
    launches after one warm launch): the floor of the kernel's per-step
    chain."""
    fn = chain_library().scan_chain_probe_launch
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(n, steps, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"chain probe launch failed (1..4,096 nodes): CUDA error {err}")

    launch()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
