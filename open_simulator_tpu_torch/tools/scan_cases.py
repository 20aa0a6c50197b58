"""Seeded node-local light-scan chunks: the light_scan and trajectory CUDA
kernels against their plain versions.

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

The trajectory kernel (csrc/trajectory.cu) takes the cases with no port or
storage dynamics (`TRAJ_CASES`): `trajectory_inputs(name, device)` makes a
case's build_trajectory arguments, `trajectory(inputs, plain)` runs it
through the kernel (on a card) or the J-step loop, `compare_trajectory(name)`
holds every tensor of the two bit-equal, and `trajectory_ms(name)` times the
kernel's launch alone beside the whole build_trajectory, kernel and loop.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.objects import Node, Pod
from ..device import resolve_device
from ..ops import encode, fast, kernel_lib, light_scan, state
from ..ops import trajectory as traj_kernel
from ..ops.kernels import (
    DEFAULT_WEIGHTS, F_NODE_PORTS, F_RESOURCES, NUM_FILTERS, PodRow, gpu_mask, gpu_share_raw,
    local_storage_eval, ports_mask, weights_array,
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
    gpu_num: int = 1          # GPU shares the pod asks for (the prefix fill when > 1)
    gpu_mem: str = "4Gi"      # memory of each share
    gpuless: bool = False     # every third node has no GPU
    whole: int = 0            # whole GPUs the pod requests as a resource (no share)


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
    "two-gpus": Case(24, 150, 200, gpu=True, gpu_num=2),
    "gpu-oversize": Case(25, 60, 64, gpu=True, gpu_mem="32Gi"),
    "gpuless-nodes": Case(26, 120, 200, gpu=True, gpuless=True),
    "whole-gpus": Case(27, 100, 150, gpu=True, whole=1),
}
# the cases the trajectory kernel takes: no port or storage dynamics
TRAJ_CASES = tuple(name for name, c in CASES.items() if not (c.ports or c.storage))


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
    if case.gpu and not (case.gpuless and i % 3 == 0):
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
    if case.whole:
        c["resources"]["requests"]["alibabacloud.com/gpu-count"] = str(case.whole)
    if port:
        c["ports"] = [dict(PORT)]
    anno = {}
    if case.gpu and not case.whole:
        anno.update({"alibabacloud.com/gpu-mem": case.gpu_mem,
                     "alibabacloud.com/gpu-count": str(case.gpu_num)})
    if case.storage:
        anno["simon/pod-local-storage"] = json.dumps({"volumes": [
            {"kind": "LVM", "size": str(5 * GIB), "scName": "open-local-lvm"}]})
    spec: dict = {"containers": [c]}
    if not (case.ties or case.pai):
        spec["affinity"] = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 5, "preference": {"matchExpressions": [
                {"key": "tier", "operator": "In", "values": ["gold"]}]}}]}}
    return {"metadata": {"name": name, "namespace": "scan", "annotations": anno}, "spec": spec}


def trajectory_inputs(name: str, device=None) -> dict:
    """Case `name`'s build_trajectory arguments (keyword form), and its
    `valid` count under that key."""
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
    return dict(ns=ns, carry=carry, pod=pod, weights=weights, j_steps=j_steps,
                filter_on=filter_on, flags=flags, valid=valid)


def build(name: str, device=None) -> dict:
    """One chunk's light_scan arguments (keyword form) for case `name`."""
    case = CASES[name]
    inp = trajectory_inputs(name, device)
    ns, carry, pod, weights, filter_on, flags = (
        inp[k] for k in ("ns", "carry", "pod", "weights", "filter_on", "flags"))
    # a case may ask for a trajectory shorter than the fast path's bucket, so
    # that the chunk runs past its last lane (the refresh's clamp)
    traj, static_ok, _, static_scores, na_ok = fast.build_trajectory(
        ns, carry, pod, weights, inp["j_steps"], filter_on, flags)  # osim: lint-ok[unbucketed-jit-shape]
    args = dict(ns=ns, traj=traj, carry0=carry, pod=pod, static_ok=static_ok,
                static_scores=static_scores, na_ok=na_ok, weights=weights,
                x0=torch.zeros(ns.valid.shape[0], dtype=torch.int32, device=ns.valid.device),
                offset=0, group_size=case.pods, valid_count=inp["valid"], filter_on=filter_on,
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


@contextlib.contextmanager
def loop_route():
    """build_trajectory takes its J-step loop inside the block, whatever the
    device: the routing rule patched to refuse the kernel (one thread)."""
    rule = fast._takes_traj_kernel
    fast._takes_traj_kernel = lambda free, flags: False
    try:
        yield
    finally:
        fast._takes_traj_kernel = rule


def trajectory(inputs: dict, plain: bool = False) -> tuple:
    """build_trajectory's outputs on trajectory_inputs(...) `inputs`:
    through the routing rule (the kernel, on a card), or with `plain`
    through the J-step loop."""
    a = {k: v for k, v in inputs.items() if k != "valid"}
    with loop_route() if plain else contextlib.nullcontext():
        return fast.build_trajectory(**a)


def _bits(t) -> torch.Tensor:
    """A float tensor's bit patterns (so -0.0 and NaN payloads count)."""
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def same_trajectory(got: tuple, want: tuple) -> list:
    """The names of build_trajectory's outputs that differ bit for bit."""
    names = [f"traj.{f}" for f in fast.Trajectory._fields] + ["static_ok", "static_ff"]
    pairs = list(zip(got[0], want[0])) + [(got[1], want[1]), (got[2], want[2])]
    bad = [n for n, (a, b) in zip(names, pairs)
           if a.shape != b.shape or not torch.equal(_bits(a), _bits(b))]
    bad += [f"static_scores.{k}" for k in want[3]
            if not torch.equal(_bits(got[3][k]), _bits(want[3][k]))]
    return bad + ([] if torch.equal(got[4], want[4]) else ["na_ok"])


def compare_trajectory(name: str, device="cuda") -> dict:
    """The trajectory kernel against the J-step loop on case `name`: the
    outputs that differ bit for bit (none when equal) and the launches."""
    inputs = trajectory_inputs(name, device)
    before = kernel_lib.launches("trajectory")
    got = trajectory(inputs)
    launched = kernel_lib.launches("trajectory") - before
    want = trajectory(inputs, plain=True)
    n, j, r = want[0].free.shape
    return {"case": name, "differ": same_trajectory(got, want), "launches": launched,
            "nodes": int(inputs["ns"].valid.sum()), "rows": n, "j_steps": j, "resources": r,
            "gpus": int(want[0].gpu_free.shape[2]), "dyn_gpu": inputs["flags"].dyn_gpu}


def entry_rows(inputs: dict) -> tuple:
    """The trajectory kernel's entry rows f32[N] as build_trajectory makes
    them: (port_ok, sto_ok, sto_raw, None or (gpu_ok, gpu_raw))."""
    ns, carry, pod, flags = (inputs[k] for k in ("ns", "carry", "pod", "flags"))
    f32 = torch.float32
    ok, _, _, raw = local_storage_eval(ns, carry, pod)
    gpu = None if flags.dyn_gpu else (
        gpu_mask(ns, carry, pod).to(f32), gpu_share_raw(ns, carry, pod))
    return ports_mask(carry, pod).to(f32), ok.to(f32), raw, gpu


def trajectory_ms(name: str = "pai", reps: int = 20) -> dict:
    """Case `name` on the card: the trajectory kernel's launch alone
    (CUDA events, mean of `reps` launches after one warm launch), and the
    whole build_trajectory through the kernel and through the J-step loop
    (host clock, synchronised, the least of three calls after a warm one)."""
    inputs = trajectory_inputs(name, "cuda")
    ns, carry, pod = inputs["ns"], inputs["carry"], inputs["pod"]
    rows = entry_rows(inputs)

    def launch():
        traj_kernel.build(ns, carry, pod, inputs["j_steps"], *rows)

    launch()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()

    def wall_ms(plain):
        best = None
        for _ in range(4):
            # each call timed alone: the card is idle when it starts
            torch.cuda.synchronize()  # osim: lint-ok[device-sync-in-loop]
            t0 = time.perf_counter()
            trajectory(inputs, plain)
            # ... and when it ends
            torch.cuda.synchronize()  # osim: lint-ok[device-sync-in-loop]
            ms = (time.perf_counter() - t0) * 1e3
            best = ms if best is None else min(best, ms)
        return best

    n, r = carry.free.shape
    return {"case": name, "rows": n, "j_steps": inputs["j_steps"], "resources": r,
            "gpus": int(carry.gpu_free.shape[1]), "kernel_ms": start.elapsed_time(stop) / reps,
            "build_kernel_ms": wall_ms(False), "build_plain_ms": wall_ms(True)}


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
