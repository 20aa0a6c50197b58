"""The light scan's steps of one chunk: the CUDA kernel's wrapper.

`scan_chunk` launches the hand-written kernel in csrc/light_scan.cu
(registered in ops/kernel_lib.py, which builds, loads, launches and counts
it) for a node-local group: one launch runs every step of a chunk. Its plain
version is the Python step loop of ops/fast.py:light_scan, which keeps
every case this kernel does not take (tensors on the CPU, a mesh, groups
with a spread or inter-pod affinity term); ops/fast.py chooses between the
two.

The fold's terms reach the kernel as one code per WEIGHT_ORDER position
(`pack_terms`), with the group's static score rows stacked in the order
the codes name them, so the kernel adds the terms in combine_scores'
order whatever that order is.

Thread safety as in ops/domain_pop.py: the library loads under its build
lock, the launch counts are taken under a lock, and `thread_launches()`
counts the calling thread's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import kernel_lib, scanmark
from .kernels import F_NODE_PORTS, F_RESOURCES, NUM_FILTERS, WEIGHT_ORDER

# term codes of the fold (csrc/light_scan.cu); static row k is TERM_STATIC0 + k
TERM_BALANCED, TERM_LEAST, TERM_GPU, TERM_LOCAL, TERM_ZERO, TERM_HUNDRED, TERM_STATIC0 = range(7)
N_CHANNELS = 8              # Trajectory.packed's channels (ops/fast.py:N_CH)
I32_MAX = 2**31 - 1

def pack_terms(static_scores: dict, flags) -> Tuple[Tuple[int, ...], torch.Tensor]:
    """(term code per WEIGHT_ORDER position, static rows f32[S,N]) of a
    node-local group: the terms _light_eval folds when no spread or
    inter-pod affinity term is on (inter_pod_affinity 0, topology_spread
    the constant 100; open_local 0 unless storage evolves)."""
    fixed = {
        "balanced_allocation": TERM_BALANCED,
        "least_allocated": TERM_LEAST,
        "gpu_share": TERM_GPU,
        "open_local": TERM_LOCAL if flags.dyn_storage else TERM_ZERO,
        "inter_pod_affinity": TERM_ZERO,
        "topology_spread": TERM_HUNDRED,
    }
    codes, rows = [], []
    for name in WEIGHT_ORDER:
        if name in fixed:
            codes.append(fixed[name])
        else:
            codes.append(TERM_STATIC0 + len(rows))
            rows.append(static_scores[name])
    return tuple(codes), torch.stack(rows)


def output_ranges(n: int, j: int) -> Tuple[Tuple[int, int], ...]:
    """The (lo, hi) every element of the kernel's nodes, jidx and x lies in
    at n nodes and J lanes, for scanmark.custom_outputs. A node may keep
    winning past its trajectory's last lane (the lane index clamps at
    J - 1, and that lane may stay feasible: a trajectory cut short, or the
    resources filter off), so x and jidx = x[node] are bounded only by
    x0 + steps: the int32 range here."""
    return (-1, n - 1), (0, I32_MAX), (0, I32_MAX)


def scan_chunk(ns, traj, pod, static_ok, static_scores, weights, fo, x0, steps: int,
               group_size: int, flags):
    """The first `steps` steps of a chunk of `group_size` from commit state
    x0, in one launch: (x i32[N], nodes i32[G], jidx i32[G]), the steps
    past `steps` or past the first infeasible one (-1, 0). CUDA tensors
    only; the caller takes the plain loop for anything else."""
    dev = x0.device
    packed = traj.packed
    N, J, C = packed.shape
    R = ns.alloc.shape[1]
    if C != N_CHANNELS or R < 2 or N < 1 or J < 1:
        raise ValueError(f"light_scan: packed {tuple(packed.shape)}, alloc {tuple(ns.alloc.shape)}")
    if not 0 <= steps <= group_size:
        raise ValueError(f"light_scan: {steps} steps in a chunk of {group_size}")
    codes, statics = pack_terms(static_scores, flags)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    kernel_lib.check_tensors("light_scan", dev, (
        ("packed", packed, f32, (N, J, C)), ("x0", x0, i32, (N,)),
        ("static_ok", static_ok, b, (N,)), ("valid", ns.valid, b, (N,)),
        ("statics", statics, f32, (len(statics), N)), ("alloc", ns.alloc, f32, (N, R)),
        ("req", pod.req, f32, (R,)), ("weights", weights, f32, (len(WEIGHT_ORDER),)),
        ("filter_on", fo, b, (NUM_FILTERS,)), ("has_local", pod.has_local, b, ()),
    ))
    x = torch.empty(N, dtype=i32, device=dev)
    nodes = torch.empty(group_size, dtype=i32, device=dev)
    jidx = torch.empty(group_size, dtype=i32, device=dev)
    work = torch.empty((4, N), dtype=f32, device=dev)
    feas = torch.empty(N, dtype=torch.uint8, device=dev)
    code_arr = (ctypes.c_int * len(codes))(*codes)
    kernel_lib.launch(
        "light_scan", "light_scan_launch",
        packed.data_ptr(), x0.data_ptr(), static_ok.data_ptr(), ns.valid.data_ptr(),
        statics.data_ptr(), ns.alloc.data_ptr(), pod.req.data_ptr(), weights.data_ptr(),
        fo.data_ptr(), pod.has_local.data_ptr(), x.data_ptr(), nodes.data_ptr(),
        jidx.data_ptr(), work.data_ptr(), feas.data_ptr(),
        N, J, R, steps, group_size, flags.dyn_ports, flags.dyn_storage, flags.dyn_gpu,
        F_NODE_PORTS, F_RESOURCES, code_arr,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    # what the launch wrote, for an analysis that cannot see inside it
    scanmark.custom_outputs("light_scan", [
        (t, lo, hi) for t, (lo, hi) in zip((nodes, jidx, x), output_ranges(N, J))])
    return x, nodes, jidx
