"""A group's trajectory in one launch: the CUDA kernel's wrapper.

`build` launches the hand-written kernel in csrc/trajectory.cu (registered
in ops/kernel_lib.py, which builds, loads, launches and counts it) for a
group whose host-port and open-local state cannot change: one launch
writes every lane of every node. Its plain version is the J-step Python
loop of ops/fast.py:build_trajectory, which keeps every case this kernel
does not take (tensors on the CPU, a mesh, groups with port or storage
dynamics); ops/fast.py chooses between the two.

Thread safety as in ops/light_scan.py: the library loads under its build
lock and the launch counts are taken under a lock.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import kernel_lib, scanmark
from .encode import GPU_COUNT_IDX

N_CHANNELS = 8              # Trajectory.packed's channels (ops/fast.py:N_CH)


def build(ns, carry, pod, j_steps: int, port_ok: torch.Tensor, sto_ok: torch.Tensor,
          sto_raw: torch.Tensor, gpu_rows: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """(free f32[N,J,R], gpu_free, gpu_take, packed f32[N,J,8]) of the pod's
    j_steps virtual commits on every node. `port_ok`, `sto_ok` and `sto_raw`
    are the group's entry rows f32[N]; `gpu_rows` the entry (gpu_ok,
    gpu_raw) rows f32[N] of a group whose GPU state cannot change, or None
    when it evolves: then gpu_free and gpu_take are f32[N,J,G], else None.
    CUDA tensors only; the caller takes the plain loop for anything else."""
    dev = carry.free.device
    N, R = carry.free.shape
    G = carry.gpu_free.shape[1]
    J = j_steps
    if N < 1 or J < 1 or R <= GPU_COUNT_IDX:
        raise ValueError(f"trajectory: free {tuple(carry.free.shape)}, {J} steps")
    f32, b = torch.float32, torch.bool
    free0, gpu_free0 = carry.free.contiguous(), carry.gpu_free.contiguous()
    alloc, gpu_total = ns.alloc.contiguous(), ns.gpu_total.contiguous()
    dyn_gpu = gpu_rows is None
    gpu_ok, gpu_raw = (None, None) if dyn_gpu else gpu_rows
    rows = [("port_ok", port_ok), ("sto_ok", sto_ok), ("sto_raw", sto_raw)]
    if not dyn_gpu:
        rows += [("gpu_ok", gpu_ok), ("gpu_raw", gpu_raw)]
    kernel_lib.check_tensors("trajectory", dev, [
        ("free", free0, f32, (N, R)), ("gpu_free", gpu_free0, f32, (N, G)),
        ("gpu_total", gpu_total, f32, (N, G)), ("alloc", alloc, f32, (N, R)),
        ("req", pod.req, f32, (R,)), ("gpu_mem", pod.gpu_mem, f32, ()),
        ("gpu_num", pod.gpu_num, f32, ()), ("has_req", pod.has_req, b, ()),
    ] + [(name, t, f32, (N,)) for name, t in rows])
    free = torch.empty((N, J, R), dtype=f32, device=dev)
    packed = torch.empty((N, J, N_CHANNELS), dtype=f32, device=dev)
    gpu_free = torch.empty((N, J, G), dtype=f32, device=dev) if dyn_gpu else None
    gpu_take = torch.empty((N, J, G), dtype=f32, device=dev) if dyn_gpu else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    kernel_lib.launch(
        "trajectory", "trajectory_launch",
        *(ptr(t) for t in (free0, gpu_free0, gpu_total, alloc, pod.req, pod.gpu_mem, pod.gpu_num,
                           pod.has_req, port_ok, sto_ok, sto_raw, gpu_ok, gpu_raw, free,
                           gpu_free, gpu_take, packed)),
        N, J, R, G, dyn_gpu, GPU_COUNT_IDX, torch.cuda.current_stream(dev).cuda_stream,
    )
    # what the launch wrote, for an analysis that cannot see inside it:
    # finite values (the entry rows are), the takes whole shares >= 0
    outs = [(free, -math.inf, math.inf), (packed, -math.inf, math.inf)]
    if dyn_gpu:
        outs += [(gpu_free, -math.inf, math.inf), (gpu_take, 0.0, math.inf)]
    scanmark.custom_outputs("trajectory", outs)
    return free, gpu_free, gpu_take, packed
