"""The trajectory CUDA kernel (csrc/trajectory.cu) off the card: the rule
that routes a group to it, its wrapper's refusals, its registry entry, its
counters, and a NumPy model of its per-node J-step chain, in its order and
rounding, against build_trajectory's plain loop. The kernel itself runs in
tests/test_torch_trajectory_kernel.py, on a card.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch import bench_configs
from open_simulator_tpu_torch.ops import fast, kernel_lib
from open_simulator_tpu_torch.ops import trajectory as traj_kernel
from open_simulator_tpu_torch.ops.encode import GPU_COUNT_IDX
from open_simulator_tpu_torch.ops.kernels import weights_array
from open_simulator_tpu_torch.parallel import slots as nx
from open_simulator_tpu_torch.tools import scan_cases

torch.set_num_threads(1)

F32 = np.float32
EPS = F32(1e-3)


def _cuda_like():
    return types.SimpleNamespace(device=torch.device("cuda"))


# -- the kernel's chain in NumPy float32, in its order -----------------------

def _fold(cols):
    """A left fold of f32 columns, as the kernel adds over devices."""
    total = np.zeros(cols.shape[0], F32)
    for d in range(cols.shape[1]):
        total = (total + cols[:, d]).astype(F32)
    return total


def _allocatable(gf, total):
    return _fold(((gf > EPS) & (total > 0)).astype(F32))


def _share_raw(alloc, req, ag, has_req):
    raw = None
    for k in range(alloc.shape[1]):
        a = ag if k == GPU_COUNT_IDX else alloc[:, k]
        avail = (a - req[k]).astype(F32)
        with np.errstate(all="ignore"):
            div = (req[k] / np.where(avail == 0, F32(1), avail)).astype(F32)
        share = np.where(req[k] == 0, F32(0), np.where(avail == 0, F32(1), div))
        share = np.where(avail < 0, F32(1), share).astype(F32)
        raw = share if raw is None else np.where(np.isnan(raw) | (share <= raw), raw, share)
    return (raw * F32(100)).astype(F32) if has_req else np.full_like(raw, 100.0)


def model_chain(free0, gpu_free0, total, alloc, req, mem, num, has_req, port_ok, sto_ok,
                sto_raw, gpu_rows, J):
    """(free, gpu_free, gpu_take, packed) as csrc/trajectory.cu computes
    them from its entry arrays, every node at once; `gpu_rows` (gpu_ok,
    gpu_raw) without GPU dynamics, else None (and gpu_* come back None)."""
    f, gf = free0.copy(), gpu_free0.copy()
    N, R = f.shape
    G = gf.shape[1]
    dyn = gpu_rows is None
    free = np.empty((N, J, R), F32)
    packed = np.empty((N, J, 8), F32)
    gpu_free = np.empty((N, J, G), F32) if dyn else None
    gpu_take = np.empty((N, J, G), F32) if dyn else None
    ag = _allocatable(gf, total)
    if not dyn:
        gpu_ok, gpu_raw = gpu_rows
    mem_c = F32(1e-9) if mem < F32(1e-9) else mem
    mem_eps = F32(mem - EPS)
    cols = np.arange(G)
    take = None
    for j in range(J):
        if j:
            f = (f - req).astype(F32)
            if dyn:
                gf = (gf - (take * mem).astype(F32)).astype(F32)
        free[:, j] = f
        if dyn:
            gpu_free[:, j] = gf
            ag = _allocatable(gf, total)
            elig = (total > 0) & (gf >= mem_eps)
            tight = np.where(elig, gf, np.inf).argmin(axis=1)
            with np.errstate(all="ignore"):
                caps = np.where(total > 0, np.floor(((gf + EPS).astype(F32) / mem_c).astype(F32)),
                                F32(0)).astype(F32)
            cap_sum = _fold(caps)
            run = np.zeros(N, F32)
            multi = np.empty((N, G), F32)
            for d in range(G):
                cum = (run + caps[:, d]).astype(F32)
                prefix = (cum - caps[:, d]).astype(F32)
                run = cum
                t = (num - prefix).astype(F32)
                t = np.where(t < 0, F32(0), t)
                multi[:, d] = np.where(cap_sum >= num, np.minimum(t, caps[:, d]), F32(0))
            single = ((cols[None, :] == tight[:, None]) & elig.any(axis=1)[:, None]).astype(F32)
            on = mem > 0 and num >= 1
            take = (np.where(num == 1, single, multi) if on else np.zeros((N, G))).astype(F32)
            gpu_take[:, j] = take
            ok = ((num >= 1) & (cap_sum >= num)) if mem > 0 else np.ones(N, bool)
            gpu_ok = ok.astype(F32)
            gpu_raw = _share_raw(alloc, req, ag, has_req)
        fail = (req[None, :] > (f + EPS).astype(F32)).any(axis=1)
        used = (alloc[:, GPU_COUNT_IDX] - f[:, GPU_COUNT_IDX]).astype(F32)
        fail |= req[GPU_COUNT_IDX] > ((ag - used).astype(F32) + EPS).astype(F32)
        packed[:, j] = np.stack([f[:, 0], f[:, 1], fail.astype(F32), port_ok, sto_ok, gpu_ok,
                                 sto_raw, gpu_raw], axis=1)
    return free, gpu_free, gpu_take, packed


def model_trajectory(inputs):
    """model_chain on trajectory_inputs(...) `inputs` (CPU tensors)."""
    ns, carry, pod = inputs["ns"], inputs["carry"], inputs["pod"]
    port_ok, sto_ok, sto_raw, gpu = scan_cases.entry_rows(inputs)
    return model_chain(
        carry.free.numpy(), carry.gpu_free.numpy(), ns.gpu_total.numpy(), ns.alloc.numpy(),
        pod.req.numpy(), F32(pod.gpu_mem), F32(pod.gpu_num), bool(pod.has_req),
        port_ok.numpy(), sto_ok.numpy(), sto_raw.numpy(),
        None if gpu is None else tuple(t.numpy() for t in gpu), inputs["j_steps"])


def fake_launch(name, symbol, *args):
    """kernel_lib.launch for the trajectory kernel on CPU tensors: reads the
    entry arrays behind the C function's pointer arguments, runs
    model_chain and writes its outputs where the launch would."""
    assert (name, symbol) == ("trajectory", "trajectory_launch")
    ptrs, (n, j, r, g, dyn_gpu, gci, _stream) = args[:17], args[17:]
    assert gci == GPU_COUNT_IDX

    def arr(ptr, *shape, dtype=ctypes.c_float):
        return np.ctypeslib.as_array((dtype * int(np.prod(shape))).from_address(ptr)).reshape(shape)

    (free0, gf0, total, alloc, req, mem, num, has_req, port_ok, sto_ok, sto_raw, gpu_ok,
     gpu_raw, free_out, gf_out, take_out, packed_out) = ptrs
    gpu_rows = None if dyn_gpu else (arr(gpu_ok, n), arr(gpu_raw, n))
    assert (gpu_ok is None) == bool(dyn_gpu) and (gf_out is None) != bool(dyn_gpu)
    got = model_chain(
        arr(free0, n, r).copy(), arr(gf0, n, g).copy(), arr(total, n, g), arr(alloc, n, r),
        arr(req, r), arr(mem, 1)[0], arr(num, 1)[0], bool(arr(has_req, 1, dtype=ctypes.c_uint8)[0]),
        arr(port_ok, n), arr(sto_ok, n), arr(sto_raw, n), gpu_rows, j)
    for out, ptr, shape in ((got[0], free_out, (n, j, r)), (got[1], gf_out, (n, j, g)),
                            (got[2], take_out, (n, j, g)), (got[3], packed_out, (n, j, 8))):
        if ptr is not None:
            arr(ptr, *shape)[...] = out
    kernel_lib._launches[name] += 1
    setattr(kernel_lib._local, name, kernel_lib.thread_launches(name) + 1)


@pytest.fixture
def emulated(monkeypatch):
    """The kernel route on the CPU: the routing rule says yes off a mesh,
    the wrapper's device check accepts CPU tensors, and the launch runs
    fake_launch."""
    rule = fast._takes_traj_kernel
    monkeypatch.setattr(fast, "_takes_traj_kernel", lambda free, flags: rule(
        types.SimpleNamespace(device=torch.device("cuda")), flags))

    def check_on_cpu(kernel, dev, specs):
        for name, t, dtype, shape in specs:
            assert (t.device, t.dtype, tuple(t.shape), t.is_contiguous()) == (
                dev, dtype, shape, True), (kernel, name)

    monkeypatch.setattr(kernel_lib, "check_tensors", check_on_cpu)
    monkeypatch.setattr(kernel_lib, "launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("name", scan_cases.TRAJ_CASES)
def test_kernel_model_matches_plain_loop(name):
    """The kernel's chain as a NumPy model (J rounded subtractions, the
    product-then-difference GPU commit, the first-minimum tightest fit, the
    clipped prefix fill, the whole-GPU test) gives the plain loop's free,
    gpu_free, gpu_take and packed bit for bit."""
    inputs = scan_cases.trajectory_inputs(name, "cpu")
    want = scan_cases.trajectory(inputs)[0]
    free, gpu_free, gpu_take, packed = model_trajectory(inputs)
    pairs = [(free, want.free), (packed, want.packed)]
    if inputs["flags"].dyn_gpu:
        pairs += [(gpu_free, want.gpu_free), (gpu_take, want.gpu_take)]
    for got, w in pairs:
        np.testing.assert_array_equal(got.view(np.int32), w.contiguous().numpy().view(np.int32))


@pytest.mark.parametrize("name", scan_cases.TRAJ_CASES)
def test_loop_outputs_lie_in_the_declared_ranges(name):
    """The plain loop's outputs (the card test holds the kernel's bit-equal
    to them) are finite, and the takes whole shares >= 0: the contract the
    wrapper declares to the invariant prover."""
    traj = scan_cases.trajectory(scan_cases.trajectory_inputs(name, "cpu"))[0]
    for t in (traj.free, traj.packed, traj.gpu_free, traj.gpu_take):
        assert bool(torch.isfinite(t).all())
    take = traj.gpu_take
    assert bool((take >= 0).all()) and bool((take == torch.floor(take)).all())


def test_cases_cover_what_the_card_test_claims():
    """The trajectory cases show the shapes they are named for."""
    seen = {name: scan_cases.trajectory_inputs(name, "cpu") for name in (
        "two-gpus", "gpu-oversize", "gpuless-nodes", "whole-gpus", "clamp", "pai")}
    assert float(seen["two-gpus"]["pod"].gpu_num) == 2.0
    over = seen["gpu-oversize"]
    assert float(over["pod"].gpu_mem) > float(over["ns"].gpu_total.max())
    nodes = seen["gpuless-nodes"]["ns"]
    no_gpu = (nodes.gpu_total.sum(dim=1) == 0) & nodes.valid
    assert 0 < int(no_gpu.sum()) < int(nodes.valid.sum())
    whole = seen["whole-gpus"]
    assert float(whole["pod"].req[GPU_COUNT_IDX]) == 1.0 and not whole["flags"].dyn_gpu
    assert seen["clamp"]["j_steps"] == 8
    assert seen["pai"]["flags"].dyn_gpu and seen["pai"]["carry"].free.shape[0] == 2048
    assert all(not (scan_cases.CASES[n].ports or scan_cases.CASES[n].storage)
               for n in scan_cases.TRAJ_CASES)


@pytest.mark.parametrize("flag", [None, "dyn_ports", "dyn_storage"])
@pytest.mark.parametrize("dyn_gpu", [False, True])
def test_routing_rule_reads_device_mesh_and_flags(flag, dyn_gpu, monkeypatch):
    """A group on a card takes the kernel unless its port or storage state
    evolves or a mesh slot runs it, with or without GPU dynamics (the pai
    groups' flags among them); CPU tensors never do."""
    local = fast.GroupFlags(False, False, dyn_gpu, False, False, False, False, False)
    flags = local if flag is None else local._replace(**{flag: True})
    assert fast._takes_traj_kernel(_cuda_like(), flags) is (flag is None)
    assert not fast._takes_traj_kernel(torch.zeros((3, 4)), flags)
    monkeypatch.setattr(nx, "current", lambda: object())
    assert not fast._takes_traj_kernel(_cuda_like(), flags)


def test_pai_group_flags_take_the_kernel():
    """The pai case's group (GPU share, no ports, no storage) is routed to
    the kernel on a card."""
    flags = scan_cases.trajectory_inputs("pai", "cpu")["flags"]
    assert fast._takes_traj_kernel(_cuda_like(), flags)


def test_wrapper_refuses_cpu_tensors():
    """The wrapper raises on tensors off a card, never falls back to the
    loop, and counts no launch."""
    inputs = scan_cases.trajectory_inputs("gpu", "cpu")
    before = kernel_lib.launches("trajectory")
    with pytest.raises(ValueError, match="needs CUDA"):
        traj_kernel.build(inputs["ns"], inputs["carry"], inputs["pod"], inputs["j_steps"],
                          *scan_cases.entry_rows(inputs))
    assert kernel_lib.launches("trajectory") == before


def test_registry_holds_the_kernel():
    """`trajectory` is registered with its source, which exists and is in
    SOURCES (warmup builds it), and its launch function's C parameters
    are as many as the signature the wrapper is given."""
    kernel = kernel_lib.KERNELS["trajectory"]
    assert kernel.source.is_file() and kernel.source in kernel_lib.SOURCES
    (symbol, (argtypes, _)), = kernel.symbols.items()
    decl = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*{{', kernel.source.read_text(), re.S)
    assert decl is not None
    assert len(decl.group(1).split(",")) == len(argtypes)
    assert "traj_kernel" in fast.KERNEL_COUNTS and "traj_kernel" in fast.PATH_COUNTS


def test_cpu_schedule_counts_no_traj_kernel():
    """A GPU-share group through schedule_batch_fast on the CPU builds its
    trajectory with the loop: no traj_kernel in PATH_COUNTS, and the
    trajectory span's `kernel` meta is 0."""
    from open_simulator_tpu_torch.ops import encode, state
    from open_simulator_tpu_torch.ops.tile import tile_pod_batch
    from open_simulator_tpu_torch.utils import tracing

    case = scan_cases.CASES["gpu"]
    rng = np.random.default_rng(case.seed)
    nodes = [scan_cases.Node.from_dict(scan_cases._node(i, rng, case)) for i in range(40)]
    pod = scan_cases.Pod.from_dict(scan_cases._pod(case))
    enc = encode.Encoder()
    enc.register_pods([pod])
    table = encode.encode_nodes(enc, nodes)
    ns = state.node_static_from_table(enc, table, "cpu")
    carry = state.carry_from_table(table, encode.initial_selector_counts(enc, table, []),
                                   device="cpu")
    batch = tile_pod_batch(encode.encode_pods(enc, [pod]), [100])
    before = dict(fast.PATH_COUNTS)
    tracing._history.clear()
    with tracing.span("traj"):
        fast.schedule_batch_fast(ns, carry, batch, weights_array(device="cpu"),
                                 max_group_chunk=64, force_fast=True, device="cpu")
    delta = {k: v - before[k] for k, v in fast.PATH_COUNTS.items() if v != before[k]}
    assert delta == {"scan": 1}
    (root,) = tracing.recent_timings()
    (group,) = [c for c in root["children"] if c["name"] == "group"]
    (traj,) = [c for c in group["children"] if c["name"] == "trajectory"]
    assert traj["meta"] == {"kernel": 0}


@pytest.mark.parametrize("name", list(bench_configs.WORKLOADS))
def test_traj_kernel_groups_constant(name, monkeypatch):
    """bench_configs.TRAJ_KERNEL_GROUPS, which chip_smoke.py holds the
    card's launches to, is the number of trajectories of the workload
    whose flags the routing rule sends to the kernel on a card."""
    rule, cuda, taken = fast._takes_traj_kernel, _cuda_like(), []

    def spy(free, flags):
        taken.append(rule(cuda, flags))
        return rule(free, flags)

    monkeypatch.setattr(fast, "_takes_traj_kernel", spy)
    fast.schedule_batch_fast(*bench_configs.build_state(name, device="cpu"),
                             weights_array(device="cpu"), device="cpu")
    assert sum(taken) == bench_configs.TRAJ_KERNEL_GROUPS[name]


def test_route_split_sums_the_trajectory_meta():
    """route_split adds up the trajectory spans' `kernel` meta per route
    as `traj_kernel`, and leaves the key out where no trajectory carries
    it (the grouped route builds none)."""
    from open_simulator_tpu_torch.tools.route_profile import route_split

    def group(route, steps, *children):
        return {"name": "group", "meta": {"route": route, "pods": steps, "steps": steps},
                "children": list(children)}

    def traj(kernel):
        return {"name": "trajectory", "duration_s": 0.01, "meta": {"kernel": kernel}}

    root = {"name": "schedule", "children": [
        group("scan", 10, traj(1), {"name": "select.scan", "duration_s": 0.1,
                                    "meta": {"dyn": ["gpu"], "kernel": 1}}),
        group("scan", 5, traj(1), {"name": "select.scan", "duration_s": 0.1,
                                   "meta": {"dyn": [], "kernel": 1}}),
        group("sort", 4, traj(0), {"name": "select.sort", "duration_s": 0.1}),
        group("grouped", 3, {"name": "select.grouped", "duration_s": 0.1}),
    ]}
    split = route_split(root)
    assert split["scan"]["traj_kernel"] == 2 and split["sort"]["traj_kernel"] == 0
    assert "traj_kernel" not in split["grouped"]


@pytest.mark.parametrize("name", scan_cases.TRAJ_CASES)
def test_emulated_route_matches_plain_loop(name, emulated):
    """build_trajectory down the kernel route, the launch emulated by the
    model through the C function's arguments: one launch, and every output
    bit-equal to the J-step loop's (the wrapper's argument order, output
    shapes and the Trajectory it assembles)."""
    inputs = scan_cases.trajectory_inputs(name, "cpu")
    before = kernel_lib.launches("trajectory")
    got = scan_cases.trajectory(inputs)
    assert kernel_lib.launches("trajectory") == before + 1
    want = scan_cases.trajectory(inputs, plain=True)
    assert kernel_lib.launches("trajectory") == before + 1
    assert scan_cases.same_trajectory(got, want) == []
    if not inputs["flags"].dyn_gpu:
        # state the group cannot change stays a broadcast view
        assert got[0].gpu_free.stride()[1] == 0 and got[0].gpu_take.stride()[1] == 0


@pytest.mark.parametrize("name", ["spread_affinity", "gpushare"])
def test_emulated_route_schedules_like_the_loop(name, emulated):
    """schedule_batch_fast with every eligible trajectory down the emulated
    kernel route gives the loop's placements, reasons, takes and exit
    carry bit for bit, and counts one traj_kernel a group."""
    ns, carry, batch = bench_configs.build_state(name, device="cpu")
    w = weights_array(device="cpu")
    before = fast.PATH_COUNTS["traj_kernel"]
    got = fast.schedule_batch_fast(ns, carry, batch, w, device="cpu")
    assert fast.PATH_COUNTS["traj_kernel"] - before == bench_configs.TRAJ_KERNEL_GROUPS[name]
    with scan_cases.loop_route():
        want = fast.schedule_batch_fast(ns, carry, batch, w, device="cpu")
    for g, wt in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        g, wt = torch.as_tensor(g), torch.as_tensor(wt)
        assert torch.equal(scan_cases._bits(g), scan_cases._bits(wt))


def test_emulated_route_proves_clean(emulated):
    """The invariant prover over the registry with the trajectory down the
    kernel route (its outputs known only by the wrapper's declared ranges)
    finds nothing, as with the loop."""
    from open_simulator_tpu_torch.analysis import invariants as inv

    before = kernel_lib.launches("trajectory")
    audit = inv.run_invariants("cpu")
    assert kernel_lib.launches("trajectory") > before
    assert audit.ok, audit.render_text()
