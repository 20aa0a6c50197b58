"""The light_scan CUDA kernel (csrc/light_scan.cu) and the rule that
engages it.

On the card (`-m cuda`): the kernel bit-equal to the plain step loop
(nodes, lanes, exit x) on the seeded node-local chunks of
`tools.scan_cases`. Here: which chunks take the kernel, the wrapper's
term codes and stacked static rows folded by NumPy in float32 exactly as
the kernel folds them against `_light_eval`'s score, and a NumPy model of
the kernel's whole chunk (min/max, fold, first-max argmax, refresh with
the lane clamp, the failure fill) against the plain loop.
"""

import ctypes
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from open_simulator_tpu_torch import bench_configs
from open_simulator_tpu_torch.ops import fast, kernel_lib, light_scan
from open_simulator_tpu_torch.ops.kernels import F_NODE_PORTS, F_RESOURCES, weights_array
from open_simulator_tpu_torch.parallel import slots as nx
from open_simulator_tpu_torch.tools import scan_cases
from open_simulator_tpu_torch.utils import platform

torch.set_num_threads(1)

F32 = np.float32
CPU_CASES = [c for c in scan_cases.CASES if c != "pai"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# -- the kernel's arithmetic in NumPy float32, in its order ------------------

def _clamp(v, lo, hi):
    """torch.clamp: NaN stays NaN."""
    return np.where(v < lo, F32(lo), np.where(v > hi, F32(hi), v)).astype(F32)


def _minmax(v, valid):
    if not valid.any():
        return F32(np.inf), F32(-np.inf)
    return F32(v[valid].min()), F32(v[valid].max())


def _normalize(v, lo, hi):
    rng = F32(hi - lo)
    den = F32(1e-9) if rng < F32(1e-9) else rng
    with np.errstate(all="ignore"):
        out = ((v - lo) * F32(100.0)) / den if rng > 0 else np.zeros_like(v)
    return _clamp(out.astype(F32), 0.0, 100.0)


def _la_ba(alloc, req, c, m):
    la_ba = []
    a0, a1 = alloc[:, 0], alloc[:, 1]
    d0, d1 = np.where(a0 < F32(1e-9), F32(1e-9), a0), np.where(a1 < F32(1e-9), F32(1e-9), a1)
    with np.errstate(all="ignore"):
        f0 = np.where(a0 > 0, (c - req[0]) / d0, F32(0)).astype(F32)
        f1 = np.where(a1 > 0, (m - req[1]) / d1, F32(0)).astype(F32)
        la_ba.append(_clamp((f0 + f1) * F32(0.5), 0.0, 1.0) * F32(100.0))
        b0 = _clamp(np.where(a0 > 0, ((a0 - c) + req[0]) / d0, F32(0)).astype(F32), 0.0, 1.0)
        b1 = _clamp(np.where(a1 > 0, ((a1 - m) + req[1]) / d1, F32(0)).astype(F32), 0.0, 1.0)
        la_ba.append((F32(1.0) - np.abs(b0 - b1)) * F32(100.0))
    return la_ba


class Model:
    """The kernel's per-node working rows and its fold, in NumPy."""

    def __init__(self, args):
        self.flags = args["flags"]
        fo = fast._filters_on(args["filter_on"], args["x0"].device).numpy()
        self.fo_res, self.fo_ports = bool(fo[F_RESOURCES]), bool(fo[F_NODE_PORTS])
        self.codes, statics = light_scan.pack_terms(args["static_scores"], self.flags)
        self.statics = statics.numpy()
        ns = args["ns"]
        self.alloc, self.req = ns.alloc.numpy(), args["pod"].req.numpy()
        self.valid, self.static_ok = ns.valid.numpy(), args["static_ok"].numpy()
        self.w = args["weights"].numpy()
        self.local_on = self.flags.dyn_storage and bool(args["pod"].has_local)

    def rows(self, cur, at=slice(None)):
        """(la, ba, feasible, GPU raw, storage raw) of the cur rows [n, 8] of
        nodes `at`."""
        la, ba = _la_ba(self.alloc[at], self.req, cur[:, fast.CH_CPU], cur[:, fast.CH_MEM])
        ok = self.static_ok[at] & self.valid[at] & ~(
            (cur[:, fast.CH_RES_FAIL] > 0.5) & self.fo_res)
        if self.flags.dyn_ports:
            ok &= (cur[:, fast.CH_PORT_OK] > 0.5) | (not self.fo_ports)
        if self.flags.dyn_storage:
            ok &= cur[:, fast.CH_STO_OK] > 0.5
        if self.flags.dyn_gpu:
            ok &= cur[:, fast.CH_GPU_OK] > 0.5
        return la, ba, ok, cur[:, fast.CH_GPU_RAW].copy(), cur[:, fast.CH_STO_RAW].copy()

    def score(self, la, ba, ok, gpu, sraw):
        """The fold at one state; `gpu` the GPU term's values."""
        local = (_normalize(sraw, *_minmax(sraw, self.valid)) if self.local_on
                 else np.zeros_like(sraw))
        total = None
        for k, code in enumerate(self.codes):
            v = {light_scan.TERM_BALANCED: ba, light_scan.TERM_LEAST: la,
                 light_scan.TERM_GPU: gpu, light_scan.TERM_LOCAL: local,
                 light_scan.TERM_ZERO: np.zeros_like(la),
                 light_scan.TERM_HUNDRED: np.full_like(la, 100.0)}.get(code)
            if v is None:
                v = self.statics[code - light_scan.TERM_STATIC0]
            term = (self.w[k] * v).astype(F32)
            total = term if total is None else (total + term).astype(F32)
        return np.where(ok, total, F32(-np.inf))


def _model_chunk(args):
    """The kernel's chunk in NumPy: (x, nodes, jidx)."""
    m = Model(args)
    packed = args["traj"].packed.numpy()
    J = packed.shape[1]
    x = args["x0"].numpy().copy()
    la, ba, ok, graw, sraw = m.rows(fast.cur_at(args["traj"], args["x0"]).numpy())
    gfix = _normalize(graw, *_minmax(graw, m.valid))
    steps = fast._active_steps(args["offset"], args["group_size"], args["valid_count"])
    nodes = np.full(args["group_size"], -1, np.int32)
    jidx = np.zeros(args["group_size"], np.int32)
    for i in range(steps):
        gpu = _normalize(graw, *_minmax(graw, m.valid)) if m.flags.dyn_gpu else gfix
        score = m.score(la, ba, ok, gpu, sraw)
        w = int(np.argmax(score))  # the first maximum, NaN first: torch.argmax's order
        if not score[w] > -np.inf:
            break
        nodes[i], jidx[i] = w, x[w]
        row = packed[w, min(max(x[w] + 1, 0), J - 1)][None]
        x[w] += 1
        r = m.rows(row, [w])
        la[w], ba[w], ok[w], graw[w], sraw[w] = (v[0] for v in r)
    return x, nodes, jidx


# -- CPU tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", CPU_CASES)
def test_packed_fold_matches_light_eval(name):
    """The term codes and the stacked static rows, folded by NumPy in the
    kernel's order, give _light_eval's score bit for bit, at the chunk's
    entry state and at its exit state."""
    args = scan_cases.build(name, "cpu")
    m = Model(args)
    fo = fast._filters_on(args["filter_on"], args["x0"].device)
    x_end = scan_cases.plain(args)[0]
    for x in (args["x0"], x_end):
        cur = fast.cur_at(args["traj"], x)
        want, _ = fast._light_eval(
            args["ns"], args["carry0"], args["pod"], args["static_ok"], args["static_scores"],
            args["na_ok"], args["weights"], fo, x, cur, args["flags"],
            fast._hoisted_values(args["ns"], args["pod"], cur, args["flags"]))
        la, ba, ok, graw, sraw = m.rows(cur.numpy())
        got = m.score(la, ba, ok, _normalize(graw, *_minmax(graw, m.valid)), sraw)
        np.testing.assert_array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("name", CPU_CASES)
def test_kernel_model_matches_plain_loop(name):
    """The kernel's chunk as a NumPy model (refresh from the clamped lane,
    the frozen GPU score of a group without GPU dynamics, the (-1, 0) fill
    after the first infeasible step) gives the plain loop's nodes, lanes
    and exit x."""
    args = scan_cases.build(name, "cpu")
    want = scan_cases.plain(args)
    got = _model_chunk(args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_cases_cover_what_the_card_test_claims():
    """Each seeded case shows the shape it is named for (on the CPU)."""
    seen = {}
    for name in CPU_CASES:
        args = scan_cases.build(name, "cpu")
        x, nodes, _ = scan_cases.plain(args)
        f = args["flags"]
        seen[name] = (f.dyn_gpu, f.dyn_storage, f.dyn_ports, nodes.numpy(), int(x.max()),
                      args["traj"].packed.shape[1], args)
    assert [seen[n][:3] for n in ("gpu", "storage", "ports", "gpu-storage-ports")] == [
        (True, False, False), (False, True, False), (False, False, True), (True, True, True)]
    assert (seen["infeasible-first"][3] == -1).all()
    mid = seen["infeasible-mid"][3]
    first = int(np.argmax(mid < 0))
    assert 0 < first < len(mid) and (mid[first:] == -1).all()
    off = seen["offset"][6]
    assert off["offset"] > 0 and int(off["x0"].sum()) == off["offset"]
    assert seen["clamp"][4] >= seen["clamp"][5]  # x runs past J - 1
    ties = seen["ties"][6]
    lane0 = ties["traj"].packed[:, 0][ties["ns"].valid]
    assert len(lane0) > 1 and bool((lane0 == lane0[0]).all())
    zero = seen["zero-static-weights"][6]["weights"]
    assert all(float(zero[fast.WEIGHT_ORDER.index(k)]) == 0.0 for k in scan_cases.STATIC_TERMS)


def _cuda_like():
    return types.SimpleNamespace(device=torch.device("cuda"))


@pytest.mark.parametrize("flag", [
    None, "any_hard_spread", "any_soft_spread", "any_req_aff", "any_pref_aff", "any_anti_sym",
])
def test_engagement_rule_reads_device_mesh_and_flags(flag, monkeypatch):
    """A chunk on a card takes the kernel unless a spread or inter-pod
    affinity flag is on or a mesh slot is running it; CPU tensors never
    do. Node-local dynamics (GPU, storage, ports) are taken."""
    local = fast.GroupFlags(True, True, True, False, False, False, False, False)
    flags = local if flag is None else local._replace(**{flag: True})
    assert fast._takes_scan_kernel(_cuda_like(), flags) is (flag is None)
    assert not fast._takes_scan_kernel(torch.zeros(3, dtype=torch.int32), flags)
    monkeypatch.setattr(nx, "current", lambda: object())
    assert not fast._takes_scan_kernel(_cuda_like(), flags)


def test_cpu_simulate_counts_no_scan_kernel():
    """A GPU-share group through schedule_batch_fast on the CPU takes the
    scan route and counts no scan_kernel launch, in PATH_COUNTS and in its
    select span's `kernel` meta."""
    from open_simulator_tpu_torch.ops import encode, state
    from open_simulator_tpu_torch.ops.kernels import weights_array
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
    with tracing.span("scan"):
        fast.schedule_batch_fast(ns, carry, batch, weights_array(device="cpu"),
                                 max_group_chunk=64, force_fast=True, device="cpu")
    delta = {k: v - before[k] for k, v in fast.PATH_COUNTS.items() if v != before[k]}
    assert delta == {"scan": 1}
    (root,) = tracing.recent_timings()
    (group,) = [c for c in root["children"] if c["name"] == "group"]
    (select,) = [c for c in group["children"] if c["name"] == "select.scan"]
    assert select["meta"] == {"dyn": ["gpu"], "kernel": 0}


@pytest.mark.parametrize("name", CPU_CASES)
def test_outputs_lie_in_the_declared_ranges(name):
    """The plain loop's nodes, lanes and exit x (the card test holds the
    kernel's bit-equal to them) lie in the ranges the wrapper declares to
    the invariant prover; `clamp` and `filters-off` run x past J."""
    args = scan_cases.build(name, "cpu")
    x, nodes, jidx = scan_cases.plain(args)
    n, j = args["traj"].packed.shape[:2]
    for t, (lo, hi) in zip((nodes, jidx, x), light_scan.output_ranges(n, j)):
        assert lo <= int(t.min()) and int(t.max()) <= hi
    if name in ("clamp", "filters-off"):
        assert int(x.max()) > j and int(jidx.max()) >= j


@pytest.mark.parametrize("name", list(bench_configs.WORKLOADS))
def test_scan_kernel_groups_constant(name, monkeypatch):
    """bench_configs.SCAN_KERNEL_GROUPS, which chip_smoke.py holds the
    card's launches to, is the number of light-scan chunks of the workload
    whose flags the engagement rule sends to the kernel on a card."""
    rule, cuda, taken = fast._takes_scan_kernel, _cuda_like(), []

    def spy(x, flags):
        taken.append(rule(cuda, flags))
        return rule(x, flags)

    monkeypatch.setattr(fast, "_takes_scan_kernel", spy)
    fast.schedule_batch_fast(*bench_configs.build_state(name, device="cpu"),
                             weights_array(device="cpu"), device="cpu")
    assert sum(taken) == bench_configs.SCAN_KERNEL_GROUPS[name]


def test_route_split_sums_the_kernel_meta():
    """route_split adds up the select.scan spans' `kernel` meta per route,
    and leaves the key out where no select carries it."""
    from open_simulator_tpu_torch.tools.route_profile import route_split

    def group(route, steps, select):
        return {"name": "group", "meta": {"route": route, "pods": steps, "steps": steps},
                "children": [select]}

    root = {"name": "schedule", "children": [
        group("scan", 10, {"name": "select.scan", "duration_s": 0.1,
                           "meta": {"dyn": ["gpu"], "kernel": 2}}),
        group("scan", 5, {"name": "select.scan", "duration_s": 0.1,
                          "meta": {"dyn": [], "kernel": 1}}),
        group("micro", 4, {"name": "select.micro", "duration_s": 0.1, "meta": {"dyn": []}}),
    ]}
    split = route_split(root)
    assert split["scan"]["kernel"] == 3 and split["scan"]["dyn"] == {"gpu": 1, "none": 1}
    assert "kernel" not in split["micro"]


def test_each_loader_builds_only_its_own_source(monkeypatch):
    """domain_pop, light_scan, trajectory and the scan chain probe each
    build only their own CUDA source when they load: a process that only
    pops never compiles the scan kernel, and the probe is no part of the
    registry that warmup builds."""
    built = []

    def fake_build(*sources):
        built.append(tuple(sources))
        return [Path(f"/nonexistent/lib{src.stem}.so") for src in sources]

    monkeypatch.setattr(platform, "build_kernels", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(
        domain_pop_launch=types.SimpleNamespace(),
        domain_pop_divide_check=types.SimpleNamespace(),
        light_scan_launch=types.SimpleNamespace(),
        trajectory_launch=types.SimpleNamespace(),
        scan_chain_probe_launch=types.SimpleNamespace()))
    monkeypatch.setattr(kernel_lib, "_libs", {})
    kernel_lib.library("domain_pop")
    kernel_lib.library("light_scan")
    kernel_lib.library("trajectory")
    scan_cases.chain_library()
    kernel_lib.library("light_scan")     # loaded once
    assert [src.name for (src,) in built] == [
        "domain_pop.cu", "light_scan.cu", "trajectory.cu", "scan_chain_probe.cu"]
    assert [src for (src,) in built[:3]] == list(kernel_lib.SOURCES)
    assert scan_cases.CHAIN_SOURCE not in kernel_lib.SOURCES
    assert "__global__ void __launch_bounds__(kThreads, 1) chain_probe_kernel" not in \
        kernel_lib.KERNELS["light_scan"].source.read_text()


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(scan_cases.CASES))
def test_kernel_matches_plain_loop_on_card(card, name):
    """The kernel and the plain step loop, bit-equal on the card: nodes,
    lanes and exit x; one launch a chunk."""
    args = scan_cases.build(name, card)
    before = kernel_lib.launches("light_scan")
    got = scan_cases.kernel(args)
    torch.cuda.synchronize()
    assert kernel_lib.launches("light_scan") == before + 1
    want = scan_cases.plain(args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and light_scan itself takes the kernel for these flags on the card
    assert fast._takes_scan_kernel(args["x0"], args["flags"])
