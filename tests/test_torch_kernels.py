"""The port's per-pod step (ops/kernels.py) against the JAX package's, on the CPU.

States come from the JAX tests' own fixtures (GPU-share nodes and pods of
tests/test_gpu.py, open-local nodes and volumes of tests/test_storage.py,
and tests/test_kernels.py nodes with host ports, spread, pod (anti-)affinity,
taints and selectors), encoded once by the JAX package and handed to the
port as numpy leaves. The carry is then perturbed with seeded numpy (used
capacity, selector and anti-term counts, used GPU memory, volumes, ports),
so every dynamic filter and score sees a state the fixture alone would not
give. Every output must be bit-equal: masks, first failures, scores,
commits and the sequential oracle `schedule_batch`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.ops.encode import (
    Encoder,
    aggregate_usage,
    encode_nodes,
    encode_pods,
    initial_anti_counts,
    initial_port_counts,
    initial_selector_counts,
)
from open_simulator_tpu.ops.state import carry_from_table, node_static_from_table, pod_rows_from_batch
from open_simulator_tpu_torch import interop
from open_simulator_tpu_torch.ops import kernels as tk
from tests.test_gpu import gpu_node, gpu_pod
from tests.test_kernels import mknode, mkpod
from tests.test_storage import dev_vol, lvm_vol, storage_node, storage_pod

GIB = 1 << 30
# the JAX side runs jitted: one compile per fixture shape instead of an
# eager dispatch per op. score_gpu_share stays eager: the reference only runs
# it inside run_scores' or the grouped step's jit, and jitted on its own XLA
# rounds its min-max normalization differently (3.9e-07 where run_scores'
# jit and the eager ops give 0.0 on the coupled fixture).
J = {name: jax.jit(getattr(jk, name)) for name in (
    "run_filters", "run_scores", "commit_onehot", "gpu_allocate", "local_storage_commit",
    "ports_commit", "schedule_step", "score_least_allocated", "score_balanced",
    "score_open_local", "score_inter_pod_affinity", "score_topology_spread",
)}
J["score_gpu_share"] = jk.score_gpu_share
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _spread(key, skew, hard, app):
    return {"maxSkew": skew, "topologyKey": key,
            "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": app}}}


def _term(app, key=ZONE):
    return {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}


def _labeled(pod, app):
    pod.meta.labels["app"] = app
    return pod


def gpu_fixture():
    nodes = [gpu_node("g0", 4, 16384), gpu_node("g1", 8, 8192), gpu_node("g2", 2, 24576),
             mknode("c0", cpu="16", mem="32Gi")]
    pods = [gpu_pod("s", 4096), gpu_pod("m", 8192, count=2), gpu_pod("big", 20000),
            gpu_pod("three", 6000, count=3), mkpod("plain")]
    return nodes, pods, ()


def storage_fixture():
    nodes = [
        storage_node("s0", vgs=[("pool", 100 * GIB, 0), ("fast", 50 * GIB, 10 * GIB)],
                     devices=[("/dev/sdb", 200 * GIB, "ssd", "false"),
                              ("/dev/sdc", 100 * GIB, "hdd", "false")]),
        storage_node("s1", vgs=[("pool", 40 * GIB, 0)],
                     devices=[("/dev/sdb", 60 * GIB, "ssd", "false")]),
        storage_node("s2"),
    ]
    pods = [storage_pod("l", [lvm_vol(5 * GIB)]),
            storage_pod("lv", [lvm_vol(3 * GIB, vg="fast"), dev_vol(50 * GIB)]),
            storage_pod("d", [dev_vol(80 * GIB, "hdd"), lvm_vol(2 * GIB)]),
            mkpod("plain", cpu="100m")]
    return nodes, pods, ()


def coupled_fixture():
    nodes = [
        mknode(f"n{i}", cpu=str(4 + 4 * (i % 3)), mem="16Gi",
               labels={HOST: f"n{i}", ZONE: f"z{i % 3}", **({"rack": f"r{i % 2}"} if i < 6 else {}),
                       "tier": "gold" if i % 2 else "silver"},
               taints=[{"key": "k", "value": "v", "effect": "NoSchedule"}] if i == 4 else [])
        for i in range(8)
    ]
    port = [{"name": "c", "resources": {"requests": {"cpu": "500m"}},
             "ports": [{"containerPort": 80, "hostPort": 8080}]}]
    pods = [
        _labeled(mkpod("web", cpu="500m", topologySpreadConstraints=[
            _spread(ZONE, 1, True, "web"), _spread("rack", 2, False, "web")]), "web"),
        _labeled(mkpod("solo", cpu="250m", containers=port, affinity={"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_term("solo", HOST)]}}), "solo"),
        _labeled(mkpod("near", cpu="250m", nodeSelector={"tier": "gold"}, affinity={
            "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 30, "podAffinityTerm": _term("web")}]},
            "podAntiAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 7, "podAffinityTerm": _term("solo", HOST)}]}}), "near"),
        _labeled(mkpod("pack", cpu="1", tolerations=[{"key": "k", "operator": "Exists"}],
                       affinity={"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                           _term("pack")]}}), "pack"),
        _labeled(mkpod("hostspread", cpu="250m", topologySpreadConstraints=[
            _spread(HOST, 1, True, "web")]), "web"),
    ]
    placed = []
    for name, node in (("solo", "n1"), ("web", "n2"), ("web", "n3")):
        pod = _labeled(mkpod(f"bound-{name}", cpu="250m", affinity={"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_term("near", ZONE)]}}), name)
        pod.node_name = node
        placed.append((pod, node))
    return nodes, pods, tuple(placed)


FIXTURES = {"gpu": gpu_fixture, "storage": storage_fixture, "coupled": coupled_fixture}


def _perturb(carry_np, ns_np, seed):
    """A seeded reachable-looking state: some capacity used, counts raised,
    GPU memory, volumes and ports taken on some nodes."""
    rng = np.random.default_rng(seed)
    c = {k: v.copy() for k, v in carry_np.items()}
    valid = ns_np["valid"]
    used = np.floor(rng.random(c["free"].shape) * 0.6 * ns_np["alloc"]).astype(np.float32)
    c["free"] = np.where(valid[:, None], c["free"] - used, c["free"]).astype(np.float32)
    c["sel_counts"] += np.where(valid, rng.integers(0, 3, c["sel_counts"].shape), 0).astype(np.float32)
    c["anti_counts"] += np.where(valid, rng.integers(0, 2, c["anti_counts"].shape), 0).astype(np.float32)
    c["gpu_free"] = np.where(
        (ns_np["gpu_total"] > 0) & (rng.random(c["gpu_free"].shape) < 0.4),
        np.maximum(c["gpu_free"] - 4096 * rng.integers(1, 4, c["gpu_free"].shape), 0),
        c["gpu_free"],
    ).astype(np.float32)
    c["vg_free"] = np.where(
        rng.random(c["vg_free"].shape) < 0.5, c["vg_free"] * 0.75, c["vg_free"]
    ).astype(np.float32)
    c["dev_free"] = np.where(rng.random(c["dev_free"].shape) < 0.3, 0.0, c["dev_free"]).astype(np.float32)
    for k in ("port_any", "port_wild", "port_ipc"):
        bump = np.where(valid, rng.integers(0, 2, c[k].shape), 0).astype(np.float32)
        bump[0] = 0.0  # the pad row stays zero
        c[k] = c[k] + bump
    return c


def build(name, seed):
    """(JAX ns, carry, rows), (port ns, carry, rows), pod count."""
    nodes, pods, placed = FIXTURES[name]()
    enc = Encoder()
    enc.register_pods(pods)
    for p, _ in placed:
        enc.register_pods([p])
    table = encode_nodes(enc, nodes, existing_usage=aggregate_usage(list(placed)))
    ns = node_static_from_table(enc, table)
    carry = carry_from_table(
        table, initial_selector_counts(enc, table, list(placed)),
        port_counts=initial_port_counts(enc, table, list(placed)),
        anti_counts=initial_anti_counts(enc, table, list(placed)),
    )
    rows = pod_rows_from_batch(encode_pods(enc, pods))
    host = [{f: np.asarray(v) for f, v in t._asdict().items()} for t in (ns, carry, rows)]
    host[1] = _perturb(host[1], host[0], seed)
    jax_state = (ns, jk.Carry(**{f: jnp.asarray(v) for f, v in host[1].items()}), rows)
    return jax_state, interop.from_jax_leaves(*host, device="cpu"), len(pods)


def _eq(want, got, what):
    if isinstance(want, tuple):
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            _eq(a, b, f"{what}[{i}]")
        return
    a = np.asarray(want)
    b = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _row(rows, i, mod):
    return mod.PodRow(*(a[i] for a in rows))


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def state(request):
    return request.param, build(request.param, seed=len(request.param))


def test_run_filters(state):
    name, ((jns, jc, jrows), (tns, tc, trows), n) = state
    fo = np.ones(tk.NUM_FILTERS, bool)
    fo[[tk.F_TAINT, tk.F_SPREAD]] = False
    for i in range(n):
        jp, tp = _row(jrows, i, jk), _row(trows, i, tk)
        _eq(J["run_filters"](jns, jc, jp), tk.run_filters(tns, tc, tp), f"{name} pod {i}")
        _eq(J["run_filters"](jns, jc, jp, jnp.asarray(fo)),
            tk.run_filters(tns, tc, tp, torch.as_tensor(fo)), f"{name} pod {i} filter_on")


def test_run_filters_extra_plugin(state):
    name, ((jns, jc, jrows), (tns, tc, trows), n) = state
    want = jax.jit(lambda ns, c, p: jk.run_filters(
        ns, c, p, extra_filters=(lambda ns, c, p: c.free[:, 0] > 2000.0,)))(jns, jc, _row(jrows, 0, jk))
    got = tk.run_filters(tns, tc, _row(trows, 0, tk),
                         extra_filters=(lambda ns, c, p: c.free[:, 0] > 2000.0,))
    _eq(want, got, name)


def test_run_scores(state):
    name, ((jns, jc, jrows), (tns, tc, trows), n) = state
    jw, tw = jk.weights_array(), tk.weights_array(device="cpu")
    for i in range(n):
        jp, tp = _row(jrows, i, jk), _row(trows, i, tk)
        _eq(J["run_scores"](jns, jc, jp, jw), tk.run_scores(tns, tc, tp, tw), f"{name} pod {i}")
        for score in ("score_least_allocated", "score_balanced", "score_gpu_share",
                      "score_open_local", "score_inter_pod_affinity"):
            _eq(J[score](jns, jc, jp), getattr(tk, score)(tns, tc, tp), f"{score} {i}")
        _eq(J["score_topology_spread"](jns, jc, jp), tk.score_topology_spread(tns, tc, tp),
            f"spread {i}")
    extra = ((lambda ns, c, p: c.free[:, 1] * 0.5, 2.0),)
    want = jax.jit(lambda ns, c, p, w: jk.run_scores(ns, c, p, w, extra))(jns, jc, _row(jrows, 0, jk), jw)
    _eq(want, tk.run_scores(tns, tc, _row(trows, 0, tk), tw, extra), f"{name} extra")


def test_commits(state):
    """commit_onehot, gpu_allocate, local_storage_commit and ports_commit on
    the first valid nodes and on no node."""
    name, ((jns, jc, jrows), (tns, tc, trows), n) = state
    N = int(np.asarray(jns.valid).shape[0])
    nodes = list(np.nonzero(np.asarray(jns.valid))[0][:4]) + [-1]
    for i in range(n):
        jp, tp = _row(jrows, i, jk), _row(trows, i, tk)
        for node in nodes:
            oh = np.arange(N) == node
            j_oh, t_oh = jnp.asarray(oh), torch.as_tensor(oh)
            what = f"{name} pod {i} node {node}"
            want, got = J["commit_onehot"](jns, jc, jp, j_oh), tk.commit_onehot(tns, tc, tp, t_oh)
            _eq(tuple(want[0]), tuple(got[0]), what + " carry")
            _eq(tuple(want[1:]), tuple(got[1:]), what)
            _eq(J["gpu_allocate"](jns, jc, jp, j_oh), tk.gpu_allocate(tns, tc, tp, t_oh), what)
            _eq(J["local_storage_commit"](jns, jc, jp, j_oh),
                tk.local_storage_commit(tns, tc, tp, t_oh), what)
            _eq(J["ports_commit"](jc, jp, j_oh), tk.ports_commit(tc, tp, t_oh), what)


def test_schedule_step(state):
    name, ((jns, jc, jrows), (tns, tc, trows), n) = state
    jw, tw = jk.weights_array(), tk.weights_array(device="cpu")
    for i in range(n):
        want = J["schedule_step"](jns, jw, jc, _row(jrows, i, jk))
        got = tk.schedule_step(tns, tw, tc, _row(trows, i, tk))
        _eq(tuple(want[0]), tuple(got[0]), f"{name} pod {i} carry")
        _eq(want[1], got[1], f"{name} pod {i}")


def test_schedule_batch(state):
    """The sequential oracle over every fixture pod, three times over (the
    rows repeated), from the perturbed state."""
    name, ((jns, jc, jrows), (tns, tc, trows), n) = state
    reps = [i % n for i in range(3 * n)]
    jr = jk.PodRow(*(jnp.asarray(np.asarray(a)[reps]) for a in jrows))
    tr = tk.PodRow(*(a[reps] for a in trows))
    want = jk.schedule_batch(jns, jc, jr, jk.weights_array())
    got = tk.schedule_batch(tns, tc, tr, tk.weights_array(device="cpu"))
    _eq(tuple(want[0]), tuple(got[0]), f"{name} carry")
    _eq(tuple(want[1:]), tuple(got[1:]), name)
    assert (np.asarray(want[1]) >= 0).any()
