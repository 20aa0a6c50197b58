"""The port's resident cluster state (engine/resident.py, ops/delta.py, the
simulator's `resident=` path) against the JAX package, on the CPU.
Tolerance: exact.

The load-bearing property is byte identity: after every sync, the resident
planes, host mirror AND device copies, equal a fresh `encode_nodes` of the
same (nodes, bound pods) through the same encoder at the resident bucket
shapes. The seeded sequences drive 240 delta syncs through every mutation
class (bind/unbind, relabel, cordon, node add/remove, no-op) and check that
identity after each step, and that the port's `digest_table` equals the JAX
resident's fed the same sequence. Injected torn deltas and digest
mismatches become journaled repairs with exact counts; structural changes
are fallbacks, not repairs; epochs never collide. `simulate(resident=)`
equals the JAX `simulate()` on result digest, routes and final carry.

The cases of tests/test_resident.py that need no admission queue or server
keep their names here; the four fence/server cases are in
tests/test_torch_server.py.
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import resident as jres
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.ops import delta as jdelta
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.core.objects import Node, Pod
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import resident as resident_mod
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.engine.resident import ResidentCluster
from open_simulator_tpu_torch.engine.simulator import (
    AppResource,
    ClusterResource,
    Simulator,
    simulate,
)
from open_simulator_tpu_torch.ops import delta as delta_ops
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops.encode import NodeTable, encode_nodes
from open_simulator_tpu_torch.resilience import faults
from open_simulator_tpu_torch.utils import metrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention


# ---------------------------------------------------------------------------
# fixtures / helpers (dicts, so both packages build the same objects)
# ---------------------------------------------------------------------------


def node_dict(name, cpu="8", mem="16Gi", labels=None, unschedulable=False):
    return {
        "metadata": {"name": name, "labels": dict(labels or {})},
        "spec": {"unschedulable": unschedulable},
        "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}},
    }


def pod_dict(name, node, cpu="1", mem="1Gi"):
    return {
        "metadata": {"name": name, "namespace": "rt"},
        "spec": {
            "nodeName": node,
            "containers": [{"name": "c", "image": "img",
                            "resources": {"requests": {"cpu": cpu, "memory": mem}}}],
        },
    }


def mknode(name, **kw):
    return Node.from_dict(node_dict(name, **kw))


def mkpod(name, node, cpu="1", mem="1Gi"):
    return Pod.from_dict(pod_dict(name, node, cpu, mem))


def new_resident(tmp_path, sub="r"):
    return ResidentCluster(journal_dir=str(tmp_path / sub), device="cpu")


def assert_byte_identical(res: ResidentCluster):
    """Resident planes == a fresh encode of the adopted (nodes, bound)
    through the SAME encoder at resident shapes, as raw bytes."""
    fresh = encode_nodes(
        res.enc, res._nodes, existing_usage=res._usage, existing_gpu=res._gpu_usage,
        n_pad=res._host.n, min_axes=res._axes,
    )
    for f in dataclasses.fields(NodeTable):
        if f.name == "names":
            continue
        a, b = getattr(res._host, f.name), getattr(fresh, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        assert a.tobytes() == b.tobytes(), f"host plane {f.name} diverged"
    assert res._host.names == fresh.names
    for name in resident_mod.DEVICE_PLANES:
        dv = res._dev[name].cpu().numpy()
        assert dv.tobytes() == getattr(fresh, name).tobytes(), (
            f"device plane {name} diverged from fresh encode")


def repair_count(reason: str) -> float:
    return metrics.RESIDENT_DRIFT_REPAIRS.value(reason=reason)


def plan(op: str, kind: str, times: int = 1) -> faults.FaultPlan:
    return faults.FaultPlan.from_dict(
        {"rules": [{"target": "resident", "op": op, "kind": kind, "times": times}]})


# ---------------------------------------------------------------------------
# delta kernels (ops/delta.py)
# ---------------------------------------------------------------------------


def test_digest_fold_host_matches_device_bit_patterns():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((13, 7)).astype(np.float32)
    f[0, 0] = np.nan
    f[1, 1] = -0.0
    f[2, 2] = np.inf
    f[3, 3] = -np.inf
    i = rng.integers(-5, 5, (9, 4)).astype(np.int32)
    b = rng.random((17,)) < 0.5
    for x in (f, i, b):
        got = int(delta_ops.digest_fold(torch.from_numpy(x)).item())
        assert got == delta_ops.digest_fold_host(x) == jdelta.digest_fold_host(x)


def test_digest_distinguishes_permutation_and_zero_fill():
    a = np.arange(8, dtype=np.float32)
    assert delta_ops.digest_fold_host(a) != delta_ops.digest_fold_host(a[::-1].copy())
    assert delta_ops.digest_fold_host(a) != delta_ops.digest_fold_host(np.zeros_like(a))


def test_apply_rows_drops_pad_slots():
    arr = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = delta_ops.pad_indices([1], 4)
    assert idx.shape[0] == 8 and set(idx[1:]) == {4}
    np.testing.assert_array_equal(idx, jdelta.pad_indices([1], 4))
    rows = np.zeros((8, 3), np.float32)
    rows[0] = 99.0
    out = delta_ops.apply_rows(arr, idx, rows).numpy()
    assert (out[1] == 99.0).all()
    # rows 0/2/3 untouched: a clamped pad slot would have smashed row 3
    assert out[0].tolist() == [0, 1, 2] and out[3].tolist() == [9, 10, 11]
    flags = delta_ops.apply_flags(torch.zeros(4, dtype=torch.bool),
                                  delta_ops.pad_indices([3, 0], 4), np.array([True] * 8))
    assert flags.tolist() == [True, False, False, True]


# ---------------------------------------------------------------------------
# seeded delta sequences: byte identity after every step, equal to JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_random_delta_sequences_byte_identical(seed, tmp_path):
    """12 seeds x 20 steps = 240 delta syncs, byte-compared against a fresh
    encode after every one, and digest_table equal to the JAX resident's
    after the same sync. Epochs are monotonic and move only when state
    moved; the whole walk is deltas or structural re-encodes, never a
    drift repair."""
    rng = np.random.default_rng(seed)
    nodes = [node_dict(f"n{seed}-{i}", labels={"zone": f"az-{i % 3}"}) for i in range(8)]
    pods = []
    serial = 0
    res = new_resident(tmp_path)
    jr = jres.ResidentCluster(journal_dir=str(tmp_path / "jax"))

    def sync():
        tn, tp = [Node.from_dict(d) for d in nodes], [Pod.from_dict(p) for p in pods]
        epoch = res.sync(tn, tp)
        jr.sync([jobj.Node.from_dict(d) for d in nodes], [jobj.Pod.from_dict(p) for p in pods])
        assert resident_mod.digest_table(res._host, res._dev) == \
            jres.digest_table(jr._host, jr._dev)
        assert res.covers_reason([Node.from_dict(d) for d in nodes],
                                 [(p, p.node_name) for p in tp]) is None
        return epoch

    sync()
    assert_byte_identical(res)
    repairs_before = res.repairs
    last_epoch = res.epoch
    for step in range(20):
        action = rng.choice(
            ["bind", "unbind", "relabel", "cordon", "add_node", "remove_node", "noop"],
            p=[0.35, 0.15, 0.15, 0.1, 0.1, 0.05, 0.1],
        )
        if action == "bind":
            serial += 1
            target = nodes[rng.integers(len(nodes))]["metadata"]["name"]
            pods.append(pod_dict(f"p{seed}-{serial}", target, cpu=str(1 + int(rng.integers(3)))))
        elif action == "unbind" and pods:
            pods.pop(int(rng.integers(len(pods))))
        elif action == "relabel":
            i = int(rng.integers(len(nodes)))
            d = dict(nodes[i])
            d["metadata"] = dict(d["metadata"], labels={**d["metadata"]["labels"],
                                                       "step": f"s{step}"})
            nodes[i] = d
        elif action == "cordon":
            i = int(rng.integers(len(nodes)))
            d = dict(nodes[i])
            d["spec"] = {"unschedulable": not d["spec"].get("unschedulable", False)}
            nodes[i] = d
        elif action == "add_node":
            serial += 1
            nodes.append(node_dict(f"n{seed}-new{serial}"))
        elif action == "remove_node" and len(nodes) > 2:
            gone = nodes.pop(int(rng.integers(len(nodes))))["metadata"]["name"]
            pods = [p for p in pods if p["spec"]["nodeName"] != gone]
        epoch = sync()
        assert epoch >= last_epoch
        last_epoch = epoch
        assert_byte_identical(res)
    assert res.repairs == repairs_before
    assert res.verify_now() is True


def test_noop_sync_holds_epoch_and_mutation_bumps_it(tmp_path):
    nodes = [mknode("a"), mknode("b")]
    res = new_resident(tmp_path)
    e1 = res.sync(nodes, [])
    assert e1 == res.sync(nodes, [])
    e2 = res.sync(nodes, [mkpod("p1", "a")])
    assert e2 > e1
    assert_byte_identical(res)


# ---------------------------------------------------------------------------
# chaos: every injected fault becomes a journaled repair, with exact counts
# ---------------------------------------------------------------------------


def test_torn_delta_repairs_and_journals(tmp_path):
    nodes = [mknode("a"), mknode("b")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    before = repair_count("torn_delta")
    with faults.injected(plan("apply", "torn_delta")):
        res.sync(nodes, [mkpod("p1", "a")])
    assert res.repairs == 1
    assert repair_count("torn_delta") == before + 1
    assert_byte_identical(res)
    events = res._journal.events("resident_repair")
    assert len(events) == 1
    assert events[0]["reason"] == "torn_delta"
    assert events[0]["epoch"] == res.epoch
    res.sync(nodes, [mkpod("p1", "a"), mkpod("p2", "b")])
    assert_byte_identical(res)


def test_digest_mismatch_detected_and_repaired(tmp_path):
    nodes = [mknode("a"), mknode("b"), mknode("c")]
    res = new_resident(tmp_path)
    res.sync(nodes, [mkpod("p1", "a")])
    before = repair_count("digest_mismatch")
    mismatches = metrics.RESIDENT_VERIFICATIONS.value(outcome="mismatch")
    with faults.injected(plan("verify", "digest_mismatch")):
        assert res.verify_now() is False
    assert res.repairs == 1
    assert repair_count("digest_mismatch") == before + 1
    assert metrics.RESIDENT_VERIFICATIONS.value(outcome="mismatch") == mismatches + 1
    assert res._journal.has("resident_repair")
    assert_byte_identical(res)
    assert res.verify_now() is True


def test_periodic_verify_fires_on_cadence(tmp_path, monkeypatch):
    monkeypatch.setenv("OSIM_RESIDENT_VERIFY_EVERY", "2")
    nodes = [mknode("a"), mknode("b")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    ok_before = metrics.RESIDENT_VERIFICATIONS.value(outcome="ok")
    res.sync(nodes, [mkpod("p1", "a")])
    res.sync(nodes, [mkpod("p1", "a"), mkpod("p2", "b")])
    assert metrics.RESIDENT_VERIFICATIONS.value(outcome="ok") == ok_before + 1


def test_delta_budget_exhaustion_repairs(tmp_path, monkeypatch):
    monkeypatch.setenv("OSIM_RESIDENT_DELTA_BUDGET", "2")
    nodes = [mknode("a"), mknode("b")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    before = repair_count("delta_budget")
    res.sync(nodes, [mkpod("p1", "a")])
    assert repair_count("delta_budget") == before
    res.sync(nodes, [mkpod("p1", "a"), mkpod("p2", "b")])
    assert repair_count("delta_budget") == before + 1
    assert res.repairs == 1
    assert_byte_identical(res)
    res.sync(nodes, [mkpod("p2", "b")])
    assert repair_count("delta_budget") == before + 1


def test_mid_run_disable_is_a_counted_repair(tmp_path, monkeypatch):
    nodes = [mknode("a"), mknode("b")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    assert res.covers_reason(nodes, []) is None
    before = repair_count("disabled")
    monkeypatch.setenv("OSIM_RESIDENT", "0")
    res.sync(nodes, [mkpod("p1", "a")])
    assert repair_count("disabled") == before + 1
    assert res.covers_reason(nodes, [(mkpod("p1", "a"), "a")]) == "disabled"
    monkeypatch.setenv("OSIM_RESIDENT", "1")
    res.sync(nodes, [mkpod("p1", "a")])
    assert repair_count("disabled") == before + 1
    assert res.covers_reason(nodes, [(mkpod("p1", "a"), "a")]) is None
    assert_byte_identical(res)


def test_structural_changes_are_fallbacks_not_repairs(tmp_path):
    nodes = [mknode("a"), mknode("b"), mknode("c")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    removed_before = metrics.RESIDENT_FALLBACKS.value(reason="node_removed")
    res.sync(nodes[:2], [])
    assert metrics.RESIDENT_FALLBACKS.value(reason="node_removed") == removed_before + 1
    assert res.repairs == 0
    assert_byte_identical(res)
    order_before = metrics.RESIDENT_FALLBACKS.value(reason="node_order")
    res.sync([nodes[1], nodes[0]], [])
    assert metrics.RESIDENT_FALLBACKS.value(reason="node_order") == order_before + 1
    assert_byte_identical(res)


def test_epochs_never_collide_across_instances(tmp_path):
    r1 = new_resident(tmp_path, "a")
    r1.sync([mknode("a")], [])
    r2 = new_resident(tmp_path, "b")
    r2.sync([mknode("a")], [])
    assert r2.epoch > r1.epoch


def test_fence_epoch_and_stale_generation(tmp_path):
    """fence_epoch is the live epoch; the stale_generation chaos kind
    returns the sentinel -1 that no live epoch matches."""
    res = new_resident(tmp_path)
    res.sync([mknode("a")], [])
    assert res.fence_epoch() == res.epoch > 0
    with faults.injected(plan("fence", "stale_generation")):
        assert res.fence_epoch() == -1
    assert res.fence_epoch() == res.epoch


def test_table_view_loan_survives_next_sync(tmp_path):
    """A view handed out keeps its planes when the next sync scatters: the
    sync writes into copies while the loan is live, in place otherwise."""
    nodes = [mknode("a"), mknode("b")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    view = res.table_view()
    free0 = view.free.clone()
    loaned_ptr = res._dev["free"].data_ptr()
    res.sync(nodes, [mkpod("p1", "a")])
    assert torch.equal(view.free, free0)
    assert res._dev["free"].data_ptr() != loaned_ptr
    ptr = res._dev["free"].data_ptr()
    res.sync(nodes, [mkpod("p1", "a"), mkpod("p2", "b")])
    assert res._dev["free"].data_ptr() == ptr  # no loan: written in place
    assert_byte_identical(res)


# ---------------------------------------------------------------------------
# simulator equivalence against the JAX package
# ---------------------------------------------------------------------------


def _deployment(name, replicas, cpu="1", spread=False):
    spec = {"containers": [{"name": "c", "image": "img",
                            "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}]}
    if spread:
        spec["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "zone", "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchLabels": {"app": name}}}]
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "rt"},
            "spec": {"replicas": replicas, "template": {
                "metadata": {"labels": {"app": name}}, "spec": spec}}}


def _placement_nodes(result):
    return sorted(st.node.name for st in result.node_status for _ in st.pods)


def _run(pkg, nodes, pods, apps, resident=None):
    """(result, final carry leaves, route counts) of one simulate()."""
    wl, sim, fast = (jwl, jsim, jfast) if pkg == "jax" else (twl, tsim, tfast)
    wl.reset_name_rng()
    cluster = sim.ClusterResource(nodes=list(nodes), pods=list(pods))
    counts0 = dict(fast.PATH_COUNTS)
    kw = {"device": "cpu", "resident": resident} if pkg == "torch" else {}
    s = sim.Simulator(cluster, **kw)
    result = s.run([sim.AppResource(name=n, objects=o) for n, o in apps])
    routes = {k: v - counts0.get(k, 0) for k, v in fast.PATH_COUNTS.items()
              if k in jfast.PATH_COUNTS and v - counts0.get(k, 0)}
    return result, {f: np.asarray(getattr(s._carry, f)) for f in s._carry._fields}, routes


def _assert_same(want, got):
    (jres_, jcarry, jroutes), (tres_, tcarry, troutes) = want, got
    assert sc.result_digest(tres_) == sc.result_digest(jres_)
    assert troutes == jroutes
    for f, a in jcarry.items():
        assert a.dtype == tcarry[f].dtype and a.shape == tcarry[f].shape, f
        np.testing.assert_array_equal(a, tcarry[f], err_msg=f)


def test_simulate_with_resident_matches_plain(tmp_path):
    nodes = [node_dict(f"s{i}", labels={"zone": f"az-{i % 2}"}) for i in range(6)]
    pods = [pod_dict("pre1", "s0"), pod_dict("pre2", "s1", cpu="2")]
    apps = [("a", [_deployment("d", 5, spread=True)])]
    tnodes = [Node.from_dict(d) for d in nodes]
    tpods = [Pod.from_dict(p) for p in pods]
    res = new_resident(tmp_path)
    res.sync(tnodes, tpods)

    not_covering = metrics.RESIDENT_FALLBACKS.value(reason="not_covering")
    growth = metrics.RESIDENT_FALLBACKS.value(reason="shape_growth")
    jnodes = [jobj.Node.from_dict(d) for d in nodes]
    want = _run("jax", jnodes, [jobj.Pod.from_dict(p) for p in pods], apps)
    plain = _run("torch", tnodes, tpods, apps)
    fast = _run("torch", tnodes, tpods, apps, resident=res)
    _assert_same(want, plain)
    _assert_same(want, fast)
    # the resident path served: the spread's topology key grew the encoder's
    # axis once (a structural re-encode that stays resident), nothing missed
    assert metrics.RESIDENT_FALLBACKS.value(reason="not_covering") == not_covering
    assert metrics.RESIDENT_FALLBACKS.value(reason="shape_growth") == growth + 1
    assert_byte_identical(res)
    fallbacks_before = metrics.RESIDENT_FALLBACKS.snapshot()
    # and after a delta: bind one more pod, both paths agree with JAX again
    pods.append(pod_dict("pre3", "s2"))
    tpods = [Pod.from_dict(p) for p in pods]
    res.sync(tnodes, tpods)
    want = _run("jax", jnodes, [jobj.Pod.from_dict(p) for p in pods], apps)
    _assert_same(want, _run("torch", tnodes, tpods, apps, resident=res))
    assert metrics.RESIDENT_FALLBACKS.snapshot() == fallbacks_before
    assert_byte_identical(res)


def test_simulate_falls_back_when_not_covering(tmp_path):
    nodes = [mknode("f0"), mknode("f1")]
    res = new_resident(tmp_path)
    res.sync(nodes, [])
    before = metrics.RESIDENT_FALLBACKS.value(reason="not_covering")
    other = ClusterResource(nodes=[mknode("f0"), mknode("other")], pods=[])
    twl.reset_name_rng()
    out = simulate(other, [AppResource(name="a", objects=[_deployment("d", 1)])],
                   resident=res, device="cpu")
    assert metrics.RESIDENT_FALLBACKS.value(reason="not_covering") == before + 1
    assert len(_placement_nodes(out)) == 1


def test_resident_is_gated_and_device_checked(tmp_path):
    """Under n_pad the resident is not used (the encoding differs); a
    resident on another device than the simulation is refused."""
    res = new_resident(tmp_path)
    res.sync([mknode("g0")], [])
    sim = Simulator(ClusterResource(nodes=[mknode("g0")]), n_pad=64, resident=res, device="cpu")
    assert sim._resident is None
    res.device = torch.device("meta")
    with pytest.raises(ValueError, match="resident state lives on meta"):
        Simulator(ClusterResource(nodes=[mknode("g0")]), resident=res, device="cpu")


def test_plan_rounds_small_match_jax(tmp_path):
    """sim_configs.resident_rounds at 2,000 nodes, 8 rounds of 16 changes
    with a torn delta and a digest mismatch injected into the port's run:
    both are repaired and counted, every round's digest_table equals the
    JAX resident's fed the faultless sequence, and simulate(resident=) of
    plan_spec's apps then equals the JAX simulate()."""
    nodes, apps = sc.plan_spec(2000, 200)
    res = new_resident(tmp_path)
    jr = jres.ResidentCluster(journal_dir=str(tmp_path / "jax"))
    walk = sc.ResidentWalk(Node, Pod, nodes)
    jwalk = sc.ResidentWalk(jobj.Node, jobj.Pod, nodes)
    res.sync(walk.nodes, [])
    jr.sync(jwalk.nodes, [])
    torn0, mism0 = repair_count("torn_delta"), repair_count("digest_mismatch")
    for r, (changed, pods) in enumerate(sc.resident_rounds(nodes, 8, 16)):
        tn, tp = walk.apply(changed, pods)
        jn, jp = jwalk.apply(changed, pods)
        with faults.injected(plan("apply", "torn_delta") if r == 3 else
                             faults.FaultPlan(rules=[])):
            res.sync(tn, tp)
        jr.sync(jn, jp)
        if r == 5:
            with faults.injected(plan("verify", "digest_mismatch")):
                assert res.verify_now() is False
        assert resident_mod.digest_table(res._host, res._dev) == \
            jres.digest_table(jr._host, jr._dev)
    assert (repair_count("torn_delta") - torn0, repair_count("digest_mismatch") - mism0) == (1, 1)
    assert res.repairs == 2 and res.verify_now() is True
    assert_byte_identical(res)
    want = _run("jax", jn, jp, apps)
    got = _run("torch", tn, tp, apps, resident=res)
    _assert_same(want, got)
    assert got[2].get("domain") == 1


@pytest.mark.slow
def test_plan_rounds_match_jax():
    """sim_configs.RESIDENT_DIGEST and RESIDENT_SIM_DIGEST recomputed with
    the JAX package at full size: plan_spec()'s 10,000 nodes through
    RESIDENT_ROUNDS rounds of RESIDENT_CHANGES changes, and simulate() of
    its 100,000 pods on the cluster after them."""
    nodes, apps = sc.plan_spec()
    jr = jres.ResidentCluster(journal_dir=tempfile.mkdtemp())
    walk = sc.ResidentWalk(jobj.Node, jobj.Pod, nodes)
    jr.sync(walk.nodes, [])
    for changed, pods in sc.resident_rounds(nodes):
        n, p = walk.apply(changed, pods)
        jr.sync(n, p)
    assert jr.verify_now() is True
    assert jres.digest_table(jr._host, jr._dev) == sc.RESIDENT_DIGEST
    jwl.reset_name_rng()
    result = jsim.simulate(jsim.ClusterResource(nodes=n, pods=p),
                           [jsim.AppResource(name=a, objects=o) for a, o in apps])
    assert sc.result_digest(result) == sc.RESIDENT_SIM_DIGEST


def test_scenario_session_with_resident(tmp_path):
    """A ScenarioSession over a covering resident (it took the resident's
    refusal's place in tests/test_torch_simulator.py): each lane equals the
    JAX simulate_batch lane, and no fallback is counted."""
    nodes = [node_dict(f"q{i}", labels={"zone": f"az-{i % 2}"}) for i in range(6)]
    pods = [pod_dict("pre1", "q0")]
    apps = [("a", [_deployment("d", 7)])]
    tnodes, tpods = [Node.from_dict(d) for d in nodes], [Pod.from_dict(p) for p in pods]
    res = new_resident(tmp_path)
    res.sync(tnodes, tpods)
    not_covering = metrics.RESIDENT_FALLBACKS.value(reason="not_covering")
    scenarios = [tsim.Scenario(name="all"), tsim.Scenario(name="four", node_count=4)]
    twl.reset_name_rng()
    session = tsim.ScenarioSession(ClusterResource(nodes=tnodes, pods=tpods),
                                   [AppResource(name=n, objects=o) for n, o in apps],
                                   resident=res, device="cpu")
    got = [session.run(scenarios), session.run(scenarios)]
    jwl.reset_name_rng()
    want = jsim.simulate_batch(
        jsim.ClusterResource(nodes=[jobj.Node.from_dict(d) for d in nodes],
                             pods=[jobj.Pod.from_dict(p) for p in pods]),
        [jsim.AppResource(name=n, objects=o) for n, o in apps],
        [jsim.Scenario(name="all"), jsim.Scenario(name="four", node_count=4)])
    for lanes in got:
        assert [sc.result_digest(r) for r in lanes] == [sc.result_digest(r) for r in want]
    assert metrics.RESIDENT_FALLBACKS.value(reason="not_covering") == not_covering
    assert session.sim._resident is res
