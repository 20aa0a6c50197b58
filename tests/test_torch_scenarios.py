"""The port's scenario axis against the JAX package, on the CPU. Tolerance:
exact.

  - ops/state.py: `stack_carry` (a fresh dense copy per lane: a write to
    one lane leaves the others and the source untouched) and
    `align_carry_scenarios` when the encoder grows;
  - ops/fast.py: `schedule_scenarios` on node-count lanes, node-valid lanes
    and per-lane weights (every output and the stacked carry), the chunked
    scan (OSIM_COMMIT_CHUNK=7) equal to the single scan, and
    `scenario_carry_digest` equal to its host twin and to the JAX digest;
  - engine/simulator.py: the cases of tests/test_batch_engine.py, each lane
    of `simulate_batch` equal to the JAX lane and to the port's serial
    `simulate()` of its scenario, also with the lanes split over a 4-slot
    CPU mesh, and `ScenarioSession` pack-of-1 calls equal to a cold
    `simulate()`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.ops import encode as jenc
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.ops import state as jstate
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.ops import encode as tenc
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops import kernels as tk
from open_simulator_tpu_torch.ops import state as tstate
from tests.test_torch_kernels import FIXTURES, _eq, build, coupled_fixture

torch.set_num_threads(1)  # tiny tensors: threads only add contention

S = 8


def _to_port(cls, tup):
    return cls(**{f: torch.from_numpy(np.array(getattr(tup, f))) for f in cls._fields})


def test_stack_carry_matches_jax_and_is_independent():
    (jns, jc, _), (tns, tc, _), _ = build("coupled", seed=1)
    want = jstate.stack_carry(jc, 3)
    got = tstate.stack_carry(tc, 3)
    _eq(tuple(want), tuple(got), "stacked carry")
    before = {f: getattr(tc, f).clone() for f in tk.Carry._fields}
    for f in tk.Carry._fields:
        leaf = getattr(got, f)
        assert leaf.is_contiguous() and 0 not in leaf.stride()
        leaf[1].add_(1.0)
        assert torch.equal(leaf[0], before[f]), f
        assert torch.equal(leaf[2], before[f]), f
        assert torch.equal(getattr(tc, f), before[f]), f


def test_align_carry_scenarios_when_the_encoder_grows():
    """A later batch registers new selectors, host ports and anti terms:
    both packages grow the stacked rows in lockstep and refresh
    NodeStatic.anti_topo."""
    nodes, pods, _ = coupled_fixture()  # read through duck typing by both encoders
    states = {}
    for name, enc_mod, st in (("jax", jenc, jstate), ("torch", tenc, tstate)):
        enc = enc_mod.Encoder()
        enc.register_pods(pods[:1])
        table = enc_mod.encode_nodes(enc, nodes)
        kw = {} if name == "jax" else {"device": "cpu"}
        ns = st.node_static_from_table(enc, table, **kw)
        carry = st.carry_from_table(table, enc_mod.initial_selector_counts(enc, table, []), **kw)
        enc.register_pods(pods[1:])
        states[name] = st.align_carry_scenarios(st.stack_carry(carry, 3), enc, ns)
    jc, jns = states["jax"]
    tc, tns = states["torch"]
    _eq(tuple(jc), tuple(tc), "grown carry")
    _eq(jns.anti_topo, tns.anti_topo, "anti_topo")
    assert tc.sel_counts.shape[1] > 1 and tc.anti_counts.shape[1] >= 1


def _lanes(valid, seed):
    """Lane 0 the real cluster, lanes 1-2 node-count prefixes, lanes 3-5
    seeded node-valid masks, lanes 6-7 copies of lane 0; weights differ."""
    rng = np.random.default_rng(seed)
    n_real = int(valid.sum())
    v = np.stack([valid.copy() for _ in range(S)])
    for lane, k in ((1, max(1, n_real // 2)), (2, n_real - 1)):
        v[lane, k:] = False
    for lane in (3, 4, 5):
        v[lane] &= rng.random(valid.shape[0]) < 0.7
    w = np.stack([np.asarray(jk.weights_array())] * S)
    w[3] = np.asarray(jk.weights_array({"least_allocated": 100.0}))
    w[4] = np.asarray(jk.weights_array({"node_affinity": 1.0}))
    w[5] *= 3.0
    return v, w.astype(np.float32)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_schedule_scenarios_matches_jax(name):
    (jns, jc, jrows), (tns, tc, trows), n = build(name, seed=5)
    v, w = _lanes(np.asarray(jns.valid), seed=len(name))
    reps = [i % n for i in range(3 * n)]
    jr = jk.PodRow(*(jnp.asarray(np.asarray(a)[reps]) for a in jrows))
    tr = tk.PodRow(*(a[reps] for a in trows))
    want = jfast.schedule_scenarios(
        jns, jstate.stack_carry(jc, S), jr, jnp.asarray(w), jnp.asarray(v)
    )
    got = tfast.schedule_scenarios(
        tns, tstate.stack_carry(tc, S), tr, torch.from_numpy(w), torch.from_numpy(v)
    )
    _eq(tuple(want[0]), tuple(got[0]), f"{name} stacked carry")
    _eq(tuple(want[1:]), tuple(got[1:]), f"{name} outputs")
    nodes = got[1].numpy()
    assert (nodes >= 0).any()
    assert len({nodes[s].tobytes() for s in range(6)}) > 1  # the lanes differ


@pytest.fixture(scope="module")
def bench_plan():
    from bench import build_state

    jns, jc, batch = build_state(8, 24)
    valid = np.asarray(jns.valid)
    v, w = _lanes(valid, seed=3)
    want = jfast.schedule_scenarios_host(
        jns, jstate.stack_carry(jc, S), batch, jnp.asarray(w), jnp.asarray(v), 5
    )
    want = (jfast.carry_to_host(want[0]),) + tuple(np.asarray(a) for a in want[1:])
    return _to_port(tk.NodeStatic, jns), _to_port(tk.Carry, jc), batch, v, w, want


def test_chunked_scan_matches_single_scan(bench_plan, monkeypatch):
    tns, tc, batch, v, w, want = bench_plan
    monkeypatch.setenv("OSIM_WAVE_COMMIT", "0")
    outs = {}
    for chunk in ("0", "7"):
        monkeypatch.setenv("OSIM_COMMIT_CHUNK", chunk)
        carry_s, *rest = tfast.schedule_scenarios_host(
            tns, tstate.stack_carry(tc, S), batch, torch.from_numpy(w), torch.from_numpy(v), 5
        )
        outs[chunk] = (tfast.carry_to_host(carry_s),) + tuple(rest)
    for got in outs.values():
        for f in tk.Carry._fields:
            np.testing.assert_array_equal(got[0][f], want[0][f], err_msg=f)
        for a, b in zip(got[1:], want[1:]):
            # the port drops the batch's invalid trailing rows
            np.testing.assert_array_equal(a, b[:, : a.shape[1]])
        assert got[1].shape == (5, batch.p)


def test_scenario_carry_digest_matches_jax_and_host_twin(bench_plan):
    tns, tc, batch, v, w, want = bench_plan
    carry_s = tk.Carry(**{f: torch.from_numpy(np.array(want[0][f])) for f in tk.Carry._fields})
    dev = tfast.scenario_carry_digest(carry_s)
    host = tfast.scenario_carry_digest_host(tfast.carry_to_host(carry_s))
    jcarry = jk.Carry(**{f: jnp.asarray(want[0][f]) for f in tk.Carry._fields})
    assert dev == host == jfast.scenario_carry_digest(jcarry) == jfast.scenario_carry_digest_host(want[0])
    # sensitive to one flipped bit
    bumped = dict(want[0])
    bumped["free"] = bumped["free"].copy()
    bumped["free"].flat[3] = np.nextafter(bumped["free"].flat[3], np.float32(np.inf))
    assert tfast.scenario_carry_digest_host(bumped) != host


# ---------------------------------------------------------------------------
# simulate_batch / ScenarioSession: the cases of tests/test_batch_engine.py
# ---------------------------------------------------------------------------

def _overflow():
    nodes = [sc._mk_node(f"node-{i}", "8", "16Gi") for i in range(6)]
    return nodes, [("app", [sc._mk_deploy("web", 20, "1", "1Gi"), sc._mk_deploy("db", 6, "2", "2Gi")])]


def _tiers():
    nodes = [sc._mk_node(f"node-{i}", "4", "8Gi") for i in range(4)]
    high = sc._mk_deploy("high", 4, "2", "1Gi", spec_extra={"priority": 100})
    return nodes, [("tiers", [sc._mk_deploy("low", 14, "1", "512Mi"), high])]


CASES = {
    "node_count": (_overflow, [dict(name=f"+{k}", node_count=k) for k in range(1, 7)]),
    "node_valid": (_overflow, [
        dict(name="evens", node_valid=[i % 2 == 0 for i in range(6)]),
        dict(name="no-mid", node_valid=[True, True, False, False, True, True]),
        dict(name="all", node_valid=[True] * 6),
    ]),
    "weights": (_overflow, [
        dict(name="default"),
        dict(name="spread", weights={"least_allocated": 100}),
        dict(name="pack", weights={"node_affinity": 1}),
    ]),
    "preemption_fallback": (_tiers, [dict(name=f"+{k}", node_count=k) for k in (2, 3, 4)]),
    "mixed_axes": (_overflow, [
        dict(name="small", node_count=2),
        dict(name="masked", node_valid=[False, True] * 3, weights={"least_allocated": 100}),
        dict(name="full"),
    ]),
}


def _run_batch(pkg, case, mesh=None):
    objs, wl, sim = (jobj, jwl, jsim) if pkg == "jax" else (tobj, twl, tsim)
    spec, scens = CASES[case]
    wl.reset_name_rng()
    cluster, apps = sc.build(spec(), objs.Node, sim.ClusterResource, sim.AppResource)
    kw = {} if pkg == "jax" else {"device": "cpu", "mesh": mesh}
    results = sim.simulate_batch(cluster, apps, [sim.Scenario(**s) for s in scens], **kw)
    return [sc.result_digest(r) for r in results], results


@pytest.fixture(scope="module")
def jax_batches():
    return {case: _run_batch("jax", case)[0] for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_batch_lanes_match_jax_and_serial(jax_batches, case):
    got, results = _run_batch("torch", case)
    assert got == jax_batches[case]
    spec, scens = CASES[case]
    for s, lane in zip(scens, got):
        twl.reset_name_rng()
        cluster, apps = sc.build(spec(), tobj.Node, tsim.ClusterResource, tsim.AppResource)
        sub = tsim._scenario_cluster(cluster, tsim.Scenario(**s))
        serial = tsim.simulate(sub, apps, weights=s.get("weights"), device="cpu")
        assert sc.result_digest(serial) == lane, s["name"]
    if case == "node_count":
        assert results[0].unscheduled and not results[-1].unscheduled
        assert "nodes are available" in results[0].unscheduled[0].reason
    if case == "weights":
        assert len(set(got)) >= 2
    if case == "preemption_fallback":
        assert any(r.preempted for r in results)


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_batch_on_mesh_matches_jax(jax_batches, case):
    """simulate_batch(mesh=) over 4 CPU slots: the batched sweep splits its
    8 padded lanes 2 per slot, the serial fallback (preemption) runs
    node-sharded; every lane equals the JAX lane."""
    from open_simulator_tpu_torch.parallel import mesh as tmesh

    got, _ = _run_batch("torch", case, tmesh.product_mesh(4, device="cpu"))
    assert got == jax_batches[case]


def test_scenario_session_pack_of_one_equals_cold_simulate():
    twl.reset_name_rng()
    cluster, apps = sc.build(_overflow(), tobj.Node, tsim.ClusterResource, tsim.AppResource)
    session = tsim.ScenarioSession(cluster, apps, device="cpu")
    for k in (3, 6, 4):
        sc_k = tsim.Scenario(name=f"+{k}", node_count=k)
        got = session.run([sc_k])
        twl.reset_name_rng()
        c2, a2 = sc.build(_overflow(), tobj.Node, tsim.ClusterResource, tsim.AppResource)
        cold = tsim.simulate(tsim._scenario_cluster(c2, sc_k), a2, device="cpu")
        assert sc.result_digest(got[0]) == sc.result_digest(cold), k
    assert session.calls == 3 and session.pad_floor == tfast.SCENARIO_BUCKET


def test_scenario_validation():
    with pytest.raises(ValueError, match="both"):
        tsim.Scenario(node_count=1, node_valid=[True]).keep_mask(1)
    with pytest.raises(ValueError, match="outside"):
        tsim.Scenario(node_count=5).keep_mask(3)
    with pytest.raises(ValueError, match="entries"):
        tsim.Scenario(node_valid=[True]).keep_mask(3)
    assert tsim.Scenario(node_count=3).keep_mask(3) is None
    assert tfast.scenario_bucket(3) == 8 and tfast.scenario_bucket(3, floor=16) == 16
    assert os.environ.get("OSIM_COMMIT_CHUNK", "") in ("", "0")


@pytest.fixture(autouse=True, scope="module")
def _untraced_allocations():
    """Pause tracemalloc for this file: an earlier file in the same worker
    may have left it tracing (a heap-profile test does), which slows
    Python-heavy tests tens of times."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start()
