"""The port's capacity planner (engine/capacity.py) and the node-table
encode it relies on, against the JAX package on the CPU. Tolerance: exact.

  - `clear_node_row` restores the pad bytes encode_nodes allocates, and a
    cleared row re-encoded equals a fresh encode; template-stamped tables
    (content signatures and capacity clones' `_stamp_token`) are
    byte-identical to the per-node loop and to the JAX encode (the contract
    of tests/test_node_bucket.py:205-260);
  - `plan_capacity` in serial, batched and auto mode on
    tests/test_e2e.py:78's overloaded fixture and on bench.py's
    capacity_sweep: equal nodes_added, attempts, batched_calls and result
    digest; a MaxCPU=60 case; `sim_configs.CAPACITY_DIGESTS` for
    capacity_sweep, and (slow) plan_small and plan_full recomputed with the
    JAX package;
  - `plan_capacity(mesh=)` serial and batched on 2 CPU slots equal to the
    JAX package's plan on its mesh and to the unsharded plan, journaled on
    one mesh and resumed on another.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from open_simulator_tpu.api.config import SimonConfig as JConfig
from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import apply as japply
from open_simulator_tpu.engine import capacity as jcap
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.ops import encode as jenc
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.api.config import SimonConfig as TConfig
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import apply as tapply
from open_simulator_tpu_torch.engine import capacity as tcap
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.ops import encode as tenc
from tests.factories import make_node
from tests.test_node_bucket import gpu_node, mixed_population

torch.set_num_threads(1)  # tiny tensors: threads only add contention

E2E_CONFIG = Path(__file__).resolve().parent / "fixtures" / "simon-config.yaml"
PKGS = {
    "jax": (jobj, jwl, jsim, jcap, JConfig, japply, {}),
    "torch": (tobj, twl, tsim, tcap, TConfig, tapply, {"device": "cpu"}),
}


def _tables_equal(a, b, what):
    for f in tenc._STAMP_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert x.tobytes() == y.tobytes(), f"{what}: field {f} diverged"  # NaN-aware
    assert a.names == b.names, what


def test_clear_node_row_restores_pad_bytes():
    nodes = mixed_population(4)
    enc = tenc.Encoder()
    table = tenc.encode_nodes(enc, nodes, stamp=False)
    fresh = tenc.encode_nodes(tenc.Encoder(), nodes[:-3], n_pad=table.alloc.shape[0], stamp=False)
    n = len(nodes)
    for i in range(n - 3, n):
        tenc.clear_node_row(table, i)
    del table.names[n - 3:]
    # rows past the shorter list are pad rows, byte for byte
    for f in tenc._STAMP_FIELDS:
        assert np.asarray(getattr(table, f))[n - 3:].tobytes() == \
            np.asarray(getattr(fresh, f))[n - 3:].tobytes(), f
    # and a cleared row re-encoded equals the JAX encode of the full list
    for i in range(n - 3, n):
        tenc.encode_node_into(enc, table, i, nodes[i], {}, {})
        table.names.append(nodes[i].name)
    want = jenc.encode_nodes(jenc.Encoder(), nodes, stamp=False)
    _tables_equal(want, table, "re-encoded")
    jt = jenc.encode_nodes(jenc.Encoder(), nodes, stamp=False)
    jenc.clear_node_row(jt, 0)
    tt = tenc.encode_nodes(tenc.Encoder(), nodes, stamp=False)
    tenc.clear_node_row(tt, 0)
    _tables_equal(jt, tt, "cleared")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stamped_encode_matches_loop_and_jax(seed):
    nodes = mixed_population(seed)
    usage = {nodes[0].name: {"cpu": 2000, "memory": 1 << 30}}
    gpu = {nd.name: np.array([1024.0], np.float32) for nd in nodes if nd.gpu_count() == 1}
    tables = {}
    for name, mod in (("jax", jenc), ("torch", tenc)):
        for stamp in (False, True):
            enc = mod.Encoder()
            t = mod.encode_nodes(enc, nodes, existing_usage=usage, existing_gpu=gpu, stamp=stamp)
            tables[name, stamp] = (t, len(enc.names), len(enc.pairs))
    want = tables["jax", False]
    for key, got in tables.items():
        _tables_equal(want[0], got[0], str(key))
        assert got[1:] == want[1:], key


def test_fake_node_clones_stamp_byte_identical():
    """Capacity clones take the `_stamp_token` path; a clone that drifts out
    of its group through a bound-usage entry stays exact."""
    base = [make_node(f"base-{i}", cpu="8", memory="16Gi") for i in range(3)]
    t1 = make_node("t1", cpu="32", memory="64Gi", with_labels={"zone": "a"})
    t2 = gpu_node("t2", count=2)
    nodes = base + tcap.new_fake_nodes(t1, 50) + tcap.new_fake_nodes(t2, 80, start=50)
    assert all("_stamp_token" in nd.__dict__ for nd in nodes[3:])
    usage = {"simon-00003": {"cpu": 1000, "memory": 1 << 30}}
    want = jenc.encode_nodes(jenc.Encoder(), nodes, existing_usage=usage, stamp=False)
    for stamp in (False, True):
        got = tenc.encode_nodes(tenc.Encoder(), nodes, existing_usage=usage, stamp=stamp)
        _tables_equal(want, got, f"stamp={stamp}")
    assert tenc.ladder_rungs(9000) == jenc.ladder_rungs(9000)


# ---------------------------------------------------------------------------
# plan_capacity against the JAX package
# ---------------------------------------------------------------------------

def _e2e_inputs(pkg):
    objs, wl, sim, cap, cfg_cls, apply_mod, kw = PKGS[pkg]
    cfg = cfg_cls.load(str(E2E_CONFIG))
    cluster, apps = apply_mod.build_cluster(cfg), apply_mod.build_apps(cfg)
    for app in apps:  # quadruple the web deployment so it cannot fit
        for obj in app.objects:
            if obj.get("kind") == "Deployment":
                obj["spec"]["replicas"] = 20
    return cluster, apps, apply_mod.load_new_node(cfg)


def _sweep_inputs(pkg):
    objs, wl, sim, *_ = PKGS[pkg]
    cluster, apps = sc.build(sc.capacity_sweep_spec(), objs.Node, sim.ClusterResource,
                             sim.AppResource)
    return cluster, apps, objs.Node.from_dict(sc.template_spec())


def _plan_tiny_inputs(pkg):
    objs, wl, sim, *_ = PKGS[pkg]
    cluster, apps = sc.build(sc.plan_spec(160, 14), objs.Node, sim.ClusterResource,
                             sim.AppResource)
    return cluster, apps, objs.Node.from_dict(sc.template_spec())


FIXTURE_INPUTS = {"e2e": _e2e_inputs, "capacity_sweep": _sweep_inputs}


def _plan(pkg, fixture, mode):
    objs, wl, sim, cap, *_, kw = PKGS[pkg]
    wl.reset_name_rng()
    cluster, apps, template = FIXTURE_INPUTS[fixture](pkg)
    p = cap.plan_capacity(cluster, apps, template, sweep_mode=mode, **kw)
    return p.nodes_added, p.attempts, p.batched_calls, sc.result_digest(p.result)


@pytest.fixture(scope="module")
def jax_plans():
    return {}


@pytest.mark.parametrize("mode", ["serial", "batched", "auto"])
@pytest.mark.parametrize("fixture", ["e2e", "capacity_sweep"])
def test_plan_capacity_matches_jax(jax_plans, fixture, mode):
    key = (fixture, mode)
    if key not in jax_plans:
        jax_plans[key] = _plan("jax", fixture, mode)
    got = _plan("torch", fixture, mode)
    assert got == jax_plans[key]
    assert got[0] >= 1
    if fixture == "capacity_sweep":
        assert got == sc.CAPACITY_DIGESTS[f"capacity_sweep/{mode}"]
        assert (got[2] > 0) == (mode != "serial")
    else:  # the fixture's cluster DaemonSet makes the workload batch-ineligible
        assert got[2] == 0


def test_plan_capacity_max_cpu_gate(monkeypatch):
    """MaxCPU=60: the utilization gate, not scheduling, sets the answer, in
    the serial bisection and in the batched verdict lanes."""
    FIXTURE_INPUTS["plan_tiny"] = _plan_tiny_inputs
    plans = {}
    for gate in ("100", "60"):
        monkeypatch.setenv("MaxCPU", gate)
        for mode in ("serial", "batched"):
            plans[gate, mode] = _plan("torch", "plan_tiny", mode)
            assert plans[gate, mode] == _plan("jax", "plan_tiny", mode), (gate, mode)
        assert plans[gate, "serial"][0] == plans[gate, "batched"][0]
    assert plans["60", "serial"][0] > plans["100", "serial"][0]


def _small_sweep(pkg, mode, mesh=None, **kw):
    """plan_capacity on a 16-replica capacity_sweep, optionally on a mesh of
    2 slots (the port's on the CPU, the JAX package's virtual devices)."""
    objs, wl, sim, cap, *_, extra = PKGS[pkg]
    wl.reset_name_rng()
    cluster, apps = sc.build(sc.capacity_sweep_spec(2, 16), objs.Node, sim.ClusterResource,
                             sim.AppResource)
    p = cap.plan_capacity(cluster, apps, objs.Node.from_dict(sc.template_spec()),
                          sweep_mode=mode, mesh=mesh, **kw, **extra)
    return p.nodes_added, p.attempts, p.batched_calls, sc.result_digest(p.result)


@pytest.mark.parametrize("mode", ["serial", "batched"])
def test_plan_capacity_on_mesh_matches_jax(mode):
    """plan_capacity(mesh=): every probe and the finalize node-sharded, the
    batched sweeps' lanes split, over 2 CPU slots; the plan equals the JAX
    package's plan on its 2-device mesh and the port's unsharded plan."""
    from open_simulator_tpu.parallel import mesh as jmesh
    from open_simulator_tpu_torch.parallel import mesh as tmesh

    want = _small_sweep("jax", mode, jmesh.product_mesh(2))
    got = _small_sweep("torch", mode, tmesh.product_mesh(2, device="cpu"))
    assert got == want == _small_sweep("torch", mode)
    assert (got[2] > 0) == (mode == "batched")


def test_plan_capacity_on_mesh_journaled_and_resumed(tmp_path):
    """A journaled search on a 2-slot mesh resumes on a 4-slot mesh and on
    none: the journaled verdicts replay and the plan is the same."""
    from open_simulator_tpu_torch.durable import RunJournal
    from open_simulator_tpu_torch.parallel import mesh as tmesh

    journal = RunJournal.open(str(tmp_path / "run"))
    first = _small_sweep("torch", "batched", tmesh.product_mesh(2, device="cpu"), journal=journal)
    journal.close()
    for mesh in (tmesh.product_mesh(4, device="cpu"), None):
        journal = RunJournal.open(str(tmp_path / "run"))
        assert _small_sweep("torch", "batched", mesh, journal=journal, resume=True) == first
        journal.close()


def test_plan_capacity_rejects_unknown_sweep_mode():
    cluster, apps, template = _sweep_inputs("torch")
    with pytest.raises(ValueError, match="sweep_mode"):
        tcap.plan_capacity(cluster, apps, template, sweep_mode="fast", device="cpu")


def test_guarded_call_deadline(monkeypatch):
    """The watchdog around probes and sweeps: deadline 0 runs the call
    inline, a call past its deadline raises DeadlineExceeded (nothing
    degrades), and a call's own exception reaches the caller."""
    import threading

    from open_simulator_tpu_torch.durable import watchdog

    monkeypatch.delenv("OSIM_CALL_DEADLINE_S", raising=False)
    assert watchdog.call_deadline_s() == 0.0
    assert watchdog.guarded_call("t", threading.get_ident, 0) == threading.get_ident()
    monkeypatch.setenv("OSIM_CALL_DEADLINE_S", "0.2")
    assert watchdog.call_deadline_s() == 0.2
    assert watchdog.guarded_call("t", lambda: 7, 5.0) == 7
    release = threading.Event()
    try:
        with pytest.raises(watchdog.DeadlineExceeded, match="capacity-probe exceeded 0.2s"):
            watchdog.guarded_call("capacity-probe", lambda: release.wait(10), 0.2)
    finally:
        release.set()
    with pytest.raises(KeyError):
        watchdog.guarded_call("t", lambda: {}["x"], 5.0)


@pytest.mark.slow
@pytest.mark.parametrize("name, n_pods, n_nodes, modes", [
    ("plan_small", *sc.PLAN_SMALL, ("serial", "auto")),
    ("plan_full", 100_000, 10_000, ("serial",)),
])
def test_capacity_digests_match_jax(name, n_pods, n_nodes, modes):
    """CAPACITY_DIGESTS recomputed with the JAX package and reproduced by
    the port, at full size (plan_full: 100,000 pods x 10,000 nodes)."""
    for mode in modes:
        got = {}
        for pkg in ("jax", "torch"):
            objs, wl, sim, cap, *_, kw = PKGS[pkg]
            wl.reset_name_rng()
            cluster, apps = sc.build(sc.plan_spec(n_pods, n_nodes), objs.Node,
                                     sim.ClusterResource, sim.AppResource)
            p = cap.plan_capacity(cluster, apps, objs.Node.from_dict(sc.template_spec()),
                                  sweep_mode=mode, **kw)
            got[pkg] = (p.nodes_added, p.attempts, p.batched_calls, sc.result_digest(p.result))
        assert got["torch"] == got["jax"] == sc.CAPACITY_DIGESTS[f"{name}/{mode}"]


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
