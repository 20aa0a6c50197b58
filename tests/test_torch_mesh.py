"""The port's device meshes (parallel/mesh.py, parallel/slots.py) against
the JAX package's parallel/mesh.py, on the CPU. Tolerance: exact.

The port's mesh slots lie on the one CPU device (a device may repeat); the
JAX package's mesh is on the 8 virtual CPU devices tests/conftest.py sets
up. Each case runs the same seeded input through both meshes and through
the port's unsharded path:
  - the counterparts of tests/test_parallel.py: the per-pod sharded scan,
    simulate(mesh=) on tests/fixtures/simon-config.yaml, the fast path
    under a node mesh (every carry leaf, the route counts), and the
    extender path;
  - the 2-D (scenarios, nodes) sweeps and the per-slot bytes of
    tests/test_node_bucket.py, and the unsharded fallback when the lanes or
    node rows do not divide the mesh;
  - the split specs against the reference's PartitionSpecs, and an argmax
    tie across a block boundary going to the lower slot.
"""

import os

import jax
import numpy as np
import pytest
import torch

from open_simulator_tpu.api.config import SimonConfig as JConfig
from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import apply as japply
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.models import profiles as jprof
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.ops import kernels as jk
from open_simulator_tpu.parallel import mesh as jmesh
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.api.config import SimonConfig as TConfig
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import apply as tapply
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.models import profiles as tprof
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops import kernels as tk
from open_simulator_tpu_torch.parallel import mesh as tmesh
from open_simulator_tpu_torch.parallel import slots as tslots
from open_simulator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)  # tiny tensors: threads only add contention

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "simon-config.yaml")


def _port(cls, tup):
    return cls(**{f: torch.from_numpy(np.array(getattr(tup, f))) for f in cls._fields})


def _assert_carry(want, got, what):
    for f in tk.Carry._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: carry.{f}")


def _cpu_mesh(n):
    return tmesh.make_mesh(["cpu"] * n)


# ---------------------------------------------------------------------------
# tests/test_parallel.py
# ---------------------------------------------------------------------------

def test_sharded_matches_single_device():
    """The per-pod oracle scan over 4 node slots equals the JAX sharded scan
    on 4 devices and both unsharded scans: placements, reasons, takes and
    every carry leaf."""
    from __graft_entry__ import _synthetic_state

    ns, carry, rows = _synthetic_state(n_nodes=64, n_pods=96)
    jw = jk.weights_array()
    jm = jmesh.make_mesh(jax.devices()[:4])
    want = jmesh.sharded_schedule_batch(jm)(*jmesh.shard_state(jm, ns, carry), rows, jw)
    tns, tc, trows = _port(tk.NodeStatic, ns), _port(tk.Carry, carry), _port(tk.PodRow, rows)
    tw = tk.weights_array(device="cpu")
    single = tk.schedule_batch(tns, tc, trows, tw)
    tm = _cpu_mesh(4)
    got = tmesh.sharded_schedule_batch(tm)(*tmesh.shard_state(tm, tns, tc), trows, tw)
    assert isinstance(got[0], tslots.Sharded)
    for k in range(1, 6):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(), err_msg=f"output {k}")
        assert torch.equal(single[k], got[k]), k
    _assert_carry(want[0], got[0].gather(), "mesh")
    _assert_carry(want[0], single[0], "single")
    assert int((got[1] >= 0).sum()) > 0


def _placements(res):
    return (
        sorted((p.key, st.node.name) for st in res.node_status for p in st.pods),
        [(u.pod.key, u.reason) for u in res.unscheduled],
        sc.result_digest(res),
    )


def test_product_engine_sharded_matches_single_device():
    """simulate(mesh=8 slots) on the e2e fixture places every pod where the
    JAX package's simulate(mesh=product_mesh(8)) and the unsharded runs
    do, by the same routes."""
    runs = {}
    for name, cfg_cls, apply_mod, wl, sim, kw in (
        ("jax", JConfig, japply, jwl, jsim, {"mesh": jmesh.product_mesh(8)}),
        ("torch", TConfig, tapply, twl, tsim, {"mesh": tmesh.product_mesh(8, device="cpu"),
                                               "device": "cpu"}),
        ("single", TConfig, tapply, twl, tsim, {"device": "cpu"}),
    ):
        cfg = cfg_cls.load(FIXTURE)
        wl.reset_name_rng()
        counts0 = dict(tfast.PATH_COUNTS)
        runs[name] = _placements(sim.simulate(apply_mod.build_cluster(cfg), apply_mod.build_apps(cfg), **kw))
        if name != "jax":
            runs[name + "-routes"] = {k: v - counts0[k] for k, v in tfast.PATH_COUNTS.items()}
    assert runs["torch"] == runs["jax"] == runs["single"]
    assert runs["torch-routes"] == runs["single-routes"]
    assert runs["torch"][0]


@pytest.fixture(scope="module")
def fast_state():
    from bench import build_state

    return build_state(64, 512)


def test_fast_path_under_mesh_matches_single_device(fast_state):
    """schedule_batch_fast over node-sharded state (the `--devices N` path at
    scale): placements, reasons, takes, every exit-carry leaf and the route
    counts equal the unsharded run; the JAX package's mesh run agrees."""
    ns, carry, batch = fast_state
    jm = jmesh.make_mesh()
    want = jfast.schedule_batch_fast(*jmesh.shard_state(jm, ns, carry), batch, jk.weights_array(),
                                     force_fast=True)
    tns, tc = _port(tk.NodeStatic, ns), _port(tk.Carry, carry)
    tw = tk.weights_array(device="cpu")
    routes = []
    outs = []
    for state in ((tns, tc), tmesh.shard_state(_cpu_mesh(8), tns, tc)):
        counts0 = dict(tfast.PATH_COUNTS)
        outs.append(tfast.schedule_batch_fast(*state, batch, tw, force_fast=True, device="cpu"))
        routes.append({k: v - counts0[k] for k, v in tfast.PATH_COUNTS.items() if v != counts0[k]})
    single, got = outs
    assert routes[0] == routes[1] and routes[0]
    for k in range(1, 6):
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"output {k}")
        np.testing.assert_array_equal(single[k], got[k], err_msg=f"output {k}")
    _assert_carry(want[0], got[0].gather(), "mesh")
    _assert_carry(want[0], single[0], "single")


def _extender_nodes(objs):
    return [
        objs.Node.from_dict({
            "metadata": {"name": f"m{i}", "labels": {"kubernetes.io/hostname": f"m{i}"}},
            "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}},
        })
        for i in range(16)
    ]


_EXT_APP = [{
    "kind": "Deployment",
    "metadata": {"name": "w", "namespace": "m"},
    "spec": {"replicas": 6, "template": {
        "metadata": {"labels": {"app": "w"}},
        "spec": {"containers": [{"name": "c", "image": "i",
                                 "resources": {"requests": {"cpu": "2"}}}]},
    }},
}]


@pytest.mark.parametrize("wave", ["0", ""])
def test_extender_path_under_mesh(stub_factory, monkeypatch, wave):
    """The extender path (the per-pod probe/commit loop, and the wave
    pipeline's probe_many/commit_wave) under a 4-slot node mesh equals the
    unsharded run and the JAX package's mesh run, with one pass-through
    stub extender."""
    monkeypatch.setenv("OSIM_EXTENDER_WAVE", wave) if wave else monkeypatch.delenv(
        "OSIM_EXTENDER_WAVE", raising=False)
    stub = stub_factory({})
    runs = {}
    for name, objs, wl, sim, prof, kw in (
        ("jax", jobj, jwl, jsim, jprof, {"mesh": jmesh.product_mesh(4)}),
        ("torch", tobj, twl, tsim, tprof, {"mesh": tmesh.product_mesh(4, device="cpu"),
                                           "device": "cpu"}),
        ("single", tobj, twl, tsim, tprof, {"device": "cpu"}),
    ):
        ext = [prof.ExtenderConfig(url_prefix=stub.url, filter_verb="filter",
                                   prioritize_verb="prioritize")]
        wl.reset_name_rng()
        res = sim.simulate(sim.ClusterResource(nodes=_extender_nodes(objs)),
                           [sim.AppResource(name="m", objects=[dict(o) for o in _EXT_APP])],
                           extenders=ext, **kw)
        runs[name] = _placements(res)
    assert runs["torch"] == runs["jax"] == runs["single"]
    assert not runs["torch"][1] and len(runs["torch"][0]) == 6


# ---------------------------------------------------------------------------
# tests/test_node_bucket.py: the 2-D (scenarios, nodes) mesh
# ---------------------------------------------------------------------------

_SCENARIOS = [dict(name="tiny", node_count=2), dict(name="half", node_count=3),
              dict(name="most", node_count=5), dict(name="all")]


def _overflow(objs, sim):
    nodes = [sc._mk_node(f"node-{i}", "8", "16Gi") for i in range(6)]
    apps = [("app", [sc._mk_deploy("web", 20, "1", "1Gi"), sc._mk_deploy("db", 6, "2", "2Gi")])]
    return sc.build((nodes, apps), objs.Node, sim.ClusterResource, sim.AppResource)


def _sweep(pkg, mesh):
    objs, wl, sim = (jobj, jwl, jsim) if pkg == "jax" else (tobj, twl, tsim)
    wl.reset_name_rng()
    cluster, apps = _overflow(objs, sim)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    res = sim.simulate_batch(cluster, apps, [sim.Scenario(**s) for s in _SCENARIOS], mesh=mesh, **kw)
    return [sc.result_digest(r) for r in res]


@pytest.fixture(scope="module")
def unsharded_sweep():
    return _sweep("torch", None)


@pytest.mark.parametrize("s_devs,n_devs", [(2, 1), (1, 2), (2, 2), (2, 4)])
def test_2d_mesh_sweep_is_digest_identical(unsharded_sweep, s_devs, n_devs):
    """simulate_batch on a (scenarios, nodes) mesh: lanes split over the
    first axis, every node-axis tensor over the second; each lane's digest
    equals the unsharded sweep's and the JAX package's on its 2-D mesh."""
    want = _sweep("jax", jmesh.product_mesh_2d(s_devs, n_devs))
    got = _sweep("torch", tmesh.product_mesh_2d(s_devs, n_devs, device="cpu"))
    assert got == want == unsharded_sweep


def test_2d_mesh_shards_node_tables_across_hbm():
    """Sharding the node axis cuts the bytes each slot holds: every slot of
    a 2x4 layout holds the JAX device's bytes, a quarter of the node tables
    plus the replicated leaves; the gauge snapshots the last layout."""
    from open_simulator_tpu.ops.encode import Encoder as JEncoder, encode_nodes as jencode
    from open_simulator_tpu.ops.state import node_static_from_table as jnsft
    from open_simulator_tpu_torch.ops.encode import Encoder, encode_nodes
    from open_simulator_tpu_torch.ops.state import node_static_from_table

    nodes = [sc._mk_node(f"h-{i:04d}", "8", "16Gi") for i in range(512)]
    enc = Encoder()
    ns = node_static_from_table(enc, encode_nodes(enc, [tobj.Node.from_dict(d) for d in nodes]),
                                device="cpu")
    mesh = tmesh.product_mesh_2d(2, 4, device="cpu")
    rep = tmesh.hbm_bytes_per_device(tmesh.replicated(mesh, ns))
    shd = tmesh.hbm_bytes_per_device(tmesh.put(mesh, ns, tmesh.node_sharding(mesh)))
    assert len(shd) == 8 and max(shd.values()) < max(rep.values())
    for dev, nbytes in shd.items():
        assert tmetrics.HBM_BYTES_PER_DEVICE.value(device=dev) == nbytes
    whole = sum(a.numel() * a.element_size() for a in ns)
    replicated_leaves = sum(
        a.numel() * a.element_size() for a, d in zip(ns, tmesh.node_sharding()) if d is None
    )
    assert max(shd.values()) == (whole - replicated_leaves) // 4 + replicated_leaves
    jenc_ = JEncoder()
    jns = jnsft(jenc_, jencode(jenc_, [jobj.Node.from_dict(d) for d in nodes]))
    jm = jmesh.product_mesh_2d(2, 4)
    jshd = jmesh.hbm_bytes_per_device(jax.device_put(jns, jmesh.node_sharding(jm)))
    assert sorted(jshd.values()) == sorted(shd.values())
    # a meta tensor stands for a leaf not made yet, charged whole
    planned = tmesh.hbm_bytes_per_device(torch.empty((512, 8), device="meta"), default_device="cpu")
    assert planned == {"cpu": 512 * 8 * 4}


@pytest.mark.parametrize("mesh", ["1d-3", "2d-3x1"])
def test_sweep_falls_back_unsharded_when_lanes_do_not_divide(unsharded_sweep, caplog, mesh):
    """8 padded lanes over 3 slots do not divide: the sweep runs unsharded,
    says so as the reference does, and gives the same digests."""
    import logging

    m = (tmesh.product_mesh(3, device="cpu") if mesh == "1d-3"
         else tmesh.product_mesh_2d(3, 1, device="cpu"))
    with caplog.at_level(logging.DEBUG, logger="osim"):
        assert _sweep("torch", m) == unsharded_sweep
    assert any("scenario sweep unsharded" in r.getMessage() for r in caplog.records)


# ---------------------------------------------------------------------------
# the split specs and the combines
# ---------------------------------------------------------------------------

def test_split_specs_match_the_reference_partition_specs():
    """Tripwire: each NodeStatic and Carry leaf splits on the dimension the
    reference's PartitionSpec names NODE_AXIS at (None: replicated)."""
    jm = jmesh.make_mesh()

    def node_dim(sharding):
        spec = tuple(sharding.spec)
        return spec.index(jmesh.NODE_AXIS) if jmesh.NODE_AXIS in spec else None

    for mine, ref in ((tmesh.node_sharding(), jmesh.node_sharding(jm)),
                      (tmesh.carry_sharding(), jmesh.carry_sharding(jm))):
        assert mine._fields == ref._fields
        assert list(mine) == [node_dim(s) for s in ref]
    assert (tmesh.NODE_AXIS, tmesh.SCENARIO_AXIS) == (jmesh.NODE_AXIS, jmesh.SCENARIO_AXIS)


def test_argmax_tie_across_a_block_boundary_goes_to_the_lower_slot():
    """A maximum tied at the last row of slot 0 and the first of slot 1
    picks the lower global index, as jnp.argmax on a sharded array does;
    the other combines equal the whole-vector reductions."""
    x = np.array([1, 3, 4, 7, 7, 2, 0, 7], np.float32)
    layout = tmesh.make_mesh(["cpu"] * 2).layout()
    jx = jax.device_put(x, jax.sharding.NamedSharding(jmesh.make_mesh(jax.devices()[:2]),
                                                      jax.sharding.PartitionSpec("nodes")))
    assert int(jax.numpy.argmax(jx)) == 3

    def per_slot(block):
        node, val = tslots.argmax_value(block)
        return (int(tslots.node_argmax(block)), int(node), float(val),
                float(tslots.node_amin(block)), float(tslots.node_sum(block, 0)),
                int(tslots.take(block, torch.tensor([4]))), bool(tslots.node_any(block > 6)))

    got = tslots.spmd(per_slot, tslots.NodeSlice(torch.from_numpy(x), 0), layout=layout, n_nodes=8)
    assert got[0] == got[1] == (3, 3, 7.0, 0.0, 31.0, 7, True)


def test_scheduling_ties_across_slots_follow_the_lowest_node():
    """Identical nodes tie every score: each pod goes to the lowest free
    node index, whichever slot holds it."""
    nodes = [sc._mk_node(f"n-{i}", "2", "4Gi") for i in range(8)]
    apps = [("a", [sc._mk_deploy("d", 12, "1", "1Gi")])]
    runs = []
    for mesh in (None, tmesh.product_mesh(2, device="cpu"), tmesh.product_mesh(8, device="cpu")):
        twl.reset_name_rng()
        cluster, a = sc.build((nodes, apps), tobj.Node, tsim.ClusterResource, tsim.AppResource)
        runs.append(_placements(tsim.simulate(cluster, a, mesh=mesh, device="cpu")))
    assert runs[0] == runs[1] == runs[2]


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
