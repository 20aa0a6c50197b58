"""The port's simulator engine (`engine/simulator.py`: workload expansion,
profiles, plugins, DefaultPreemption with its batched device probe) against
the JAX package's `simulate()` on the same inputs. Tolerance: exact — equal
`sim_configs.result_digest` (placements, gpu-index annotations, unscheduled
reasons, victims, storage state), equal route counts, and the final carry
equal leaf by leaf. Every case rebuilds its input from plain dicts and
resets its package's name RNG before each run; the JAX runs are shared
through a module-scoped cache. `simulate(mesh=)` runs a set of the cases on
4 CPU mesh slots against the JAX package's mesh on 4 of its virtual CPU
devices (the preemption probe, profiles, the domain and sort routes)."""

import copy
import random

import numpy as np
import pytest
import torch

import test_core_scenario as jcs
from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.core import workloads as jwl
from open_simulator_tpu.engine import preemption as jpre
from open_simulator_tpu.engine import simulator as jsim
from open_simulator_tpu.models import profiles as jprof
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.parallel import mesh as jmesh
from open_simulator_tpu.plugins import DevicePlugin as JPlugin
from open_simulator_tpu_torch import sim_configs as sc
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.core import workloads as twl
from open_simulator_tpu_torch.engine import preemption as tpre
from open_simulator_tpu_torch.engine import simulator as tsim
from open_simulator_tpu_torch.models import profiles as tprof
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.parallel import mesh as tmesh
from open_simulator_tpu_torch.plugins import DevicePlugin as TPlugin
from open_simulator_tpu_torch.utils import metrics as tmetrics

PKGS = {
    "jax": (jobj, jwl, jsim, jprof, jfast, JPlugin),
    "torch": (tobj, twl, tsim, tprof, tfast, TPlugin),
}


# -- plain-dict inputs -------------------------------------------------------

def node(name, cpu="4", mem="8Gi", labels=None, taints=None, alloc_extra=None):
    res = {"cpu": cpu, "memory": mem, "pods": "110", **(alloc_extra or {})}
    return {
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name, **(labels or {})}},
        "spec": {"taints": taints or []},
        "status": {"allocatable": dict(res), "capacity": dict(res)},
    }


def pod(name, cpu="1", priority=0, labels=None, node_name="", anti_app=None):
    spec = {
        "containers": [{"name": "c", "image": "img", "resources": {"requests": {"cpu": cpu}}}],
        "priority": priority,
    }
    if node_name:
        spec["nodeName"] = node_name
    if anti_app:
        spec["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {"matchLabels": {"app": anti_app}},
                "topologyKey": "kubernetes.io/hostname",
            }]}}
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default",
                                        "labels": labels or {}}, "spec": spec}


def deploy(name, replicas, cpu="1", mem="1Gi", sched=None, spec_extra=None):
    spec = {"containers": [{"name": "c", "image": "i",
                            "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
    if sched:
        spec["schedulerName"] = sched
    spec.update(spec_extra or {})
    return {"kind": "Deployment", "metadata": {"name": name, "namespace": "x"},
            "spec": {"replicas": replicas,
                     "template": {"metadata": {"labels": {"app": name}}, "spec": spec}}}


PACKER = """
kind: KubeSchedulerConfiguration
profiles:
  - schedulerName: default-scheduler
  - schedulerName: packer
    plugins:
      score:
        disabled: [{name: "*"}]
        enabled: [{name: Simon, weight: 100}]
"""
NO_SPREAD_FILTER = """
kind: KubeSchedulerConfiguration
profiles:
  - plugins:
      filter:
        disabled:
          - name: PodTopologySpread
"""


def core_scenario(overload):
    """tests/test_core_scenario.py's cluster and apps as dicts."""
    cluster, metrics_server = jcs._build_cluster()
    if overload:
        objects = [jcs._workload(
            "Deployment", "busybox-deploy", "simple", {"replicas": 30},
            jcs._tmpl_spec("1500m", "1Gi", tolerations=[{
                "effect": "NoSchedule", "key": "node-role.kubernetes.io/master",
                "operator": "Exists"}]),
        )]
        app = ("overload", objects)
    else:
        simple = jcs._build_app()
        app = (simple.name, simple.objects)
    return {
        "nodes": [n.raw for n in cluster.nodes],
        "pods": [p.raw for p in cluster.pods],
        "daemonsets": cluster.daemonsets,
        "apps": [("cluster-workloads", [metrics_server]), app],
    }


def _zone_nodes():
    return [
        node(f"n{i}", cpu="4" if i == 0 else "64", mem="64Gi",
             labels={"topology.kubernetes.io/zone": "z0" if i == 0 else "z1"})
        for i in range(2)
    ]


_ZONE_SPREAD = {"topologySpreadConstraints": [{
    "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
    "whenUnsatisfiable": "DoNotSchedule", "labelSelector": {"matchLabels": {"app": "d"}},
}]}


def _spec_case(spec):
    nodes, apps = spec
    return {"nodes": nodes, "apps": apps}


def _inflate_cpu(pods):
    for p in pods:
        p.requests["cpu"] = 3000   # 3 cores each


def _plugin_filter(ns, carry, pod):
    return ns.alloc[:, 0] < 16500.0    # rejects the 17-core nodes


def _plugin_free_share(ns, carry, pod):
    free = carry.free[:, 0]
    return 100.0 * free / free.max()     # normalised by the largest node


def _plugin_index_filter(arange):
    def last_four(ns, carry, pod):
        return arange(ns.valid.shape[0]) >= 36
    return last_four


def _plugin_score(where, arange):
    def prefer_last(ns, carry, pod):
        n = ns.valid.shape[0]
        return where(arange(n) == 3, 100.0, 0.0)
    return prefer_last


# name -> case: nodes, pods (cluster pods), daemonsets, apps, and the
# simulate() options (weights, a scheduler config, plugins)
CASES = {
    "plan-2000x200": _spec_case(sc.plan_spec(2000, 200)),
    "preempt-12-80-20": _spec_case(sc.preempt_spec(12, 80, 20)),
    "core-scenario-simple": core_scenario(False),
    "core-scenario-overload": core_scenario(True),
    # tests/test_preemption.py:169 end to end
    "preempt-end-to-end": {
        "nodes": [node("w", cpu="4")],
        "pods": [pod(f"low{i}", cpu="2", priority=1) for i in range(2)],
        "apps": [("critical", [pod("hi", cpu="2", priority=1000)])],
    },
    # :200 the device probe sees anti-affinity the host model cannot
    "preempt-probe-anti-affinity": {
        "nodes": [node("a"), node("b")],
        "pods": [
            pod("guard", "500m", 1000, {"app": "guard"}, "a"),
            pod("victim-a", "3", 1, node_name="a"),
            pod("victim-b1", "1500m", 1, node_name="b"),
            pod("victim-b2", "1500m", 1, node_name="b"),
            pod("pre", "3", 100, anti_app="guard"),
        ],
        "apps": [],
    },
    # :274 a hypothetical eviction clears the anti-affinity conflict
    "preempt-eviction-clears-anti": {
        "nodes": [node("solo")],
        "pods": [pod("victim", "3", 1, {"app": "bad"}, "solo"), pod("pre", "3", 100, anti_app="bad")],
        "apps": [],
    },
    # tests/test_profiles.py:67 weights
    "weights-spread": {"nodes": [node(f"n{i}", "16", "32Gi") for i in range(4)],
                       "apps": [("a", [deploy("d", 8)])]},
    "weights-pack": {"nodes": [node(f"n{i}", "16", "32Gi") for i in range(4)],
                     "apps": [("a", [deploy("d", 8)])],
                     "weights": {"simon": 100.0, "least_allocated": 0.0,
                                 "balanced_allocation": 0.0}},
    # :115 a disabled filter
    "filter-strict": {"nodes": _zone_nodes(),
                      "apps": [("a", [deploy("d", 10, mem="0", spec_extra=_ZONE_SPREAD)])]},
    "filter-disabled": {"nodes": _zone_nodes(),
                        "apps": [("a", [deploy("d", 10, mem="0", spec_extra=_ZONE_SPREAD)])],
                        "sched_config": NO_SPREAD_FILTER},
    # :191 profiles by schedulerName, an unknown name failing
    "multi-profile": {
        "nodes": [node(f"n{i}", "16", "32Gi") for i in range(4)],
        "apps": [("a", [deploy("spready", 8)]), ("b", [deploy("packy", 8, sched="packer")]),
                 ("c", [deploy("lost", 1, sched="nobody")])],
        "sched_config": PACKER,
    },
    # tests/test_plugins.py's patch hook: the capacity math sees patched pods
    "patch-pods": {"nodes": [node("n0", "16", "32Gi")], "apps": [("a", [deploy("d", 8)])],
                   "patch_pods": {"Deployment": _inflate_cpu}},
    # out-of-tree filter + score plugins, with preemption, so the probe runs
    # the filter plugin under vmap
    "plugins-with-preemption": {
        "nodes": [node(f"n{i}", "16" if i % 2 == 0 else "17", "32Gi") for i in range(4)],
        "apps": [("a", [deploy("low", 16, cpu="2")]),
                 ("b", [deploy("high", 4, cpu="4", spec_extra={"priority": 50})])],
        "plugins": True,
    },
    # a score plugin that reduces over every node (normalised by the max);
    # 40 nodes, so a 4-slot mesh splits them over three slots
    "plugin-max-normalised": {
        "nodes": [node(f"n{i}", str(2 + i), "64Gi") for i in range(40)],
        "apps": [("a", [deploy("d", 12, cpu="1")])],
        "plugins": "max-normalised",
    },
    # a filter plugin that reads global node indices, with preemption, so
    # the probe runs it under vmap on the third slot's nodes
    "plugin-index-filter-preemption": {
        "nodes": [node(f"n{i}", "4", "32Gi") for i in range(40)],
        "apps": [("a", [deploy("low", 16, cpu="1")]),
                 ("b", [deploy("high", 4, cpu="4", spec_extra={"priority": 50})])],
        "plugins": "index-filter",
    },
}


def run_case(pkg, case, tmp_path, expand_cache=None, runs=1, mesh=1):
    """(result, final carry leaves as numpy, route counts) of the last of
    `runs` simulate() calls of one package; `mesh` > 1 runs on that many
    mesh slots (the port's on the CPU, the JAX package's virtual devices)."""
    objs, wl, sim, prof, fast, plugin_cls = PKGS[pkg]
    kwargs = {}
    if mesh > 1:
        kwargs["mesh"] = (
            jmesh.product_mesh(mesh) if pkg == "jax" else tmesh.product_mesh(mesh, device="cpu")
        )
    if case.get("weights"):
        kwargs["weights"] = case["weights"]
    if case.get("patch_pods"):
        kwargs["patch_pods"] = case["patch_pods"]
    if case.get("sched_config"):
        path = tmp_path / f"{pkg}-sched.yaml"
        path.write_text(case["sched_config"])
        kwargs["profiles"] = prof.load_scheduler_config(str(path)).profiles
    if case.get("plugins") == "max-normalised":
        kwargs["plugins"] = [plugin_cls("free-share", score_fn=_plugin_free_share, weight=1000.0)]
    elif case.get("plugins") == "index-filter":
        if pkg == "jax":
            import jax.numpy as jnp
            arange = jnp.arange
        else:
            arange = torch.arange
        kwargs["plugins"] = [plugin_cls("last-four", filter_fn=_plugin_index_filter(arange))]
    elif case.get("plugins"):
        if pkg == "jax":
            import jax.numpy as jnp
            score = _plugin_score(jnp.where, jnp.arange)
        else:
            score = _plugin_score(torch.where, torch.arange)
        kwargs["plugins"] = [plugin_cls("even", filter_fn=_plugin_filter),
                             plugin_cls("last", score_fn=score, weight=1000.0)]
    if pkg == "torch":
        kwargs["device"] = "cpu"
    wl.reset_name_rng()
    for _ in range(runs):
        case_c = copy.deepcopy(case)
        cluster = sim.ClusterResource(
            nodes=[objs.Node.from_dict(d) for d in case_c["nodes"]],
            pods=[objs.Pod.from_dict(d) for d in case_c.get("pods", [])],
            daemonsets=case_c.get("daemonsets", []),
        )
        apps = [sim.AppResource(name=n, objects=o) for n, o in case_c["apps"]]
        counts0 = dict(fast.PATH_COUNTS)
        s = sim.Simulator(cluster, expand_cache=expand_cache, **kwargs)
        result = s.run(apps)
    routes = {k: v - counts0.get(k, 0) for k, v in fast.PATH_COUNTS.items()
              if k in jfast.PATH_COUNTS and v - counts0.get(k, 0)}
    final = s._carry if pkg == "jax" else tmesh.gather(s._carry)
    carry = {f: np.asarray(getattr(final, f)) for f in final._fields}
    return result, carry, routes


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_case("jax", CASES[name], tmp_path_factory.mktemp("j"))
        return cache[name]

    return get


def assert_same(want, got):
    (jres, jcarry, jroutes), (tres, tcarry, troutes) = want, got
    assert sc.result_digest(tres) == sc.result_digest(jres)
    assert sc.result_counts(tres) == sc.result_counts(jres)
    assert [u.reason for u in tres.unscheduled] == [u.reason for u in jres.unscheduled]
    assert troutes == jroutes
    assert jcarry.keys() == tcarry.keys()
    for f, a in jcarry.items():
        assert a.dtype == tcarry[f].dtype and a.shape == tcarry[f].shape, f
        np.testing.assert_array_equal(a, tcarry[f], err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_simulate_matches_jax(jax_runs, tmp_path, name):
    want = jax_runs(name)
    got = run_case("torch", CASES[name], tmp_path)
    assert_same(want, got)
    res = got[0]
    if name == "plan-2000x200":
        assert sc.result_counts(res) == (1400, 600, 0)
        assert got[2] == {"sort": 1, "domain": 1}
    if name.startswith("preempt-"):
        assert res.preempted and not res.unscheduled
    if name == "preempt-probe-anti-affinity":
        # the host model alone would pick node a (fewer victims)
        assert {p.pod.meta.name for p in res.preempted} == {"victim-b1", "victim-b2"}
    if name == "multi-profile":
        assert len(res.unscheduled) == 1 and "nobody" in res.unscheduled[0].reason
    if name == "filter-strict":
        assert res.unscheduled
    if name == "filter-disabled":
        assert not res.unscheduled
    if name == "patch-pods":
        assert sc.result_counts(res) == (5, 3, 0)
    if name == "plugin-max-normalised":
        # the free-share score sends the pods to the largest nodes
        assert {st.node.name for st in res.node_status if st.pods} <= {f"n{i}" for i in range(28, 40)}
    if name == "plugin-index-filter-preemption":
        assert res.preempted
        assert {st.node.name for st in res.node_status if st.pods} <= {f"n{i}" for i in range(36, 40)}
    if name == "plugins-with-preemption":
        assert res.preempted
        assert {st.node.name for st in res.node_status if st.pods} <= {"n0", "n2"}


def test_expand_cache_reuse_matches_jax(tmp_path):
    """A second simulate() through a shared expand_cache rebinds the cached
    pods and equals the JAX package's second run."""
    before = tmetrics.EXPAND_CACHE.value(event="hit")
    got = run_case("torch", CASES["core-scenario-simple"], tmp_path, expand_cache={}, runs=2)
    assert tmetrics.EXPAND_CACHE.value(event="hit") == before + 2   # two apps
    assert_same(run_case("jax", CASES["core-scenario-simple"], tmp_path, expand_cache={}, runs=2), got)


def test_lane_rounds_match_jax_preemption():
    """tests/test_preemption.py:317's randomized clusters: the port's
    try_preempt (sequential and lane-parallel) picks the node and victims
    the JAX package's does."""
    rng = random.Random(20260730)
    for trial in range(25):
        n_nodes = rng.randint(1, 5)
        node_dicts = [node(f"n{i}") for i in range(n_nodes)]
        bound_dicts = {}
        for nd in node_dicts:
            name = nd["metadata"]["name"]
            bound_dicts[name] = [
                pod(f"{name}-p{j}", cpu=rng.choice(["500m", "1", "2"]),
                    priority=rng.choice([0, 1, 5, 50, 1000]),
                    labels={"grp": rng.choice(["a", "b"])}, node_name=name)
                for j in range(rng.randint(0, 4))
            ]
        with_pdb = rng.random() < 0.5
        min_avail = str(rng.randint(0, 3)) if with_pdb else None
        pre = pod("pre", cpu=rng.choice(["2", "3", "4"]), priority=100)
        picks = []
        for objs, pre_mod in ((jobj, jpre), (tobj, tpre)):
            nodes = [objs.Node.from_dict(copy.deepcopy(d)) for d in node_dicts]
            bound = {k: [objs.Pod.from_dict(copy.deepcopy(p)) for p in v]
                     for k, v in bound_dicts.items()}
            pdbs = [pre_mod.PodDisruptionBudget(
                name="pdb", namespace="default",
                selector=objs.LabelSelector.from_dict({"matchLabels": {"grp": "a"}}),
                min_available=min_avail,
            )] if with_pdb else []
            preemptor = objs.Pod.from_dict(copy.deepcopy(pre))

            def fits_many(p, items, pre_mod=pre_mod):
                return [pre_mod._fits(p, n, remaining) for n, remaining in items]

            for kw in ({}, {"fits_many_fn": fits_many}):
                r = pre_mod.try_preempt(preemptor, nodes, bound, pdbs, **kw)
                picks.append(None if r is None else (
                    r.node, [v.meta.name for v in r.victims], r.num_pdb_violations))
        assert picks[1:] == picks[:1] * 3, f"trial {trial}"


# the cases simulate(mesh=) runs: the sort and domain routes, preemption
# with its device probe, profiles, a disabled filter, plain weights, and
# out-of-tree plugins that read node indices (a filter under the probe's
# vmap) or reduce over every node
MESH_CASES = ["plan-2000x200", "preempt-end-to-end", "preempt-probe-anti-affinity",
              "preempt-eviction-clears-anti", "multi-profile", "filter-disabled",
              "weights-pack", "plugins-with-preemption", "plugin-max-normalised",
              "plugin-index-filter-preemption"]


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_case("jax", CASES[name], tmp_path_factory.mktemp("jm"), mesh=4)
        return cache[name]

    return get


@pytest.mark.parametrize("name", MESH_CASES)
def test_simulate_on_mesh_matches_jax(jax_runs, jax_mesh_runs, tmp_path, name):
    """simulate(mesh=) with the node axis split over 4 CPU slots equals the
    JAX package's simulate() on its 4-device mesh and the unsharded runs:
    result digest, reasons, route counts and every final carry leaf."""
    want = jax_runs(name)
    assert_same(want, jax_mesh_runs(name))
    assert_same(want, run_case("torch", CASES[name], tmp_path, mesh=4))


def test_resident_gated_off_under_mesh():
    """A resident beside a mesh is not used (the reference's gate), and the
    port counts it in osim_resident_fallbacks_total{reason="mesh"}."""
    before = tmetrics.RESIDENT_FALLBACKS.value(reason="mesh")
    s = tsim.Simulator(tsim.ClusterResource(), mesh=tmesh.product_mesh(2, device="cpu"),
                       resident=object(), device="cpu")
    assert s._resident is None
    assert tmetrics.RESIDENT_FALLBACKS.value(reason="mesh") == before + 1


def test_mesh_must_lie_on_the_device():
    """A mesh of CPU slots under a CUDA simulation (or the reverse) is
    refused before anything runs."""
    mesh = tmesh.Mesh([torch.device("meta")] * 2, ("nodes",))
    with pytest.raises(ValueError, match="does not lie on device"):
        tsim.Simulator(tsim.ClusterResource(), mesh=mesh, device="cpu")


def test_simulate_observes_metrics():
    """Each simulate() feeds the e2e histogram, the attempt and result
    counters."""
    count0 = tmetrics.E2E_SCHEDULING.child_state()[2]
    attempts0 = tmetrics.SCHEDULING_ATTEMPTS.value()
    unsched0 = tmetrics.SCHEDULE_RESULT.value(result="unscheduled")
    twl.reset_name_rng()
    res = tsim.simulate(*sc.plan(60, 6), device="cpu")
    assert tmetrics.E2E_SCHEDULING.child_state()[2] == count0 + 1
    assert tmetrics.SCHEDULING_ATTEMPTS.value() == attempts0 + 60
    assert tmetrics.SCHEDULE_RESULT.value(result="unscheduled") == unsched0 + len(res.unscheduled)


def test_simulate_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster, apps = sc.plan(20, 6)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.simulate(cluster, apps)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["plan", "preempt"])
def test_sim_digests_match_jax(name):
    """SIM_DIGESTS / SIM_COUNTS recomputed with the JAX package at full
    size (plan: 100,000 pods x 10,000 nodes)."""
    spec = sc.plan_spec() if name == "plan" else sc.preempt_spec()
    jwl.reset_name_rng()
    cluster, apps = sc.build(spec, jobj.Node, jsim.ClusterResource, jsim.AppResource)
    result = jsim.simulate(cluster, apps)
    assert sc.result_digest(result) == sc.SIM_DIGESTS[name]
    assert sc.result_counts(result) == sc.SIM_COUNTS[name]


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
