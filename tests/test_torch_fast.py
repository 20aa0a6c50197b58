"""The port's schedule_batch_fast against the JAX package's, on the CPU.

Each scenario encodes the same node/pod dicts with both packages, schedules
the batch with both fast paths and demands exact equality of placements,
failure reasons, GPU/VG/device takes, every carry leaf and the route each
group took (PATH_COUNTS deltas). One case per scenario of the JAX package's
tests/test_fast.py, the spread ones also with DM_CAP = 0 in both packages
(the micro body). The domain groups run the pop loop's plain version
(tensors on the CPU).
"""

import json

import numpy as np
import pytest

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.ops import encode as jenc
from open_simulator_tpu.ops import fast as jfast
from open_simulator_tpu.ops import state as jstate
from open_simulator_tpu.ops.kernels import weights_array as jax_weights
from open_simulator_tpu.ops.tile import tile_pod_batch as jax_tile
from open_simulator_tpu_torch import bench_configs, headline
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.ops import encode as tenc
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops import state as tstate
from open_simulator_tpu_torch.ops.kernels import F_NODE_PORTS, F_RESOURCES, F_SPREAD, NUM_FILTERS
from open_simulator_tpu_torch.ops.kernels import weights_array as torch_weights
from open_simulator_tpu_torch.ops.tile import tile_pod_batch as torch_tile

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
GIB = 1 << 30


def node_dict(name, cpu="16", mem="32Gi", pods="16", labels=None, taints=None, extra=None):
    res = {"cpu": cpu, "memory": mem, "pods": pods, **(extra or {})}
    return {
        "metadata": {"name": name, "labels": {HOST: name, **(labels or {})}},
        "spec": {"taints": taints or []},
        "status": {"allocatable": dict(res), "capacity": dict(res)},
    }


def pod_dict(cpu="500m", mem="512Mi", labels=None, spec_extra=None, anno=None, name="t"):
    spec = {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
    spec.update(spec_extra or {})
    return {
        "metadata": {"name": name, "namespace": "fast", "labels": labels or {},
                     "annotations": anno or {}},
        "spec": spec,
    }


def spread(key, skew, hard, app):
    return {
        "maxSkew": skew, "topologyKey": key,
        "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
        "labelSelector": {"matchLabels": {"app": app}},
    }


def pod_affinity(kind, app, key=ZONE, required=True, weight=10):
    term = {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key}
    if required:
        return {"affinity": {kind: {"requiredDuringSchedulingIgnoredDuringExecution": [term]}}}
    return {"affinity": {kind: {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": weight, "podAffinityTerm": term}]}}}


def host_port(cpu="100m", mem=None):
    req = {"cpu": cpu, **({"memory": mem} if mem else {})}
    return {"containers": [{"name": "c", "resources": {"requests": req},
                            "ports": [{"containerPort": 80, "hostPort": 8080}]}]}


def encode_both(node_dicts, pod_dicts, counts, bound=()):
    """(JAX state, port state on the CPU) from the same dicts; `bound` holds
    (pod dict, node name) pairs already running on the cluster."""
    out = []
    for objs, enc_mod, st, tile, kw in (
        (jobj, jenc, jstate, jax_tile, {}),
        (tobj, tenc, tstate, torch_tile, {"device": "cpu"}),
    ):
        templates = [objs.Pod.from_dict(d) for d in pod_dicts]
        placed = []
        for d, node in bound:
            p = objs.Pod.from_dict(d)
            p.node_name = node
            placed.append((p, node))
        enc = enc_mod.Encoder()
        enc.register_pods(templates)
        for p, _ in placed:
            enc.register_pods([p])
        table = enc_mod.encode_nodes(
            enc, [objs.Node.from_dict(d) for d in node_dicts],
            existing_usage=enc_mod.aggregate_usage(placed),
        )
        batch = tile(enc_mod.encode_pods(enc, templates), counts)
        ns = st.node_static_from_table(enc, table, **kw)
        carry = st.carry_from_table(
            table, enc_mod.initial_selector_counts(enc, table, placed),
            port_counts=enc_mod.initial_port_counts(enc, table, placed),
            anti_counts=enc_mod.initial_anti_counts(enc, table, placed), **kw,
        )
        out.append((ns, carry, batch))
    return out


def assert_same_schedule(jax_state, port_state, **kw):
    """Schedule with both packages; exact equality of every output and
    carry leaf, and of the route counts. Returns (the port's PATH_COUNTS
    deltas, its result)."""
    before_j, before_t = dict(jfast.PATH_COUNTS), dict(tfast.PATH_COUNTS)
    kw.setdefault("force_fast", True)
    want = jfast.schedule_batch_fast(*jax_state, jax_weights(), **kw)
    got = tfast.schedule_batch_fast(*port_state, torch_weights(device="cpu"), device="cpu", **kw)
    for name, a, b in zip(("nodes", "reasons", "take", "vg", "dev"), want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        assert np.asarray(a).dtype == b.dtype, name
    for f in want[0]._fields:
        a, b = np.asarray(getattr(want[0], f)), getattr(got[0], f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"carry field {f}")
    assert headline.placement_digest(*want) == headline.placement_digest(*got)
    deltas = {k: tfast.PATH_COUNTS[k] - before_t[k] for k in before_t}
    jax_deltas = {k: jfast.PATH_COUNTS[k] - before_j[k] for k in before_j}
    assert jax_deltas == {k: deltas[k] for k in jax_deltas}, (jax_deltas, deltas)
    return deltas, got


def zone_nodes(n, cpu=lambda i: "32", pods="12", extra=lambda i: {}):
    return [
        node_dict(f"n-{i}", cpu=cpu(i), pods=pods, labels={ZONE: f"z-{i % 3}", **extra(i)})
        for i in range(n)
    ]


def test_headline_cluster_small():
    """The headline generator at 60 nodes x 800 pods: two sort groups and
    two domain groups, identical to the JAX package's bench.build_state."""
    from bench import build_state

    deltas, got = assert_same_schedule(
        build_state(60, 800), headline.build_state(60, 800, device="cpu")
    )
    assert deltas["sort"] == 2 and deltas["domain"] == 2, deltas
    assert deltas["domain_kernel"] == 0  # the CPU runs the plain pop loop


SCENARIOS = {
    # the two scenarios of the JAX package's Pallas-kernel parity test
    "pallas-soft": (
        zone_nodes(9, cpu=lambda i: "4" if i < 3 else "32"),
        pod_dict(labels={"app": "hard"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 4, False, "hard")]}),
        120, "domain",
    ),
    "pallas-hard": (
        zone_nodes(9, cpu=lambda i: "4" if i < 3 else "32"),
        pod_dict(labels={"app": "hard"}, spec_extra={"topologySpreadConstraints": [
            spread(ZONE, 1, True, "hard"), spread(ZONE, 4, False, "hard")]}),
        120, "domain",
    ),
    "two-keys": (
        [node_dict(f"n-{i}", cpu="2", pods="14", labels={ZONE: f"z-{i % 2}", "rack": f"r-{i % 4}"})
         for i in range(12)],
        pod_dict(labels={"app": "mk"}, spec_extra={"topologySpreadConstraints": [
            spread(ZONE, 3, False, "mk"), spread("rack", 2, True, "mk")]}),
        60, "domain",
    ),
    "eligibility-split": (
        zone_nodes(10, cpu=lambda i: "8", pods="14",
                   extra=lambda i: {"tier": "gold" if i % 2 == 0 else "silver"}),
        pod_dict(labels={"app": "el"}, spec_extra={
            "nodeSelector": {"tier": "gold"},
            "topologySpreadConstraints": [spread(ZONE, 1, True, "el")]}),
        60, "domain",
    ),
    "host-ports": (
        zone_nodes(9, pods="30"),
        pod_dict(labels={"app": "hp"}, spec_extra={
            **host_port(), "topologySpreadConstraints": [spread(ZONE, 2, False, "hp")]}),
        20, "domain",
    ),
    "pure-sort": (
        [node_dict(f"n-{i}", cpu="16", pods="12") for i in range(6)],
        pod_dict(), 60, "sort",
    ),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_match_jax(name):
    nodes, pod, count, path = SCENARIOS[name]
    jax_state, port_state = encode_both(nodes, [pod], [count])
    deltas, got = assert_same_schedule(jax_state, port_state)
    assert deltas[path] == 1, deltas
    assert (got[1][:count] >= 0).any()


def test_uncovered_route_raises():
    """A hostname-keyed spread group takes the general light scan: equal to
    the JAX package's run, on the `scan` route."""
    nodes = zone_nodes(6)
    pod = pod_dict(labels={"app": "h"}, spec_extra={"topologySpreadConstraints": [
        spread(HOST, 1, False, "h")]})
    deltas, _ = assert_same_schedule(*encode_both(nodes, [pod], [40]))
    assert deltas["scan"] == 1, deltas


def test_affinity_group_raises():
    """A zone anti-affinity group takes the domain path's affinity pop loop:
    equal to the JAX package's run, no kernel."""
    nodes = zone_nodes(6)
    pod = pod_dict(labels={"app": "a"}, spec_extra=pod_affinity("podAntiAffinity", "a"))
    deltas, _ = assert_same_schedule(*encode_both(nodes, [pod], [40]))
    assert deltas["domain"] == 1 and deltas["domain_kernel"] == 0, deltas


def _fo(off):
    fo = np.ones(NUM_FILTERS, bool)
    fo[off] = False
    return fo


def _gpu_nodes():
    return [node_dict(f"g-{i}", cpu="64", mem="256Gi", pods="110", extra={
        "alibabacloud.com/gpu-count": "4", "alibabacloud.com/gpu-mem": "64Gi"})
        for i in range(4)]


def _storage_nodes():
    nodes = []
    for i in range(4):
        d = node_dict(f"s-{i}", cpu="32", pods="110")
        d["metadata"]["annotations"] = {"simon/node-local-storage": json.dumps({
            "vgs": [{"name": "pool", "capacity": str((40 + 10 * i) * GIB), "requested": "0"}],
            "devices": []})}
        nodes.append(d)
    return nodes


def _bound_hogs():
    return [
        (pod_dict(cpu="100m", mem="90Gi", name=f"hog-{i}"), f"n-{i}") for i in range(4)
    ]


# name: (nodes, templates, counts, kwargs, bound, routes that must fire).
# The JAX package's tests/test_fast.py scenarios, in its order.
FAST_CASES = {
    "overflow-reasons": (
        [node_dict(f"n-{i}", cpu="4", pods="6", labels={ZONE: f"z-{i % 2}"}) for i in range(6)],
        [pod_dict(cpu="1", labels={"app": "web"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 2, False, "web")]})],
        [64], {}, (), ("domain",),
    ),
    "hard-spread-hostname": (
        zone_nodes(9, pods="20"),
        [pod_dict(cpu="250m", labels={"app": "spread"}, spec_extra={
            "topologySpreadConstraints": [
                spread(ZONE, 1, True, "spread"), spread(HOST, 3, True, "spread")]})],
        [120], {}, (), ("scan",),
    ),
    "required-anti-affinity-hostname": (
        [node_dict(f"n-{i}", pods="30") for i in range(8)],
        [pod_dict(cpu="100m", labels={"app": "solo"},
                  spec_extra=pod_affinity("podAntiAffinity", "solo", key=HOST)),
         pod_dict(cpu="100m", labels={"app": "other"}, name="o")],
        [24, 24], {}, (), ("scan",),
    ),
    "pod-affinity-zone": (
        zone_nodes(9, pods="30"),
        [pod_dict(cpu="100m", labels={"app": "pack"}, spec_extra=pod_affinity("podAffinity", "pack"))],
        [40], {}, (), ("domain",),
    ),
    "host-ports-sort": (
        [node_dict(f"n-{i}", pods="30") for i in range(5)],
        [pod_dict(cpu="100m", spec_extra=host_port())], [12], {}, (), ("sort",),
    ),
    "gpu-share": (
        _gpu_nodes(),
        [pod_dict(cpu="1", mem="1Gi", name="s", anno={
            "alibabacloud.com/gpu-mem": "4Gi", "alibabacloud.com/gpu-count": "1"}),
         pod_dict(cpu="1", mem="1Gi", name="m", anno={
             "alibabacloud.com/gpu-mem": "8Gi", "alibabacloud.com/gpu-count": "2"})],
        [30, 20], {}, (), ("scan",),
    ),
    "open-local-storage": (
        _storage_nodes(),
        # the volume in the annotation's {"volumes": [...]} form, so the
        # group really binpacks (test_fast.py's bare list parses to none)
        [pod_dict(cpu="250m", anno={"simon/pod-local-storage": json.dumps({"volumes": [
            {"kind": "LVM", "size": str(5 * GIB), "scName": "open-local-lvm"}]})}),
         pod_dict(cpu="250m", name="p")],
        [28, 12], {}, (), ("scan", "sort"),
    ),
    "taints-and-selectors": (
        [node_dict(f"n-{i}", pods="20", labels={"tier": "gold" if i % 3 == 0 else "silver"},
                   taints=[{"key": "dedicated", "value": "batch", "effect": "NoSchedule"}]
                   if i % 2 == 0 else [])
         for i in range(8)],
        [pod_dict(cpu="200m", labels={"app": "b"}, name="tol", spec_extra={"tolerations": [
            {"key": "dedicated", "operator": "Equal", "value": "batch", "effect": "NoSchedule"}]}),
         pod_dict(cpu="200m", labels={"app": "c"}, name="pin",
                  spec_extra={"nodeSelector": {"tier": "gold"}})],
        [30, 20], {}, ((pod_dict(cpu="1", labels={"app": "b"}, name="pre"), "n-1"),), ("sort",),
    ),
    "small-group-falls-back": (
        [node_dict(f"n-{i}") for i in range(4)], [pod_dict(cpu="250m")], [10],
        {"force_fast": False}, (), ("grouped",),
    ),
    "resources-filter-disabled": (
        [node_dict(f"n-{i}", cpu="2", pods="4") for i in range(3)], [pod_dict(cpu="1")], [80],
        {"filter_on": _fo(F_RESOURCES)}, (), ("grouped",),
    ),
    "ports-filter-disabled": (
        [node_dict(f"n-{i}", pods="40") for i in range(4)],
        [pod_dict(cpu="100m", spec_extra=host_port())], [20],
        {"filter_on": _fo(F_NODE_PORTS)}, (), ("sort",),
    ),
    "sort-monotonicity-fallback": (
        [node_dict(f"n-{i}", cpu="10", mem="100Gi", pods="40") for i in range(4)],
        [pod_dict(cpu="1", mem="1Gi")], [30], {}, _bound_hogs(), ("sort_fallback", "scan"),
    ),
    # the same rising balanced-allocation lanes in a zone-spread group: the
    # domain path's merge is voided and the micro body replays it
    "domain-monotonicity-fallback": (
        [node_dict(f"n-{i}", cpu="10", mem="100Gi", pods="40", labels={ZONE: f"z-{i % 2}"})
         for i in range(4)],
        [pod_dict(cpu="1", mem="1Gi", labels={"app": "df"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 2, False, "df")]})],
        [30], {}, _bound_hogs(), ("domain_fallback", "micro"),
    ),
    "domain-required-anti-affinity": (
        zone_nodes(9, pods="10"),
        [pod_dict(labels={"app": "exc"}, spec_extra=pod_affinity("podAntiAffinity", "exc"))],
        [70], {}, (), ("domain",),
    ),
    "domain-required-affinity-first-pod": (
        zone_nodes(9, pods="10"),
        [pod_dict(labels={"app": "co"}, spec_extra=pod_affinity("podAffinity", "co"))],
        [40], {}, (), ("domain",),
    ),
    "domain-preferred-affinity-score": (
        zone_nodes(9, pods="20"),
        [pod_dict(labels={"app": "pref"},
                  spec_extra=pod_affinity("podAffinity", "pref", required=False, weight=100))],
        [60], {}, (), ("domain",),
    ),
    "domain-spread-plus-affinity": (
        zone_nodes(9, cpu=lambda i: "16", pods="12"),
        [pod_dict(labels={"app": "w"}, name="t0", spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 2, True, "w")],
            **pod_affinity("podAffinity", "w", required=False)}),
         pod_dict(labels={"app": "lone"}, name="t1",
                  spec_extra=pod_affinity("podAntiAffinity", "w"))],
        [50, 6], {}, (), ("domain",),
    ),
    "domain-pure-anti-symmetry": (
        zone_nodes(9, pods="10"),
        [pod_dict(labels={"app": "lone"}, name="t1",
                  spec_extra=pod_affinity("podAntiAffinity", "w")),
         pod_dict(labels={"app": "w"}, name="t0")],
        [2, 40], {}, (), ("domain",),
    ),
}


@pytest.mark.parametrize("name", list(FAST_CASES))
def test_fast_cases_match_jax(name):
    nodes, pods, counts, kw, bound, routes = FAST_CASES[name]
    deltas, _ = assert_same_schedule(*encode_both(nodes, pods, counts, bound), **kw)
    for r in routes:
        assert deltas[r] >= 1, (r, deltas)


# name: (nodes, template, count, kwargs); the JAX tests run each through the
# domain path and, with DM_CAP = 0, the micro body
SPREAD_CASES = {
    "soft": (
        zone_nodes(9, cpu=lambda i: "8", pods="10"),
        pod_dict(labels={"app": "soft"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 3, False, "soft")]}),
        100, {},
    ),
    "hard-plus-soft": (
        zone_nodes(9, cpu=lambda i: "4" if i < 3 else "32"),
        pod_dict(labels={"app": "hard"}, spec_extra={"topologySpreadConstraints": [
            spread(ZONE, 1, True, "hard"), spread(ZONE, 4, False, "hard")]}),
        120, {},
    ),
    "hard-only": (
        zone_nodes(6, pods="10"),
        pod_dict(labels={"app": "ho"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 2, True, "ho")]}),
        70, {},
    ),
    "two-keys": SCENARIOS["two-keys"][:3] + ({},),
    "eligibility-split": SCENARIOS["eligibility-split"][:3] + ({},),
    "missing-key-nodes": (
        [node_dict(f"n-{i}", cpu="32", pods="10", labels={ZONE: f"z-{i % 3}"} if i < 6 else {})
         for i in range(9)],
        pod_dict(labels={"app": "ho"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 2, True, "ho")]}),
        80, {},
    ),
    "with-host-ports": (
        zone_nodes(6, pods="20"),
        pod_dict(labels={"app": "hp"}, spec_extra={
            **host_port("500m", "512Mi"), "topologySpreadConstraints": [spread(ZONE, 2, False, "hp")]}),
        10, {},
    ),
    "filter-disabled-profile": (
        zone_nodes(6, pods="10"),
        pod_dict(labels={"app": "nf"}, spec_extra={
            "topologySpreadConstraints": [spread(ZONE, 1, True, "nf")]}),
        40, {"filter_on": _fo(F_SPREAD)},
    ),
}


@pytest.fixture(params=["domain", "micro"])
def spread_route(request, monkeypatch):
    """Both spread strategies: the domain path, and the micro body forced by
    DM_CAP = 0 in both packages."""
    if request.param == "micro":
        monkeypatch.setattr(jfast, "DM_CAP", 0)
        monkeypatch.setattr(tfast, "DM_CAP", 0)
    return request.param


@pytest.mark.parametrize("name", list(SPREAD_CASES))
def test_spread_cases_match_jax(name, spread_route):
    nodes, pod, count, kw = SPREAD_CASES[name]
    deltas, _ = assert_same_schedule(*encode_both(nodes, [pod], [count]), **kw)
    assert deltas[spread_route] == 1, deltas


def test_domain_cap_falls_back_to_micro(monkeypatch):
    """More combined classes than DM_CAP: the micro scan, in both packages."""
    monkeypatch.setattr(jfast, "DM_CAP", 4)
    monkeypatch.setattr(tfast, "DM_CAP", 4)
    nodes = [node_dict(f"n-{i}", cpu="8", pods="10", labels={ZONE: f"z-{i}"}) for i in range(8)]
    pod = pod_dict(labels={"app": "many"}, spec_extra={
        "topologySpreadConstraints": [spread(ZONE, 5, False, "many")]})
    deltas, _ = assert_same_schedule(*encode_both(nodes, [pod], [90]))
    assert deltas["micro"] == 1 and deltas["domain"] == 0, deltas


@pytest.mark.parametrize("chunk", [32, 40])
def test_light_scan_chunks_match_jax(chunk):
    """A group longer than max_group_chunk: the scan runs in chunks threading
    x through, the grouped route in chunks threading the carry; a chunk that
    is not a multiple of the bucket (40) keeps the reference's semantics."""
    nodes = zone_nodes(6, pods="30")
    pods = [
        pod_dict(labels={"app": "h"}, spec_extra={"topologySpreadConstraints": [
            spread(HOST, 2, False, "h")]}),
        pod_dict(cpu="250m", labels={"app": "g"}, name="g"),
    ]
    deltas, _ = assert_same_schedule(
        *encode_both(nodes, pods, [100, 50]), max_group_chunk=chunk, force_fast=False,
    )
    assert deltas["scan"] == 1 and deltas["grouped"] == 1, deltas


def test_plugins_route_everything_through_grouped():
    """Out-of-tree filter and score plugins send every group through the
    grouped scan, with the plugin's verdict in the F_EXTRA slot."""
    import jax.numpy as jnp
    import torch

    nodes = zone_nodes(6, pods="15")
    pods = [pod_dict(cpu="250m", labels={"app": "x"}, spec_extra={
        "topologySpreadConstraints": [spread(ZONE, 2, False, "x")]})]
    jax_state, port_state = encode_both(nodes, pods, [120])
    before_j, before_t = dict(jfast.PATH_COUNTS), dict(tfast.PATH_COUNTS)
    want = jfast.schedule_batch_fast(
        *jax_state, jax_weights(), force_fast=True,
        extra_filters=(lambda ns, c, p: jnp.arange(ns.valid.shape[0]) % 5 != 1,),
        extra_scores=((lambda ns, c, p: c.free[:, 0] * 0.001, 3.0),),
    )
    got = tfast.schedule_batch_fast(
        *port_state, torch_weights(device="cpu"), force_fast=True, device="cpu",
        extra_filters=(lambda ns, c, p: torch.arange(ns.valid.shape[0]) % 5 != 1,),
        extra_scores=((lambda ns, c, p: c.free[:, 0] * 0.001, 3.0),),
    )
    assert headline.placement_digest(*want) == headline.placement_digest(*got)
    assert tfast.PATH_COUNTS["grouped"] - before_t["grouped"] == 1
    assert jfast.PATH_COUNTS["grouped"] - before_j["grouped"] == 1
    assert (got[2][:120, 10] > 0).any()  # the plugin's filter failed nodes


@pytest.mark.slow
def test_headline_digest_full_size_on_cpu():
    """The port's CPU run of the full headline (10,000 nodes, 100,000 pods)
    reproduces the digest the JAX package computes."""
    result = tfast.schedule_batch_fast(
        *headline.build_state(10_000, 100_000, device="cpu"),
        torch_weights(device="cpu"), device="cpu",
    )
    assert headline.placement_digest(*result) == headline.HEADLINE_DIGEST_100K_10K


@pytest.mark.slow
def test_headline_digest_constant_is_the_jax_result():
    """HEADLINE_DIGEST_100K_10K is what the JAX package's schedule_batch_fast
    gives on its own bench.build_state(10000, 100000)."""
    from bench import build_state

    result = jfast.schedule_batch_fast(*build_state(10_000, 100_000), jax_weights())
    assert headline.placement_digest(*result) == headline.HEADLINE_DIGEST_100K_10K


@pytest.mark.slow
@pytest.mark.parametrize("name", bench_configs.WORKLOADS)
def test_workload_digest_full_size_on_cpu(name):
    """Each bench_configs workload at full size through the port on the CPU
    reproduces its digest constant and route counts."""
    before = dict(tfast.PATH_COUNTS)
    result = tfast.schedule_batch_fast(
        *bench_configs.build_state(name, device="cpu"), torch_weights(device="cpu"), device="cpu",
    )
    assert headline.placement_digest(*result) == bench_configs.DIGESTS[name]
    deltas = {k: tfast.PATH_COUNTS[k] - before[k] for k in bench_configs.PATHS[name]}
    assert deltas == bench_configs.PATHS[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", bench_configs.WORKLOADS)
def test_workload_digest_constant_is_the_jax_result(name):
    """DIGESTS and PATHS are what the JAX package's schedule_batch_fast gives
    on the same workload dicts."""
    jax_state, _ = encode_both(*bench_configs.workload(name))
    before = dict(jfast.PATH_COUNTS)
    result = jfast.schedule_batch_fast(*jax_state, jax_weights())
    assert headline.placement_digest(*result) == bench_configs.DIGESTS[name]
    deltas = {k: jfast.PATH_COUNTS[k] - before[k] for k in before}
    assert {k: v for k, v in deltas.items() if v} == bench_configs.PATHS[name]
