"""The port's schedule_batch_fast against the JAX package's, on the CPU.

Each scenario encodes the same node/pod dicts with both packages, schedules
the batch with both fast paths (force_fast=True) and demands exact equality
of placements, failure reasons, GPU/VG/device takes and every carry leaf.
The domain groups run the pop loop's plain version (tensors on the CPU).
"""

import numpy as np
import pytest

from open_simulator_tpu.core import objects as jobj
from open_simulator_tpu.ops import encode as jenc
from open_simulator_tpu.ops import state as jstate
from open_simulator_tpu.ops.fast import schedule_batch_fast as jax_fast
from open_simulator_tpu.ops.kernels import weights_array as jax_weights
from open_simulator_tpu.ops.tile import tile_pod_batch as jax_tile
from open_simulator_tpu_torch import headline
from open_simulator_tpu_torch.core import objects as tobj
from open_simulator_tpu_torch.ops import encode as tenc
from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.ops import state as tstate
from open_simulator_tpu_torch.ops.kernels import weights_array as torch_weights
from open_simulator_tpu_torch.ops.tile import tile_pod_batch as torch_tile

ZONE = "topology.kubernetes.io/zone"


def node_dict(name, cpu="16", mem="32Gi", pods="16", labels=None):
    return {
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name, **(labels or {})}},
        "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": pods}},
    }


def pod_dict(cpu="500m", mem="512Mi", labels=None, spec_extra=None):
    spec = {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
    spec.update(spec_extra or {})
    return {
        "metadata": {"name": "t", "namespace": "fast", "labels": labels or {}},
        "spec": spec,
    }


def spread(key, skew, hard, app):
    return {
        "maxSkew": skew, "topologyKey": key,
        "whenUnsatisfiable": "DoNotSchedule" if hard else "ScheduleAnyway",
        "labelSelector": {"matchLabels": {"app": app}},
    }


def encode_both(node_dicts, pod_dicts, counts):
    """(JAX state, port state on the CPU) from the same dicts."""
    out = []
    for objs, enc_mod, st, tile, kw in (
        (jobj, jenc, jstate, jax_tile, {}),
        (tobj, tenc, tstate, torch_tile, {"device": "cpu"}),
    ):
        templates = [objs.Pod.from_dict(d) for d in pod_dicts]
        enc = enc_mod.Encoder()
        enc.register_pods(templates)
        table = enc_mod.encode_nodes(enc, [objs.Node.from_dict(d) for d in node_dicts])
        batch = tile(enc_mod.encode_pods(enc, templates), counts)
        ns = st.node_static_from_table(enc, table, **kw)
        carry = st.carry_from_table(table, enc_mod.initial_selector_counts(enc, table, []), **kw)
        out.append((ns, carry, batch))
    return out


def assert_same_schedule(jax_state, port_state):
    """Schedule with both packages; exact equality everywhere. Returns the
    PATH_COUNTS deltas of the port."""
    before = dict(tfast.PATH_COUNTS)
    want = jax_fast(*jax_state, jax_weights(), force_fast=True)
    got = tfast.schedule_batch_fast(
        *port_state, torch_weights(device="cpu"), force_fast=True, device="cpu"
    )
    for name, a, b in zip(("nodes", "reasons", "take", "vg", "dev"), want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        assert np.asarray(a).dtype == b.dtype, name
    for f in want[0]._fields:
        a, b = np.asarray(getattr(want[0], f)), getattr(got[0], f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f"carry field {f}")
    assert headline.placement_digest(*want) == headline.placement_digest(*got)
    return {k: tfast.PATH_COUNTS[k] - before[k] for k in before}, got


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
            "containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}},
                            "ports": [{"containerPort": 80, "hostPort": 8080}]}],
            "topologySpreadConstraints": [spread(ZONE, 2, False, "hp")]}),
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
    """A hostname-keyed spread group needs the light scan, which this port
    does not cover: it raises and names the ROADMAP item."""
    nodes = zone_nodes(6)
    pod = pod_dict(labels={"app": "h"}, spec_extra={"topologySpreadConstraints": [
        spread("kubernetes.io/hostname", 1, False, "h")]})
    _, port_state = encode_both(nodes, [pod], [40])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfast.schedule_batch_fast(
            *port_state, torch_weights(device="cpu"), force_fast=True, device="cpu"
        )


def test_affinity_group_raises():
    nodes = zone_nodes(6)
    pod = pod_dict(labels={"app": "a"}, spec_extra={"affinity": {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": "a"}}, "topologyKey": ZONE}]}}})
    _, port_state = encode_both(nodes, [pod], [40])
    with pytest.raises(NotImplementedError, match="affinity"):
        tfast.schedule_batch_fast(
            *port_state, torch_weights(device="cpu"), force_fast=True, device="cpu"
        )


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

    result = jax_fast(*build_state(10_000, 100_000), jax_weights())
    assert headline.placement_digest(*result) == headline.HEADLINE_DIGEST_100K_10K
