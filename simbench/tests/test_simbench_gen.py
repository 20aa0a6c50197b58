"""The generator: deterministic per seed, and the sizes the cells cite."""

from collections import Counter

import numpy as np
import pytest

from simbench import gen
from simbench.reference import quantity

BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("name", ["zonal_5k", "pai_gpu"])
def test_cluster_is_deterministic_per_seed(name):
    cfg = gen.load("configs", name)
    assert gen.cluster(cfg, BIG_SEED) == gen.cluster(cfg, BIG_SEED)
    assert gen.cluster(cfg, BIG_SEED) != gen.cluster(cfg, BIG_SEED + 1)


@pytest.mark.parametrize("name", ["bulk", "share"])
def test_calls_are_deterministic_and_differ(name):
    tr = gen.load("traffic", name)
    a = gen.call_apps(tr, BIG_SEED, 3)
    assert a == gen.call_apps(tr, BIG_SEED, 3)
    assert a != gen.call_apps(tr, BIG_SEED, 4)
    assert a != gen.call_apps(tr, BIG_SEED, -1)


def test_zonal_5k_sizes():
    nodes = gen.cluster(gen.load("configs", "zonal_5k"), 7)
    assert len(nodes) == 5000
    zones = Counter(n["metadata"]["labels"]["topology.kubernetes.io/zone"] for n in nodes)
    assert sorted(zones.values()) == [1666, 1667, 1667]
    cpus = Counter(n["status"]["allocatable"]["cpu"] for n in nodes)
    assert set(cpus) == {"16", "32", "48"} and max(cpus.values()) - min(cpus.values()) <= 1
    assert all(n["status"]["allocatable"]["pods"] == "110" for n in nodes)
    tainted = [i for i, n in enumerate(nodes) if n["spec"].get("taints")]
    assert len(tainted) == 500 and all(i % 10 == 0 for i in tainted)


def test_bulk_calls_hold_150k_pods_in_4_deployments():
    tr = gen.load("traffic", "bulk")
    for call in range(6):
        apps = gen.call_apps(tr, BIG_SEED, call)
        reps = [objs[0]["spec"]["replicas"] for _, objs in apps]
        assert len(apps) == 4 and sum(reps) == 150_000
        assert all(abs(r - 37_500) <= 750 for r in reps)
        assert all(name.endswith(f"-c{call}") for name, _ in apps)


def test_pai_gpu_sizes():
    nodes = gen.cluster(gen.load("configs", "pai_gpu"), 7)
    assert len(nodes) == 1800
    gpus = [int(n["status"]["capacity"]["alibabacloud.com/gpu-count"]) for n in nodes]
    assert sum(gpus) == 6600 and Counter(gpus) == {8: 500, 2: 1300}
    for n in nodes:
        cap = n["status"]["capacity"]
        per = quantity.canonical("alibabacloud.com/gpu-mem", cap["alibabacloud.com/gpu-mem"]) // int(
            cap["alibabacloud.com/gpu-count"])
        assert per == 16 * 2**30


def _traj_bound(nodes, cpu, mem):
    """The trajectory length the port gives a group of pods of this size on
    an empty cluster (ops/fast.py:_traj_len): the most commits any node can
    absorb, plus 2."""
    best = 0
    for n in nodes:
        a = n["status"]["allocatable"]
        caps = [quantity.canonical("cpu", a["cpu"]) // quantity.canonical("cpu", cpu),
                quantity.canonical("memory", a["memory"]) // quantity.canonical("memory", mem),
                int(a["pods"])]
        best = max(best, min(caps))
    return best + 2


def test_share_calls_take_the_light_scan_by_size():
    tr = gen.load("traffic", "share")
    nodes = gen.cluster(gen.load("configs", "pai_gpu"), 7)
    slot = gen.slots(tr)[0]
    bound = _traj_bound(nodes, slot["cpu"], slot["memory"])
    for call in range(6):
        apps = gen.call_apps(tr, BIG_SEED, call)
        assert len(apps) == 12
        total = 0
        for _, objs in apps:
            d = objs[0]
            reps = d["spec"]["replicas"]
            total += reps
            assert reps >= 64 and reps >= 1.5 * bound
            ann = d["spec"]["template"]["metadata"]["annotations"]
            assert ann["alibabacloud.com/gpu-count"] == "1"
            assert ann["alibabacloud.com/gpu-mem"] in ("4Gi", "8Gi", "16Gi")
        assert total == 2048
    mix = Counter(tr["per_call"]["gpu_mem"])
    assert np.isclose(mix["4Gi"] / 12, 0.4, atol=0.03) and np.isclose(mix["16Gi"] / 12, 0.2, atol=0.04)


def test_check_pool_is_drawn_from_the_seed():
    bulk, share = gen.load("traffic", "bulk"), gen.load("traffic", "share")
    pool = gen.check_pool(bulk, BIG_SEED)
    assert len(pool) == 1 and pool <= {0, 1}
    assert gen.check_pool(share, BIG_SEED) is None
    assert gen.sample_calls(None, 3) == [0, 1, 2]
    assert gen.sample_calls({1}, 1) == [0]
    assert gen.sample_calls({1}, 0) == []


def test_one_app_holds_every_workload():
    tr = dict(gen.load("traffic", "bulk"), apps="one_app")
    apps = gen.call_apps(tr, BIG_SEED, 2)
    assert len(apps) == 1 and apps[0][0] == "apps-c2" and len(apps[0][1]) == 4
