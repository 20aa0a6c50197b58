"""The GPU-share path of the benchmark's `pai_gpu.share` cell, on the CPU:
the port's `simulate(device="cpu")` against the benchmark's plain reference
(`simbench/reference/sched.py`), compared by `simbench/reference/compare.py`
with every one of its seven counts 0: pods undecided or misplaced, bind
order, GPU index, failure reasons, allocation and overcommit.

The cluster is the `pai_gpu` configuration cut to a few dozen nodes of both
GPU types (8 x 16 GiB and 2 x 16 GiB), and the traffic its `share` mix
scaled down; the generator and shapes are the cell's. Cases: four seeds of
the cell's own mix; shares of 2 and 4 GPUs a pod (the reference's
prefix-fill branch of the device take); a cluster too small for the
backlog (GPU failure reasons); and the route every share group takes, the
light scan with GPU dynamics, read from its `select.scan` span.
"""

import copy

import pytest
import torch

from open_simulator_tpu_torch.ops import fast as tfast
from open_simulator_tpu_torch.utils import tracing as ttracing
from simbench import gen, program
from simbench.reference import compare, sched
from simbench.tests import small

torch.set_num_threads(1)  # tiny tensors: threads only add contention

SEED = 2**31 + 19
ZERO = dict.fromkeys(compare.LIMITS, 0)


def _traffic(scale, gpu_count=None):
    tr = small.traffic("share", scale)
    if gpu_count is not None:
        for w in tr["workloads"]:
            w["gpu_count"] = str(gpu_count)
    return tr


def _judge(nodes, call_apps):
    """(the seven counts, the reference's result) of one call."""
    res = program.simulate(program.cluster(nodes), program.apps(copy.deepcopy(call_apps)), "cpu")
    ref = sched.schedule(nodes, call_apps)
    return compare.judge(program.answer(res), ref), ref


def _gpu_indexes(ref):
    return [g for node in ref.binds for _, g in node if g]


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 7, 2**33 + 5])
def test_share_mix_equals_the_reference(seed):
    """90 nodes (25 of 8 GPUs, 65 of 2), 712 pods in 12 groups: the five
    of 64 pods or more take the light scan, the rest the grouped scan, and
    the cluster places most of them, each with a GPU index."""
    nodes = gen.cluster(small.config("pai_gpu", 90), seed)
    counts, ref = _judge(nodes, gen.call_apps(_traffic(0.35), seed, 0))
    assert counts == ZERO
    placed = [p for p in ref.pods if p[1] >= 0]
    assert len(ref.pods) == 712 and len(_gpu_indexes(ref)) == len(placed) > 600


@pytest.mark.parametrize("gpu_count", [2, 4])
def test_multi_gpu_shares_equal_the_reference(gpu_count):
    """Pods of 2 and 4 shares: the device take fills the node's GPUs in
    order (a prefix fill), so indexes such as "0-1" or "0-0-1-1" appear."""
    nodes = gen.cluster(small.config("pai_gpu", 64), SEED)
    counts, ref = _judge(nodes, gen.call_apps(_traffic(0.3, gpu_count), SEED, 1))
    assert counts == ZERO
    idx = _gpu_indexes(ref)
    assert idx and all(len(g.split("-")) == gpu_count for g in idx)


@pytest.mark.parametrize("seed", [SEED, 11])
def test_a_cluster_too_small_fails_on_gpu_memory_as_the_reference(seed):
    """12 nodes under about 700 pods: most fail, and their failure counts,
    GPU memory among them, equal the reference's."""
    nodes = gen.cluster(small.config("pai_gpu", 12), seed)
    counts, ref = _judge(nodes, gen.call_apps(_traffic(0.35), seed, 2))
    assert counts == ZERO
    failed = [c for _, n, _, c in ref.pods if n < 0]
    gpu = sched.MESSAGES.index("node(s) didn't have enough free GPU memory")
    assert len(failed) > 300 and any(c[gpu] > 0 for c in failed)
    assert _gpu_indexes(ref)


@pytest.mark.parametrize("seed", [SEED, 5])
def test_every_share_group_takes_the_light_scan_with_gpu_dynamics(seed):
    """At a size where every group has 64 pods or more, each of the 12
    groups takes the `scan` route, a step per pod, and its `select.scan`
    span has `dyn` ["gpu"] and, on the CPU, `kernel` 0."""
    nodes = gen.cluster(small.config("pai_gpu", 90), seed)
    call_apps = gen.call_apps(_traffic(0.7), seed, 0)
    ttracing._history.clear()
    before = dict(tfast.PATH_COUNTS)
    res = program.simulate(program.cluster(nodes), program.apps(copy.deepcopy(call_apps)), "cpu")
    delta = {k: v - before[k] for k, v in tfast.PATH_COUNTS.items() if v != before[k]}
    assert delta == {"scan": 12}
    (root,) = ttracing.recent_timings()
    groups = [g for s in root["children"] if s["name"] == "schedule"
              for g in s["children"] if g["name"] == "group"]
    assert len(groups) == 12
    for g in groups:
        (sel,) = [c for c in g["children"] if c["name"].startswith("select.")]
        assert g["meta"]["route"] == "scan" and sel["name"] == "select.scan"
        assert g["meta"]["steps"] == g["meta"]["pods"] and sel["meta"] == {"dyn": ["gpu"], "kernel": 0}
    assert compare.judge(program.answer(res), sched.schedule(nodes, call_apps)) == ZERO
