"""The benchmark's side of the program under test: the PyTorch/CUDA port
(`open_simulator_tpu_torch`). Everything the harness takes from the
program goes through here: the entry `simulate()`, the inputs it takes,
its result read back as plain data, its spans and its route counters."""

from __future__ import annotations

import importlib
from typing import List, Sequence, Tuple

from .reference.compare import Answer

PACKAGE = "open_simulator_tpu_torch"
WORKLOAD_ANNOTATION = "simon/workload-name"
GPU_INDEX_ANNOTATION = "alibabacloud.com/gpu-index"


def port(module: str):
    """A module of the port, e.g. port("engine.simulator")."""
    return importlib.import_module(f"{PACKAGE}.{module}")


def cluster(node_manifests: Sequence[dict]):
    """The ClusterResource of the node manifests."""
    return port("engine.simulator").ClusterResource.from_objects(node_manifests)


def apps(call_apps: Sequence[Tuple[str, List[dict]]]):
    """The AppResources of one call."""
    sim = port("engine.simulator")
    return [sim.AppResource(name=name, objects=objs) for name, objs in call_apps]


def simulate(cluster_res, app_res, device: str):
    """One `simulate()` call with default weights and no expansion cache."""
    return port("engine.simulator").simulate(cluster_res, app_res, device=device,
                                             expand_cache=None)


def _workload(pod) -> str:
    return pod.meta.annotations.get(WORKLOAD_ANNOTATION, "")


def answer(result) -> Answer:
    """The SimulateResult as plain data, pods identified by workload."""
    binds = {
        st.node.name: [(_workload(p), p.meta.annotations.get(GPU_INDEX_ANNOTATION, ""))
                       for p in st.pods]
        for st in result.node_status
    }
    unscheduled = [(_workload(u.pod), u.reason) for u in result.unscheduled]
    return Answer(binds=binds, unscheduled=unscheduled)


def decided(result) -> int:
    """Pods the result placed or reported unschedulable."""
    return sum(len(st.pods) for st in result.node_status) + len(result.unscheduled)


def path_counts() -> dict:
    """A copy of the schedule engine's route counters."""
    return dict(port("ops.fast").PATH_COUNTS)


def recent_roots() -> list:
    """The port's recent root span trees, oldest first."""
    return port("utils.tracing").recent_timings()
