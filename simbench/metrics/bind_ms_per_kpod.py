"""engine.simulator's bind: the profiled call's `bind-placed` spans (each
placed pod recorded on the host) and `reasons` spans (each unschedulable
pod's reason string and the filter counts), in ms per 1,000 pods decided."""

from .spans import ms_per_kpod


def read(r):
    return ms_per_kpod(r, ("bind-placed", "reasons"))
