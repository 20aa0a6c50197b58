"""engine.simulator's constructor: the profiled call's `construct` span
(the Simulator built inside simulate()), in ms per 1,000 pods decided."""

from .spans import ms_per_kpod


def read(r):
    return ms_per_kpod(r, ("construct",))
