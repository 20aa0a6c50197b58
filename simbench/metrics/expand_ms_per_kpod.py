"""core.workloads' expansion: the profiled call's `expand` spans (each
app's workloads made into pods: prototypes, `pod-names`, `pod-clones`), in
ms per 1,000 pods decided."""

from .spans import ms_per_kpod


def read(r):
    return ms_per_kpod(r, ("expand",))
