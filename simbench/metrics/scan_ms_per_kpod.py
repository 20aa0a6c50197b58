"""ops.fast's light scan: the profiled call's `select.scan` spans (the
scan's per-pod steps of each group, launched from the host), in ms per
1,000 pods decided."""

from .spans import ms_per_kpod


def read(r):
    return ms_per_kpod(r, ("select.scan",))
