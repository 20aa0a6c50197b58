"""The light scan's dispatch: the CUDA kernels (copies and sets left out)
whose start lies inside one of the profiled call's `select.scan` windows,
per pod the call decided."""

from .scan_windows import kernels_in, windows


def read(r):
    p = r.profile
    wins = windows(p)
    if not wins or not p.pods:
        return None
    return kernels_in(p, wins) / p.pods
