"""The device under the light scan: 100 x the union of the device's
operations clipped to the profiled call's `select.scan` windows, over
those windows' total length."""

from .scan_windows import busy_in, windows


def read(r):
    wins = windows(r.profile)
    total = sum(hi - lo for lo, hi in wins)
    if total <= 0:
        return None
    return 100.0 * busy_in(r.profile, wins) / total
