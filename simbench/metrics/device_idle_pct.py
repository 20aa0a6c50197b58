"""The device: 100 x (1 - the union of the device's operation intervals
over the profiled window of whole calls / that window)."""

from .gaps import busy


def read(r):
    p = r.profile
    if p is None or p.hi <= p.lo:
        return None
    work = busy(((s, s + d) for _, s, d in p.events), p.lo, p.hi)
    return 100.0 * (1.0 - work / (p.hi - p.lo))
