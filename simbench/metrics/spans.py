"""Named spans of the profiled call, summed, in ms per 1,000 pods decided:
the arithmetic of the readers of single host phases."""


def ms_per_kpod(r, names) -> float | None:
    """The profiled call's spans named in `names`, summed, per 1,000 of its
    pods; None without a profile or without such a span."""
    p = r.profile
    if p is None or not p.pods:
        return None
    ns = [end - start for name, start, end, _ in p.spans if name in names]
    if not ns:
        return None
    return sum(ns) / 1e6 / (p.pods / 1e3)
