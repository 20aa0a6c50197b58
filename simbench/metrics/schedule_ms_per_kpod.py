"""ops.fast's schedule engine: the window calls' `schedule` spans, summed,
in ms per 1,000 pods decided."""


def read(r):
    pods = sum(c.pods for c in r.calls)
    if not pods:
        return None
    return sum(c.schedule_s for c in r.calls) * 1e3 / (pods / 1e3)
