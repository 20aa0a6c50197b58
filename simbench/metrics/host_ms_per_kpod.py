"""engine.simulator's host phases (expand-workloads, encode-cluster,
encode, bind, decode-result): each window call's `simulate` span less its
`schedule` spans, summed, in ms per 1,000 pods decided."""


def read(r):
    pods = sum(c.pods for c in r.calls)
    if not pods:
        return None
    host = sum(c.simulate_s - c.schedule_s for c in r.calls)
    return host * 1e3 / (pods / 1e3)
