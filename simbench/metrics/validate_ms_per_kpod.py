"""core.validation: the profiled call's `validate` spans (check_pods over
each app's new pods), in ms per 1,000 pods decided."""

from .spans import ms_per_kpod


def read(r):
    return ms_per_kpod(r, ("validate",))
