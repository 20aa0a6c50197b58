"""The readers of single host phases on synthetic profiles."""

import pytest

from simbench import run
from simbench.trace import Profile, Readings


@pytest.mark.parametrize("metric, names", [
    ("construct_ms_per_kpod", ("construct",)),
    ("expand_ms_per_kpod", ("expand",)),
    ("validate_ms_per_kpod", ("validate",)),
    ("bind_ms_per_kpod", ("bind-placed", "reasons")),
])
def test_host_phase_readers_sum_their_spans(metric, names):
    read = run.reader(metric)
    # each named span twice, 3 ms and 5 ms, beside spans of other names,
    # over 2,000 pods: 8 ms per named span, per 2 kpods
    spans = [("simulate", 0, 100_000_000, 0), ("bind", 10, 20, 1), ("expand-workloads", 0, 9, 1)]
    for k, name in enumerate(names):
        spans += [(name, 1_000 * k, 1_000 * k + 3_000_000, 2),
                  (name, 50_000_000, 55_000_000, 2)]
    p = Profile(lo=0, hi=100_000_000, pods=2_000, spans=spans)
    assert read(Readings(profile=p)) == pytest.approx(4.0 * len(names))
    # no profile, or a profile without the span (a program older than the span):
    # nothing, never 0
    assert read(Readings()) is None
    assert read(Readings(profile=Profile(lo=0, hi=1, pods=2_000, spans=spans[:3]))) is None
