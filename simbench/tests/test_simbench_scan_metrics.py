"""The light scan's readers on hand-built profiles: the `select.scan`
windows, the kernels charged to them by their start, the device's busy
time clipped to them, and nothing without a profile or a scan span."""

import pytest

from simbench import run
from simbench.metrics import scan_windows
from simbench.trace import Profile, Readings

MS = 1_000_000

# two scan windows, [10, 20) and [40, 50) ms, inside a 100 ms call of 2,000
# pods, beside spans of other names (a micro select among them)
SPANS = [("simulate", 0, 100 * MS, 0), ("schedule", 5 * MS, 60 * MS, 1),
         ("select.scan", 10 * MS, 20 * MS, 3), ("tail", 20 * MS, 22 * MS, 3),
         ("select.micro", 30 * MS, 35 * MS, 3), ("select.scan", 40 * MS, 50 * MS, 3)]

EVENTS = [
    ("fill_kernel", 1 * MS, MS),             # before every window
    ("add_kernel", 10 * MS, 2 * MS),         # first window, [10, 12)
    ("Memcpy HtoD (Pageable -> Device)", 11 * MS, 1 * MS),  # a copy: busy, not a kernel
    ("argmax_kernel", 15 * MS, MS),          # [15, 16)
    ("index_kernel", 19 * MS, 3 * MS),       # starts inside, runs to 22: clipped at 20
    ("tail_kernel", 20 * MS, MS),            # starts at the window's end: outside
    ("micro_kernel", 31 * MS, MS),           # in select.micro: outside
    ("late_kernel", 38 * MS, 4 * MS),        # starts before the second window: busy from 40 to 42
    ("Memset (Device)", 45 * MS, MS),        # a set: busy, not a kernel
    ("where_kernel", 49 * MS, MS),           # [49, 50)
]


def _readings(spans=SPANS, events=EVENTS, pods=2_000):
    return Readings(profile=Profile(lo=0, hi=100 * MS, pods=pods, events=list(events),
                                    spans=list(spans)))


def test_windows_are_the_scan_spans_in_order():
    p = _readings(spans=list(reversed(SPANS))).profile
    assert scan_windows.windows(p) == [(10 * MS, 20 * MS), (40 * MS, 50 * MS)]
    assert scan_windows.windows(None) == []


def test_scan_ms_per_kpod_sums_the_scan_spans():
    # 10 + 10 ms over 2 kpods
    assert run.reader("scan_ms_per_kpod")(_readings()) == pytest.approx(10.0)


def test_kernels_are_charged_by_their_start():
    p = _readings().profile
    wins = scan_windows.windows(p)
    # add, argmax, index in the first window, where in the second; fill,
    # tail, micro and late start outside, and copies and sets are no kernels
    assert scan_windows.kernels_in(p, wins) == 4
    assert run.reader("scan_kernels_per_pod")(_readings()) == pytest.approx(4 / 2_000)


def test_busy_time_is_clipped_to_the_windows():
    p = _readings().profile
    wins = scan_windows.windows(p)
    # first window: [10, 12) add and copy overlapping, [15, 16), [19, 20)
    # of index: 4 ms; second: [40, 42) of late, [45, 46), [49, 50): 4 ms
    assert scan_windows.busy_in(p, wins) == 8 * MS
    assert run.reader("scan_busy_pct")(_readings()) == pytest.approx(100.0 * 8 / 20)


@pytest.mark.parametrize("metric", ["scan_ms_per_kpod", "scan_kernels_per_pod", "scan_busy_pct"])
def test_nothing_without_a_profile_or_a_scan_span(metric):
    read = run.reader(metric)
    assert read(Readings()) is None
    no_scan = [s for s in SPANS if s[0] != "select.scan"]
    assert read(_readings(spans=no_scan)) is None
    # a scan span but no device event at all still reads (0 kernels, 0 busy)
    assert read(_readings(events=[])) is not None
