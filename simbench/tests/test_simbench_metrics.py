"""The metric arithmetic on synthetic inputs."""

import pytest

from simbench import run
from simbench.metrics import gaps, pop_count
from simbench.trace import CallSpans, Profile, Readings, breakdown, call_spans


def test_union_busy_and_idle():
    iv = [(10, 30), (20, 40), (60, 70), (65, 68), (90, 120)]
    assert gaps.union(iv, 0, 100) == [(10, 40), (60, 70), (90, 100)]
    assert gaps.busy(iv, 0, 100) == 50
    assert gaps.idle(iv, 0, 100) == [(0, 10), (40, 60), (70, 90)]
    assert gaps.busy(iv, 25, 62) == 17
    assert gaps.idle([], 5, 9) == [(5, 9)]


def test_call_spans_take_schedule_spans_at_any_depth():
    root = {"name": "simulate", "duration_s": 2.0, "children": [
        {"name": "expand-workloads", "duration_s": 0.3},
        {"name": "encode", "duration_s": 0.1},
        {"name": "schedule", "duration_s": 0.5, "children": [{"name": "x", "duration_s": 0.1}]},
        {"name": "wrapper", "duration_s": 0.4, "children": [{"name": "schedule", "duration_s": 0.25}]},
    ]}
    c = call_spans(root, 1000)
    assert c.simulate_s == 2.0 and c.schedule_s == pytest.approx(0.75) and c.pods == 1000


def test_per_kpod_sums_over_the_window():
    r = Readings(calls=[CallSpans(1000, 2.0, 0.5), CallSpans(3000, 4.0, 1.0)])
    # host (1.5 + 3.0) s and schedule 1.5 s over 4,000 pods
    assert run.reader("host_ms_per_kpod")(r) == pytest.approx(1125.0)
    assert run.reader("schedule_ms_per_kpod")(r) == pytest.approx(375.0)
    assert run.reader("host_ms_per_kpod")(Readings()) is None


def _profile(events, launches=(), pods=10):
    return Profile(lo=0, hi=100, pods=pods, events=list(events), launches=list(launches),
                   spans=[("simulate", 0, 100, 0), ("schedule", 50, 80, 1)])


def test_kernels_per_pod_and_idle_share():
    ev = [("k1", 10, 20), ("k2", 20, 20), ("Memcpy HtoD (Pageable -> Device)", 60, 10),
          ("Memset (Device)", 65, 3), ("k3", 95, 20)]
    p = _profile(ev)
    r = Readings(profile=p)
    assert run.reader("kernels_per_pod")(r) == pytest.approx(0.3)
    # busy [10,40) + [60,70) + [95,100) = 45 of 100
    assert run.reader("device_idle_pct")(r) == pytest.approx(55.0)
    assert run.reader("device_idle_pct")(Readings()) is None
    b = breakdown(p)
    assert b["device_ops"][:2] == [["k1", 20 / 1e9], ["k2", 20 / 1e9]]
    # gaps [0,10) and [70,95) fall in simulate, [40,60) in schedule
    assert dict(b["idle_gaps"]) == pytest.approx({"idle in simulate": 35 / 1e9,
                                                  "idle in schedule": 20 / 1e9})


def _launch(placed=10):
    # hscore f32, hnode i32, hj i32 [Dc=4, L]; cap_eff, elig, combo_valid [4];
    # base_dom, in_key [C=2, D=4]; t_onehot [2,4,4]; match, soft, hard, skew [2];
    # has_key [2,4]
    counts = [4, 4, 4, 8, 8, 32, 2, 2, 2, 2, 8]
    return pop_count.Launch(tensors=[(4, 64)] * 3 + [(4, c) for c in counts],
                            dc=4, d=4, g=16, n_hard=0, placed=placed)


def test_domain_pop_count():
    nbytes, ops = pop_count.bytes_and_ops(_launch())
    # heads (4 + 10) x 12 bytes, the small tables 76 x 4, outputs 2 x 4 x 16
    assert nbytes == 168 + 304 + 128
    assert ops == 11 * 4 * 8
    t, by = pop_count.bound_s(_launch())
    assert by == "bytes" and t == pytest.approx(600 / 3.35e12)
    hard = pop_count.Launch(**dict(_launch().__dict__, n_hard=2))
    assert pop_count.bytes_and_ops(hard)[1] == 11 * (32 + 2 * (4 + 16))


def test_domain_pop_roofline_share_and_silence():
    read = run.reader("domain_pop_roofline_pct")
    p = _profile([("domain_pop_kernel(Params)", 10, 1000), ("other", 0, 5)], [_launch()])
    assert read(Readings(profile=p)) == pytest.approx(100 * (600 / 3.35e12) / 1e-6)
    # no launch, or no kernel in the capture: nothing, never 0
    assert read(Readings(profile=_profile([("other", 0, 5)]))) is None
    assert read(Readings(profile=_profile([("other", 0, 5)], [_launch()]))) is None
