"""The port's device-time profiling (utils/profiling.py) on the CPU: the
cases of tests/test_profiling.py for the dispatch-gap analyzer and the
trace capture (every entry timed; metrics and `device:<entry>` spans; the
time-weighted aggregate; fresh copies of written arguments; a trace into
its directory; a failing workload reported, not raised) and `simon profile
--format json` on injected captures. The reference's two bench cases wait
for the port's bench script. On the CPU no device time exists: device_ms
is 0 and dispatch_ms the whole call.
"""

import json

import pytest
import torch

from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.utils import metrics, profiling, tracing
from open_simulator_tpu_torch.utils.profiling import (
    DispatchGapReport,
    EntryTiming,
    analyze_dispatch_gaps,
    capture_device_trace,
)

torch.set_num_threads(1)  # tiny tensors: threads only add contention


class _Cap:
    """Minimal stand-in for a registry capture: .name/.fn/.args/.kwargs."""

    def __init__(self, name, fn, args=(), kwargs=None):
        self.name = name
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}


def _caps():
    return [
        _Cap("t:add", lambda a, b: a + b, (torch.ones(64), torch.ones(64))),
        _Cap("t:sum", lambda a: torch.sum(a * a), (torch.arange(128.0),)),
    ]


def test_analyze_dispatch_gaps_times_every_entry():
    rep = analyze_dispatch_gaps(captures=_caps(), repeats=2, device="cpu")
    assert [e.name for e in rep.entries] == ["t:add", "t:sum"]
    for e in rep.entries:
        assert e.total_ms > 0
        assert e.dispatch_ms >= 0 and e.device_ms >= 0
        assert 0.0 <= e.gap_ratio <= 1.0
        assert e.repeats == 2
        assert e.dispatch_ms + e.device_ms == pytest.approx(e.total_ms, rel=1e-6)
        assert e.device_ms == 0.0 and e.gap_ratio == 1.0  # no device on the CPU
    assert rep.device_time_ms == pytest.approx(sum(e.device_ms for e in rep.entries), abs=1e-4)


def test_analyze_publishes_metrics_and_device_spans():
    analyze_dispatch_gaps(captures=_caps(), repeats=1, device="cpu")
    assert metrics.DEVICE_TIME.value(entry="t:add") >= 0.0
    assert 0.0 <= metrics.DISPATCH_GAP.value(entry="t:sum") <= 1.0
    root = [r for r in tracing.recent_timings() if r["name"] == "dispatch-gap-analysis"][-1]
    dev = {c["name"]: c for c in root["children"]}
    assert "device:t:add" in dev and "device:t:sum" in dev
    meta = dev["device:t:sum"]["meta"]
    assert {"entry", "device_ms", "dispatch_ms", "gap_ratio"} <= set(meta)


def test_aggregate_gap_is_time_weighted_not_mean_of_ratios():
    rep = DispatchGapReport(
        entries=[
            EntryTiming("tiny", dispatch_ms=1.0, device_ms=0.0, total_ms=1.0, gap_ratio=1.0,
                        repeats=1),
            EntryTiming("big", dispatch_ms=0.0, device_ms=99.0, total_ms=99.0, gap_ratio=0.0,
                        repeats=1),
        ],
        seconds=0.1,
    )
    assert rep.dispatch_gap_ratio == 0.01  # not (1.0 + 0.0) / 2
    assert rep.device_time_ms == 99.0
    d = rep.to_dict()
    assert d["dispatch_gap_ratio"] == 0.01
    assert [e["name"] for e in d["entries"]] == ["tiny", "big"]
    assert "aggregate gap ratio 0.010" in rep.render_text()


class _FakeCard:
    """A card stand-in for the timing path: CUDA events that advance a clock
    by `span_ms` per record pair, a profiler capture that records no kernel
    (the missed capture of a few-us entry)."""

    type = "cuda"

    def __init__(self, monkeypatch, span_ms, profiler_ms=0.0):
        import contextlib
        import itertools

        clock = itertools.count()

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = 0.0

            def record(self, stream=None):
                self.t = next(clock) * span_ms

            def elapsed_time(self, end):
                return end.t - self.t

        monkeypatch.setattr(profiling, "resolve_device", lambda device: self)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: None)
        monkeypatch.setattr(profiling, "_capture", lambda torch: contextlib.nullcontext())
        monkeypatch.setattr(profiling, "_kernel_ms", lambda prof: profiler_ms)


def test_missed_capture_reports_the_events_not_zero(monkeypatch):
    """A capture holding no kernel while the CUDA events show time: the
    entry's device time is the events' span, marked as such, never 0, and
    osim_device_time_seconds is never set to 0."""
    _FakeCard(monkeypatch, span_ms=0.25)
    rep = analyze_dispatch_gaps(captures=_caps(), repeats=2, device="cuda")
    for e in rep.entries:
        assert e.device_ms == pytest.approx(0.25) and e.events_ms == pytest.approx(0.25)
        assert e.device_source == "events"
        assert e.to_dict()["device_source"] == "events"
        assert metrics.DEVICE_TIME.value(entry=e.name) == pytest.approx(0.25e-3)
    assert "(events)" in rep.render_text()


def test_a_capture_with_kernels_keeps_the_profiler_reading(monkeypatch):
    _FakeCard(monkeypatch, span_ms=0.25, profiler_ms=0.3)
    rep = analyze_dispatch_gaps(captures=_caps()[:1], repeats=3, device="cuda")
    (e,) = rep.entries
    assert e.device_source == "profiler" and e.device_ms == pytest.approx(0.1)
    assert e.events_ms == pytest.approx(0.25)


def test_device_reading():
    assert profiling.device_reading(0.0, 0.25, True) == (0.25, "events")
    assert profiling.device_reading(0.1, 0.25, True) == (0.1, "profiler")
    assert profiling.device_reading(0.0, 0.0, True) == (0.0, "profiler")
    assert profiling.device_reading(0.0, 0.0, False) == (0.0, "none")


def test_fresh_args_recopies_donated_argnums():
    def fn(a, b):
        return a.add_(b)

    fn.__osim_donate_argnums__ = (0,)
    a, b = torch.ones(8), torch.ones(8)
    cap = _Cap("t:donate", fn, (a, b))
    fresh = profiling._fresh_args(cap)
    assert fresh[0] is not a        # written in place: copied
    assert fresh[1] is b            # only read: passed through
    assert torch.equal(fresh[0], a)
    analyze_dispatch_gaps(captures=[cap], repeats=3, device="cpu")
    assert torch.equal(a, torch.ones(8))  # the stored argument stayed as captured
    cap2 = _Cap("t:plain", lambda x: x, (a,))
    assert profiling._fresh_args(cap2) is cap2.args


def test_capture_device_trace_writes_into_out_dir(tmp_path):
    out = tmp_path / "devtrace"
    rep = capture_device_trace(str(out), fn=lambda: torch.sum(torch.ones(32)), device="cpu")
    assert rep["ok"] is True, rep
    assert rep["trace_dir"] == str(out)
    assert rep["seconds"] >= 0
    assert out.is_dir()
    events = json.loads((out / profiling.TRACE_NAME).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)


def test_capture_device_trace_failure_degrades_not_raises(tmp_path):
    def boom():
        raise RuntimeError("profiled workload exploded")

    rep = capture_device_trace(str(tmp_path / "t2"), fn=boom, device="cpu")
    assert rep["ok"] is False
    assert "profiled workload exploded" in rep["error"]


def test_cli_profile_gaps_json(monkeypatch, capsys):
    orig = profiling.analyze_dispatch_gaps
    monkeypatch.setattr(
        profiling, "analyze_dispatch_gaps",
        lambda names=None, repeats=2, captures=None, device="cpu": orig(
            captures=_caps(), repeats=repeats, device=device,
        ),
    )
    rc = cli.main(["profile", "--format", "json", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{"):])
    assert "trace" not in doc  # no command given -> analyzer only
    entries = doc["dispatch_gaps"]["entries"]
    assert [e["name"] for e in entries] == ["t:add", "t:sum"]
    assert all(e["repeats"] == 3 for e in entries)


def test_cli_profile_command_writes_trace(tmp_path, capsys):
    """`profile -- apply -f example/simon-config.yaml`: the command's exit
    code, and a Chrome trace of its operators in --out."""
    out = tmp_path / "prof"
    rc = cli.main(["profile", "--out", str(out), "--device", "cpu", "--format", "json", "--",
                   "apply", "-f", "example/simon-config.yaml", "--device", "cpu",
                   "--output-file", str(tmp_path / "report.txt")])
    assert rc == 0
    text = capsys.readouterr().out
    doc = json.loads(text[text.rindex('{\n  "trace"'):])
    assert doc["trace"]["ok"] and "dispatch_gaps" not in doc
    events = json.loads((out / profiling.TRACE_NAME).read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_cli_profile_unknown_entry_exits_1(capsys):
    rc = cli.main(["profile", "--entries", "ops.fast:no_such_entry", "--device", "cpu"])
    assert rc == 1
    assert "unknown audit entry" in capsys.readouterr().err


@pytest.fixture(autouse=True, scope="module")
def _untraced_allocations():
    """Pause tracemalloc for this file: an earlier file in the same worker
    may have left it tracing (a heap-profile test does), which slows
    Python-heavy tests tens of times."""
    import tracemalloc

    tracing = tracemalloc.is_tracing()
    tracemalloc.stop()
    yield
    if tracing:
        tracemalloc.start()
