"""What a `--trace 1` run reads: the window calls' spans, and one whole
call under torch.profiler.

The profiler records CUDA activity only (kernels, copies, sets, through
CUPTI); the CPU operator events would cost more than the call itself on
the launch-bound light scan. Its clock is tied to the host's by a marker:
after a synchronise, one tiny fill is launched right after reading the
host clock, and its start in the capture gives the offset. The port's spans
of the profiled call (host wall time) then land on the device timeline, and
every idle stretch of the device is charged to the innermost span open at
its middle.

While profiling, each launch of the domain_pop kernel is seen through a
wrapper around `ops.domain_pop.domain_pop`: it notes the shapes of the
launch's arguments, and after the call (no synchronise inside the window)
how many pods the launch placed, which is what `metrics/pop_count.py`
counts bytes and operations from.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from . import program
from .metrics import gaps
from .metrics.pop_count import Launch

TOP = 10


@dataclass
class CallSpans:
    pods: int
    simulate_s: float
    schedule_s: float


@dataclass
class Profile:
    lo: int                      # profiled window on the device clock, ns
    hi: int
    pods: int
    events: List[Tuple[str, int, int]] = field(default_factory=list)  # (name, start ns, ns)
    launches: List[Launch] = field(default_factory=list)
    spans: List[Tuple[str, int, int, int]] = field(default_factory=list)  # (name, start, end, depth)


@dataclass
class Readings:
    calls: List[CallSpans] = field(default_factory=list)
    profile: Optional[Profile] = None


def call_spans(root: dict, pods: int) -> CallSpans:
    """The `simulate` root span of one call, and its `schedule` spans."""
    sched = 0.0
    stack = list(root.get("children", []))
    while stack:
        s = stack.pop()
        if s["name"] == "schedule":
            sched += s["duration_s"]
        else:
            stack.extend(s.get("children", []))
    return CallSpans(pods=pods, simulate_s=root["duration_s"], schedule_s=sched)


def _flatten(root: dict, offset_ns: int, depth: int = 0, out=None):
    out = [] if out is None else out
    start = int(round(root["start"] * 1e9)) + offset_ns
    out.append((root["name"], start, start + int(root["duration_s"] * 1e9), depth))
    for c in root.get("children", []):
        _flatten(c, offset_ns, depth + 1, out)
    return out


class _PopRecorder:
    """Wraps ops.domain_pop.domain_pop for the profiled call."""

    def __init__(self):
        self.mod = program.port("ops.domain_pop")
        self.inner = self.mod.domain_pop
        self.seen = []

    def __enter__(self):
        def wrapped(*args, **kw):
            out = self.inner(*args, **kw)
            self.seen.append((args, out))
            return out

        self.mod.domain_pop = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.domain_pop = self.inner

    def launches(self) -> List[Launch]:
        out = []
        for args, (nodes, _) in self.seen:
            tensors = [a for a in args if hasattr(a, "element_size")]
            hscore, base_dom, hard = tensors[0], tensors[6], tensors[11]
            fo_spread, group_size, any_hard = args[-5], args[-3], args[-2]
            n_hard = int((hard > 0).sum()) if any_hard and fo_spread else 0
            out.append(Launch(
                tensors=[(t.element_size(), t.numel()) for t in tensors],
                dc=int(hscore.shape[0]), d=int(base_dom.shape[1]), g=int(group_size),
                n_hard=n_hard, placed=int((nodes >= 0).sum()),
            ))
        return out


def profiled_call(torch, dev, fn: Callable[[], int]) -> Profile:
    """Run fn() (one whole call; returns the pods it decided) under the
    profiler and return what the capture holds."""
    cuda = torch.autograd.DeviceType.CUDA
    marker = torch.empty(1, device=dev)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with _PopRecorder() as pops:
            host0 = time.time_ns()
            marker.fill_(1.0)
            lo_host = time.time_ns()
            pods = fn()
            torch.cuda.synchronize(dev)
            hi_host = time.time_ns()
    events = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
              for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    events.sort(key=lambda e: e[1])
    offset = events[0][1] - host0 if events else 0
    lo, hi = lo_host + offset, hi_host + offset
    root = program.recent_roots()[-1]
    return Profile(
        lo=lo, hi=hi, pods=pods,
        events=[e for e in events[1:] if e[1] < hi and e[1] + e[2] > lo],
        launches=pops.launches(),
        spans=_flatten(root, offset),
    )


def breakdown(p: Profile) -> dict:
    """The device operations that took most time, and the device's idle
    time charged to the span open at the middle of each gap."""
    by_op = defaultdict(int)
    for name, _, d in p.events:
        by_op[name[:160]] += d
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    by_span = defaultdict(int)
    for s, e in gaps.idle(((a, a + d) for _, a, d in p.events), p.lo, p.hi):
        mid = (s + e) // 2
        inner = [sp for sp in p.spans if sp[1] <= mid < sp[2]]
        name = max(inner, key=lambda sp: sp[3])[0] if inner else "outside spans"
        by_span[f"idle in {name}"] += e - s
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}
