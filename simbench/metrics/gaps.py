"""Device busy and idle time from a profiler capture.

Copied from open_simulator_tpu_torch/utils/profiling.py (the dispatch-gap
analyzer): a capture's device time is read from its raw events
(`prof.profiler.kineto_results.events()`, those whose device type is CUDA:
kernels, copies and sets), and the gap is the share of the wall the device
did not account for (there dispatch = total - device, gap = dispatch /
total). Here the device time is the union of the events' intervals inside
the profiled window, so overlapping work on several streams counts once,
and the idle intervals between them are kept to be charged to the host's
spans.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def union(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The disjoint union of [start, end) intervals clipped to [lo, hi),
    sorted."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Time inside [lo, hi) in which some interval is open."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def idle(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The gaps of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in union(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if at < hi:
        out.append((at, hi))
    return out
