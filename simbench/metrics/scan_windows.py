"""The light scan's windows in the profiled call: its `select.scan` spans
on the device clock, and the device work that falls inside them. The
arithmetic of the scan readers; a kernel is charged to the window that
holds its start, as tools/route_profile.py charges kernels to routes."""

from __future__ import annotations

from typing import List, Tuple

from .gaps import busy

SPAN = "select.scan"


def windows(p) -> List[Tuple[int, int]]:
    """[(start, end)] in ns of the profile's `select.scan` spans, sorted;
    empty without a profile or without such a span."""
    if p is None:
        return []
    return sorted((s, e) for name, s, e, _ in p.spans if name == SPAN)


def kernels_in(p, wins) -> int:
    """CUDA kernels of the capture (copies and sets left out) whose start
    lies in one of `wins`."""
    return sum(1 for name, s, _ in p.events
               if not name.startswith(("Memcpy", "Memset"))
               and any(lo <= s < hi for lo, hi in wins))


def busy_in(p, wins) -> int:
    """Time in ns inside `wins` in which some device operation runs: the
    union of the capture's events clipped to each window, summed."""
    return sum(busy(((s, s + d) for _, s, d in p.events), lo, hi) for lo, hi in wins)
